"""The control at a size a test run holds: the reference in a lower
precision, put in the served outputs' place, reads further off than the
served search on the numbers it is run for.  On the card the control
runs at each cell's own size (``tools/control.py``: fp8 products for
the bfloat16 models, TF32 for the float32 embedder) and its readings set
the limits' upper ends; the CPU has no TF32, so here the embedder's
control is bfloat16."""
import pytest

from . import _tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", [_tiny.DENSE, _tiny.MOE])
def test_control_reads_above_the_served_search(root, cell):
    res = _tiny.run(root, cell, control={"lm": "fp8", "prm": "fp8",
                                         "embedder": "bf16"})
    c = res["checks"]
    lm, prm = (("lm_gap", "prm_gap") if cell == _tiny.DENSE
               else ("lm_gap_p99", "prm_mean_gap"))
    assert c[prm]["control"] > c[prm]["value"]
    assert c["embed_err"]["control"] > c["embed_err"]["value"]
    assert c[lm]["control"] >= c[lm]["value"]
    assert any(c[k]["control"] > c[k]["limit"]
               for k in (lm, prm, "embed_err"))
