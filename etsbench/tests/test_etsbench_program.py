"""The program's own spans and counters (``repro_torch.tracing``, read
by ``tools/program.py``) agree with the harness's probes on the tiny
cells, and the tool runs on a program without the tracer."""
import sys
from collections import Counter

import pytest

from etsbench.tools import program

from . import _tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", [_tiny.DENSE, _tiny.MOE])
def test_program_agrees_with_the_probe(root, cell):
    with program.capture() as got:
        res = _tiny.run(root, cell, trace=1, seconds=5.0)
    assert res["correct"] is True
    snap, probe = got["snapshot"], got["probe"]
    names = Counter(s.name for s in snap["spans"])
    assert names["decode"] > 0
    assert names["decode"] == probe.spans["decode"][1] \
        == snap["counters"]["decode.iters"]
    for name in ("prm", "select"):
        assert names[name] == probe.spans[name][1] > 0
    assert snap["counters"]["prm.slots"] == probe.prm_slots > 0
    assert snap["counters"]["prm.valid"] == probe.prm_valid > 0
    steps = [(s.end_ns - s.start_ns) * 1e-9 for s in snap["spans"]
             if s.name == "step"]
    assert len(steps) == len(probe.gaps) > 0
    assert max(abs(a - b) for a, b in zip(steps, probe.gaps)) < 1e-3
    got_r = program.readings(snap)
    assert 0 < got_r["step.decode_share"] < 1
    assert got_r["decode.host_ms"] > 0
    assert got_r["kv.cow_pages_per_step"] >= 0
    assert got_r["decode.idle_ms"] is None      # no card, no device trace
    assert (got_r["moe.prm_drop_share"] is None) == (cell == _tiny.DENSE)


def test_the_tool_runs_without_the_programs_tracer(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    with program.capture() as got:
        res = _tiny.run(root, _tiny.DENSE, trace=1)
    assert res["correct"] is True
    assert got["snapshot"] is None and got["probe"] is not None
    assert program.readings(got["snapshot"]) is None
    for read in (program.decode_host_ms, program.step_decode_share,
                 program.moe_prm_drop_share, program.cow_pages_per_step):
        assert read(None) is None
    assert program.decode_idle_ms(None, None) is None


def test_idle_goes_to_the_innermost_span():
    from repro_torch.tracing import Span
    spans = [Span(1, None, "tick", 0, 100, {}),
             Span(2, 1, "decode", 10, 60, {}),
             Span(3, 2, "decode.meta", 10, 30, {}),
             Span(4, 2, "decode.forward", 30, 60, {}),
             Span(5, 1, "prm", 70, 90, {}),
             Span(6, None, "step", 0, 200, {"ns": 0})]
    snap = {"spans": spans, "counters": {}, "dropped": 0}
    gaps = [(12, 14), (40, 50), (61, 63), (72, 74), (120, 130)]
    assert program.innermost(spans, [13, 45, 62, 73, 125]) == [
        "decode.meta", "decode.forward", "tick", "prm", "host"]
    idle = program.idle_by_span(snap, gaps)
    assert idle == pytest.approx({"decode.meta": 2e-9,
                                  "decode.forward": 10e-9, "tick": 2e-9,
                                  "prm": 2e-9, "host": 10e-9})
    assert program.decode_idle_ms(snap, idle) == pytest.approx(12e-6)


def test_idle_overlap_splits_a_gap_between_phases():
    from repro_torch.tracing import Span
    spans = [Span(1, None, "tick", 0, 100, {}),
             Span(2, 1, "decode", 10, 60, {}),
             Span(3, 2, "decode.meta", 10, 30, {}),
             Span(4, 2, "decode.forward", 30, 60, {})]
    snap = {"spans": spans, "counters": {}, "dropped": 0}
    got = program.idle_overlap(snap, [(5, 40), (95, 110)])
    assert got == pytest.approx({"tick": 10e-9, "decode.meta": 20e-9,
                                 "decode.forward": 10e-9, "host": 10e-9})
    assert program.phase_ms(snap) == pytest.approx(
        {"decode.meta": 20e-6, "decode.forward": 30e-6})
