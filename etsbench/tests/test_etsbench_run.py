"""The harness end to end at tiny sizes on the CPU: the result line, the
KV count, and what a run may not load."""
import json
import subprocess
import sys

import pytest

from . import _tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", [_tiny.DENSE, _tiny.MOE])
def test_rehearsal_prints_the_result_keys(root, cell):
    res = _tiny.run(root, cell)
    assert list(res) == KEYS
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"search_tok_s", "step_gap_p90_s",
                                   "kv_mib_per_problem", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_rehearsal_reads_the_span_and_counter_metrics(root):
    res = _tiny.run(root, _tiny.DENSE, trace=1)
    names = set(res["metrics"])
    # the device-trace readers find nothing on the CPU and stay silent
    assert {"core.host_share", "core.select_ms", "prm.share",
            "prm.pad_share", "decode.iter_ms", "decode.rows_per_iter",
            "kv.sharing_ratio", "model.mfu"} <= names
    assert not names & {"tree_attention_roofline", "flash_prefill_roofline",
                        "device.idle_share"}
    assert res["metrics"]["decode.rows_per_iter"]["value"] <= 8
    assert 0 < res["metrics"]["core.host_share"]["value"] < 1


def test_kv_count_is_the_pages_the_allocator_holds(root, monkeypatch):
    """Each KV sample is the allocator's count, taken after the step's
    pruning: the pages of the retained leaves' sequences, no more."""
    from etsbench import harness
    from repro_torch.serving.search_backend import LMBackend
    seen, live_seqs = [], {}
    on_step, pages = LMBackend.on_step, LMBackend.problem_pages

    def on_step_(self, tree, live):
        on_step(self, tree, live)
        live_seqs[tree.node(0).payload["ns"]] = [
            tree.node(n).payload["seq_id"] for n in live]

    def pages_(self, tree):
        n = pages(self, tree)
        if sys._getframe(1).f_code.co_name != "_on_step":
            return n                 # the serving loop's own reads
        alloc = self.engine.alloc
        kept = set()
        for sid in live_seqs[tree.node(0).payload["ns"]]:
            kept.update(alloc.seqs[sid].block_table)
        seen.append((n, len(kept)))
        return n
    monkeypatch.setattr(LMBackend, "on_step", on_step_)
    monkeypatch.setattr(LMBackend, "problem_pages", pages_)
    res = _tiny.run(root, _tiny.DENSE)
    assert seen and all(a == b > 0 for a, b in seen), seen
    assert not hasattr(harness.Probe, "held_pages")
    assert res["metrics"]["kv_mib_per_problem"]["value"] > 0


def _script(root, code):
    return subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)


def test_no_module_of_another_stack_is_loaded(root):
    code = (
        "import sys, time; sys.path[:0] = ['.', %r]\n"
        "from etsbench import harness\n"
        "from pathlib import Path\n"
        "harness.run(['--workload', %r, '--seed', '5', '--seconds', '1',"
        " '--trace', '0'], root=Path('.'), t_start=time.perf_counter(),"
        " device='cpu', log=lambda s: None)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(_tiny.REPO / "src"), _tiny.MOE)
    p = _script(root, code)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_run_py_prints_no_result_without_a_card(root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would measure it")
    p = subprocess.run([sys.executable, "etsbench/run.py", "--workload",
                        _tiny.DENSE, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_py_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    root = _tiny.make_root(tmp_path)
    p = subprocess.run([sys.executable, "-S", "etsbench/run.py",
                        "--workload", _tiny.DENSE, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=root,
                       capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_result_line_is_last_and_json(root, capsys):
    from etsbench import harness
    res = _tiny.run(root, _tiny.DENSE)
    json.dumps(res)
    assert list(res)[-1] == "checks"
    assert harness.BANNED == ("jax", "jaxlib", "flax", "repro")
