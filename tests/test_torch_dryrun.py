"""The port's dry run (``repro_torch.launch.dryrun``), roofline and report
on the CPU.

  * tiny configs on fake (2,2) and (2,2,2) meshes, in a process of their
    own (the dry run owns its default process group): every record is
    ``ok`` with the reference's keys and none of its TPU fields;
  * the per-device FLOPs times the world size equal the unsharded
    step's (a 1x1 mesh) within 5%, for a train and a prefill step;
  * the expert-parallel MoE (``--opt``) runs its all-to-alls;
  * the skip policy, and a failed combo's record naming its operator;
  * ``analysis.report``'s tables equal the reference's on the same
    records, apart from the TPU-projection column and the MXU note;
  * the launchers' ``--dry-run`` run ``lower_combo``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import report as jreport

from repro_torch.analysis import report
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_bytes_est"}
ROOF_KEYS = {"arch", "shape", "mesh", "chips", "flops", "bytes_hbm",
             "bytes_collective", "raw_cost_flops", "raw_cost_bytes",
             "mem_argument_bytes", "mem_temp_bytes", "mem_output_bytes",
             "model_flops", "compute_s", "memory_s", "collective_s",
             "bottleneck", "useful_flops_ratio"}


def _run(args, timeout=300):
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    r = _run([str(ROOT / "tests" / "_torch_dryrun_worker.py"), str(out)])
    assert r.returncode == 0, r.stderr[-3000:]
    return {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}


def test_every_tiny_record_is_ok_with_the_reference_keys(records):
    assert len(records) == 8
    for tag, rec in records.items():
        assert rec["status"] == "ok", (tag, rec.get("error"))
        assert set(rec["memory"]) == MEMORY_KEYS
        assert set(rec["roofline"]) == ROOF_KEYS
        assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                                 "collective")
        assert rec["lower_s"] >= 0
        m = rec["memory"]
        assert m["peak_bytes_est"] >= m["argument_bytes"] > 0
        assert m["peak_bytes_est"] == (m["argument_bytes"]
                                       + m["temp_bytes"]
                                       + m["output_bytes"]
                                       - m["alias_bytes"])
    # train steps update params and moments in place: outputs alias
    train = records["llama3.2-1b__train_4k__2x2"]["memory"]
    assert train["alias_bytes"] > 0


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_per_device_flops_times_world_equal_the_unsharded(records, shape):
    one = records[f"llama3.2-1b__{shape}__1x1"]["roofline"]
    four = records[f"llama3.2-1b__{shape}__2x2"]["roofline"]
    assert one["bytes_collective"] == 0 and four["bytes_collective"] > 0
    assert four["flops"] * 4 == pytest.approx(one["flops"], rel=0.05)
    assert four["chips"] == 4 and one["chips"] == 1
    if shape == "prefill_32k":
        eight = records["llama3.2-1b__prefill_32k__2x2x2"]["roofline"]
        assert eight["flops"] * 8 == pytest.approx(one["flops"], rel=0.05)


def test_expert_parallel_dry_run(records):
    rec = records["deepseek-moe-16b__train_4k__2x2__opt"]
    assert rec["variant"] == "opt" and rec["n_collectives"] > 0
    assert rec["roofline"]["bytes_collective"] > 0


def test_skip_policy_needs_no_process_group():
    rec = dryrun.lower_combo("hubert-xlarge", "decode_32k", multi_pod=False)
    assert rec["status"] == "skip" and "encoder" in rec["reason"]
    rec = dryrun.lower_combo("llama3.2-1b", "long_500k", multi_pod=True)
    assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]
    assert dryrun.skip_reason(get_config("zamba2-7b"),
                              get_shape("long_500k")) is None


def test_failed_operator_is_named():
    err = RuntimeError("x\n\nSharding propagation failed for "
                       "aten.sort.stable(Spec(f32[8]))")
    assert dryrun._failed_op(err) == "aten.sort.stable"
    err = NotImplementedError("Operator aten.foo.default does not have a "
                              "sharding strategy registered.")
    assert dryrun._failed_op(err) == "aten.foo.default"


def _cells(table):
    return [[c.strip() for c in row.split("|")[1:-1]]
            for row in table.splitlines()]


def test_report_tables_equal_the_reference(records):
    recs = list(records.values()) + [
        {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "2x2",
         "status": "skip", "reason": "encoder-only arch has no decode step"},
        {"arch": "mixtral-8x7b", "shape": "train_4k", "mesh": "2x2",
         "status": "fail", "error": "RuntimeError: aten.sort"}]
    for mesh in ("2x2", "2x2x2"):
        ours = _cells(report.dryrun_table(recs, mesh))
        theirs = _cells(jreport.dryrun_table(recs, mesh))
        assert len(ours) == len(theirs) > 2
        for a, b in zip(ours, theirs):
            assert a[:4] + a[5:] == b[:4] + b[5:]       # all but TPU-proj
        ours = _cells(report.roofline_table(recs, mesh))
        theirs = _cells(jreport.roofline_table(recs, mesh))
        assert len(ours) == len(theirs) > 2
        for a, b in zip(ours, theirs):
            assert a[:-1] == b[:-1]                     # all but the note
    assert _cells(report.dryrun_table(recs, "2x2"))[0][4] == "of H100"


def test_report_cli_runs(records, tmp_path):
    for tag, rec in records.items():
        (tmp_path / f"{tag}.json").write_text(json.dumps(rec))
    r = _run(["-m", "repro_torch.analysis.report", "--dir", str(tmp_path)],
             timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Roofline" in r.stdout


def test_dryrun_cli_records_skips_and_trace_only(tmp_path):
    r = _run(["-m", "repro_torch.launch.dryrun", "--arch", "hubert-xlarge",
              "--shape", "decode_32k", "--both-meshes", "--no-compile",
              "--out", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    for tag in ("sp", "mp"):
        rec = json.loads((tmp_path / f"hubert-xlarge__decode_32k__{tag}"
                          ".json").read_text())
        assert rec["status"] == "skip"
    assert "done: ok=0 skip=2 fail=0" in r.stdout
