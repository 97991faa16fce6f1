"""Tiny cells for the benchmark's own CPU tests: a copy of the
benchmark's folder in a temporary root, with a tiny dense model (M-RoPE
sections like the VLM's), a tiny MoE and a tiny traffic mix added as
files, and a BENCHMARK.json that lists only them."""
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DENSE = "tiny-dense.tiny"
MOE = "tiny-moe.tiny"

_LM = {"arch_type": "vlm", "n_layers": 2, "d_model": 64, "n_heads": 4,
       "n_kv_heads": 2, "d_ff": 128, "vocab_size": 512,
       "rope_theta": 10000.0, "mrope_sections": [4, 2, 2],
       "norm_eps": 1e-6, "dtype": "bfloat16"}
_EMB = {"arch_type": "encoder", "n_layers": 1, "d_model": 32, "n_heads": 2,
        "n_kv_heads": 2, "d_ff": 64, "vocab_size": 512, "act": "gelu",
        "causal": False, "dtype": "float32"}
MIX = {"method": "ets", "width": 4, "max_steps": 2, "max_step_tokens": 8,
       "temperature": 1.0, "page_size": 8, "max_live": 2,
       "pool_pages": 128, "backlog": 64, "shared_header_tokens": 16,
       "problem_tokens": [8, 24],
       "ets": {"lambda_b": 1.0, "lambda_d": 1.0, "rebase_temperature": 0.2,
               "cluster_threshold": 0.3, "use_clustering": True,
               "solver": "milp"}}
LIMITS = {"lm_gap": 0.5, "prm_gap": 0.05, "embed_err": 1e-4,
          "ets_mismatch": 0}
# the MoE cell compares the steadier numbers, as the MoE cell on the card
MOE_LIMITS = {"lm_gap_p99": 0.4, "prm_mean_gap": 0.02, "embed_err": 1e-4,
              "ets_mismatch": 0}


def configs():
    dense = {"port": {"lm": dict(_LM),
                      "prm": dict(_LM, arch_type="dense", n_layers=1,
                                  mrope_sections=[]),
                      "embedder": dict(_EMB)},
             "serving": {"step_token": 10, "eos_token": 11}}
    moe = json.loads(json.dumps(dense))
    for k, cf in (("lm", 2.0), ("prm", 1.0)):
        moe["port"][k].update(arch_type="moe", mrope_sections=[], moe={
            "n_experts": 4, "n_shared_experts": 1, "top_k": 2,
            "d_expert": 32, "capacity_factor": cf})
    return {"tiny-dense": dense, "tiny-moe": moe}


def make_root(tmp: Path) -> Path:
    """A checkout-like root holding the benchmark's folder and the tiny
    cells."""
    root = Path(tmp)
    shutil.copytree(REPO / "etsbench", root / "etsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    base = root / "etsbench"
    bench["configs"], bench["workloads"] = [], []
    for name, cfg in configs().items():
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"etsbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        cell = f"{name}.tiny"
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "test"})
        (base / "limits" / f"{cell}.json").write_text(json.dumps(
            {"limits": MOE_LIMITS if name == "tiny-moe" else LIMITS}))
    (base / "traffic" / "tiny.json").write_text(json.dumps(MIX))
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, cell: str, seed: int = 2147483700, seconds: float = 2.0,
        trace: int = 0, **kw):
    import time
    from etsbench import harness
    return harness.run(["--workload", cell, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)], root=root,
                       t_start=time.perf_counter(), device="cpu",
                       log=lambda s: None, **kw)
