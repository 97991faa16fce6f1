"""The port imports without jax and without the reference package, and
its entry points never drop to the CPU on their own."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, tiny_variant
from repro_torch.models.model import build_model
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)

ROOT = Path(__file__).resolve().parents[1]
SUBMODULES = [
    "repro_torch", "repro_torch.bridge", "repro_torch.device",
    "repro_torch.configs", "repro_torch.core", "repro_torch.core.controllers",
    "repro_torch.core.ets", "repro_torch.core.ilp",
    "repro_torch.core.clustering", "repro_torch.core.rebase",
    "repro_torch.core.tree", "repro_torch.core.serving",
    "repro_torch.core.replica",
    "repro_torch.kvcache",
    "repro_torch.kvcache.allocator", "repro_torch.kvcache.pool",
    "repro_torch.kvcache.tree_meta", "repro_torch.kernels",
    "repro_torch.kernels.build", "repro_torch.kernels.ops",
    "repro_torch.kernels.ref", "repro_torch.models",
    "repro_torch.models.layers", "repro_torch.models.attention",
    "repro_torch.models.model", "repro_torch.models.mamba2",
    "repro_torch.models.rwkv6", "repro_torch.models.moe",
    "repro_torch.serving",
    "repro_torch.serving.engine", "repro_torch.serving.runtimes",
    "repro_torch.serving.sampler", "repro_torch.serving.search_backend",
    "repro_torch.core.synthetic", "repro_torch.core.costsim",
    "repro_torch.training", "repro_torch.training.task",
    "repro_torch.training.optimizer", "repro_torch.training.train",
    "repro_torch.training.checkpoint", "repro_torch.launch",
    "repro_torch.launch.train", "repro_torch.launch.serve",
    "repro_torch.launch.steps", "repro_torch.launch.mesh",
    "repro_torch.launch.sharding", "repro_torch.launch.dryrun",
    "repro_torch.analysis", "repro_torch.analysis.roofline",
    "repro_torch.analysis.report",
    "repro_torch.eval", "repro_torch.eval.harness", "repro_torch.tracing",
]
# files outside the package that import only the port
SCRIPTS = ["examples/torch_train_and_search.py"]


def test_port_imports_without_jax_or_reference():
    code = textwrap.dedent(f"""
        import builtins, importlib, sys
        real = builtins.__import__
        def guard(name, *a, **kw):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError("blocked: " + name)
            return real(name, *a, **kw)
        builtins.__import__ = guard
        for m in {SUBMODULES!r}:
            importlib.import_module(m)
        import importlib.util
        for i, path in enumerate({[str(ROOT / f) for f in SCRIPTS]!r}):
            spec = importlib.util.spec_from_file_location(f"script{{i}}",
                                                          path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("ok", len([m for m in sys.modules
                         if m.startswith("repro_torch")]))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py names neither jax nor the reference package."""
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            top = s.split()[1].split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), line


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = dataclasses.replace(get_config("tiny-lm"), n_layers=1, d_model=64,
                              n_heads=2, n_kv_heads=1, d_ff=64,
                              vocab_size=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    lm = build_model(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedEngine(lm, params, EngineConfig(n_pages=16, page_size=8,
                                             max_batch=2, max_seq_len=32))
    engine = PagedEngine(lm, params, EngineConfig(
        n_pages=16, page_size=8, max_batch=2, max_seq_len=32), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMBackend(engine, lm, params, lm, params,
                  BackendConfig(step_token=1, eos_token=2),
                  answer_fn=lambda t: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"embed": params["embed"].numpy()}, cfg)


def test_slice_boundaries_raise_not_implemented():
    """What the port leaves out raises instead of running wrong; what
    earlier slices added (streamed prefill, swap, the MoE family, the VLM
    and encoder frontends, replicas, the families' training loss) no
    longer raises, and an encoder is refused by the engine as in the
    reference."""
    from repro_torch.core import SearchConfig
    from repro_torch.core.serving import ReplicaServingLoop
    vlm = build_model(get_config("tiny-lm").__class__(
        name="vlm-x", arch_type="vlm", n_layers=1, d_model=32,
        n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=16,
        mrope_sections=(4, 2, 2), frontend_dim=8), device="cpu")
    vp = vlm.init(torch.Generator().manual_seed(0))
    assert vp["frontend_proj"].shape == (8, 32)
    logits, _ = vlm.forward(vp, {"embeds": torch.zeros((1, 3, 8)),
                                 "tokens": torch.zeros((1, 2),
                                                       dtype=torch.long)})
    assert logits.shape == (1, 5, 16)
    moe = build_model(tiny_variant(get_config("deepseek-moe-16b")),
                      device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    loss = moe.loss(moe.init(torch.Generator().manual_seed(0)),
                    {"tokens": toks, "labels": toks})
    assert torch.isfinite(loss)
    with pytest.raises(AssertionError, match="at least one backend"):
        ReplicaServingLoop([], SearchConfig(), [])
    enc = build_model(tiny_variant(get_config("hubert-xlarge")),
                      device="cpu")
    with pytest.raises(ValueError, match="no decode path"):
        PagedEngine(enc, enc.init(torch.Generator().manual_seed(0)),
                    EngineConfig(n_pages=16, page_size=8, max_batch=2,
                                 max_seq_len=32), device="cpu")
    with pytest.raises(ValueError, match="at least one pool page"):
        EngineConfig(page_size=8, prefill_chunk_tokens=4)
    cfg = dataclasses.replace(get_config("tiny-lm"), n_layers=1, d_model=64,
                              n_heads=2, n_kv_heads=1, d_ff=64,
                              vocab_size=32)
    lm = build_model(cfg, device="cpu")
    engine = PagedEngine(lm, lm.init(torch.Generator().manual_seed(0)),
                         EngineConfig(n_pages=16, page_size=8, max_batch=2,
                                      max_seq_len=32,
                                      prefill_chunk_tokens=8),
                         device="cpu")
    sid = engine.prefill(list(range(1, 20)))
    assert engine.n_prefill_calls == 3          # ceil(18 / 8) segments
    assert engine.swap_out([sid]) == 3
    assert engine.swap_in([sid]) == 3
    engine.alloc.check_invariants()
