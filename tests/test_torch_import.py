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
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serving import (BackendConfig, EngineConfig, LMBackend,
                                 PagedEngine)

ROOT = Path(__file__).resolve().parents[1]
SUBMODULES = [
    "repro_torch", "repro_torch.bridge", "repro_torch.device",
    "repro_torch.configs", "repro_torch.core", "repro_torch.core.controllers",
    "repro_torch.core.ets", "repro_torch.core.ilp",
    "repro_torch.core.clustering", "repro_torch.core.rebase",
    "repro_torch.core.tree", "repro_torch.kvcache",
    "repro_torch.kvcache.allocator", "repro_torch.kvcache.pool",
    "repro_torch.kvcache.tree_meta", "repro_torch.kernels",
    "repro_torch.kernels.build", "repro_torch.kernels.ops",
    "repro_torch.kernels.ref", "repro_torch.models",
    "repro_torch.models.layers", "repro_torch.models.attention",
    "repro_torch.models.model", "repro_torch.serving",
    "repro_torch.serving.engine", "repro_torch.serving.runtimes",
    "repro_torch.serving.sampler", "repro_torch.serving.search_backend",
]


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
    """What this slice leaves out raises instead of running wrong."""
    with pytest.raises(NotImplementedError, match="streamed prefill"):
        EngineConfig(page_size=8, prefill_chunk_tokens=16)
    with pytest.raises(NotImplementedError):
        build_model(get_config("tiny-lm").__class__(
            name="moe-x", arch_type="moe", n_layers=1, d_model=32,
            n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=16), device="cpu")
    cfg = dataclasses.replace(get_config("tiny-lm"), n_layers=1, d_model=64,
                              n_heads=2, n_kv_heads=1, d_ff=64,
                              vocab_size=32)
    lm = build_model(cfg, device="cpu")
    engine = PagedEngine(lm, lm.init(torch.Generator().manual_seed(0)),
                         EngineConfig(n_pages=16, page_size=8, max_batch=2,
                                      max_seq_len=32), device="cpu")
    with pytest.raises(NotImplementedError, match="swap"):
        engine.swap_out([0])
    with pytest.raises(NotImplementedError, match="swap"):
        engine.swap_in([0])
