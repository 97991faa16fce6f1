"""The port on a CUDA device (marked ``cuda``; each test skips without a
card, deciding inside its fixture).  Imports nothing of jax, so it runs
on machines that have only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each CUDA kernel against its plain version on the card (tolerances of
the reference's kernel tests), its launch counter, and a tiny engine on
the card against the same engine on the CPU (plain path).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_prefill_ref, paged_attention_ref,
                                     tree_attention_ref)
from repro_torch.kvcache import build_tree_metadata
from repro_torch.models.model import build_model, tree_map
from repro_torch.serving import EngineConfig, PagedEngine

RNG = np.random.default_rng(3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _rand(shape, dtype, dev):
    return torch.as_tensor(RNG.normal(size=shape), dtype=dtype, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel(cuda, dtype):
    B, H, K, hd, S, P, T = 6, 32, 8, 64, 16, 64, 6
    q, kp, vp = (_rand((B, H, hd), dtype, cuda),
                 _rand((P, S, K, hd), dtype, cuda),
                 _rand((P, S, K, hd), dtype, cuda))
    bt = np.full((B, T), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B - 1):                    # last row: zero length
        n = int(RNG.integers(1, T + 1))
        bt[b, :n] = RNG.choice(P, n, replace=False)
        lens[b] = int(RNG.integers(1, n * S + 1))
    args = (q, kp, vp, torch.as_tensor(bt, device=cuda),
            torch.as_tensor(lens, device=cuda))
    before = ops.PAGED.launches
    out = ops.paged_attention(*args, scale=0.125)
    assert ops.PAGED.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(),
                               paged_attention_ref(*args, scale=0.125).float(),
                               rtol=tol, atol=tol)
    assert torch.all(out[-1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [12, 48])
@pytest.mark.parametrize("pps", [1, None, "N"])
def test_tree_kernel(cuda, pps, B):
    """Shared prefixes, dump entries and fully masked rows; B = 48 puts
    more than 32 leaves (two mask words) in one CTA."""
    H, K, hd, S, P = 32, 8, 64, 16, 64
    q, kp, vp = (_rand((B, H, hd), torch.float32, cuda),
                 _rand((P, S, K, hd), torch.float32, cuda),
                 _rand((P, S, K, hd), torch.float32, cuda))
    n_act = 2 * B // 3
    tables = ([[3, 4, 9], [3, 4, 10], [3, 5], [3, 5, 11, 12]]
              * (n_act // 4) + [[]] * (B - n_act))
    lengths = [40, 35, 32, 60] * (n_act // 4) + [0] * (B - n_act)
    meta = build_tree_metadata(tables, lengths, S, pad_page=P - 1,
                               check=True)
    args = (q, kp, vp) + tuple(torch.as_tensor(a, device=cuda) for a in (
        meta.page_list, meta.page_mask, meta.page_lens))
    pps = meta.page_list.shape[0] if pps == "N" else pps
    want = tree_attention_ref(*args, scale=0.125)
    for n_live in (None, meta.n_unique):
        before = ops.TREE.launches
        out = ops.tree_attention(*args, scale=0.125, pages_per_split=pps,
                                 n_live=n_live)
        assert ops.TREE.launches == before + 1
        torch.testing.assert_close(out, want, rtol=3e-5, atol=3e-5)
        assert torch.all(out[n_act:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pps", [1, None])
def test_tree_kernel_leaf_chunks(cuda, pps, hd):
    """160 leaves: their state does not fit one CTA's shared memory, so
    the split pass cuts the batch into leaf chunks (grid z > 1).  Masked
    rows lie inside every chunk, and the last chunk ends in them."""
    B, H, K, S, P = 160, 32, 8, 16, 256
    q, kp, vp = (_rand((B, H, hd), torch.float32, cuda),
                 _rand((P, S, K, hd), torch.float32, cuda),
                 _rand((P, S, K, hd), torch.float32, cuda))
    masked = [b % 5 == 4 or b >= 150 for b in range(B)]
    tables = [[] if masked[b] else [2 * (b // 10), 2 * (b // 10) + 1, 40 + b]
              for b in range(B)]
    lengths = [0 if masked[b] else 2 * S + 1 + b % S for b in range(B)]
    meta = build_tree_metadata(tables, lengths, S, pad_page=P - 1,
                               check=True)
    args = (q, kp, vp) + tuple(torch.as_tensor(a, device=cuda) for a in (
        meta.page_list, meta.page_mask, meta.page_lens))
    out = ops.tree_attention(*args, scale=hd ** -0.5, pages_per_split=pps,
                             n_live=meta.n_unique)
    torch.testing.assert_close(
        out, tree_attention_ref(*args, scale=hd ** -0.5), rtol=3e-5,
        atol=3e-5)
    assert torch.all(out[torch.as_tensor(masked, device=cuda)] == 0)


@pytest.mark.cuda
def test_tree_kernel_repeats_bitwise(cuda):
    """The combine merges splits in a fixed order with no atomics."""
    B, H, K, hd, S, P = 8, 8, 2, 32, 8, 32
    q, kp, vp = (_rand((B, H, hd), torch.float32, cuda),
                 _rand((P, S, K, hd), torch.float32, cuda),
                 _rand((P, S, K, hd), torch.float32, cuda))
    meta = build_tree_metadata([[1, 2, 3 + b] for b in range(B)],
                               [20 + b for b in range(B)], S,
                               pad_page=P - 1, check=True)
    args = (q, kp, vp) + tuple(torch.as_tensor(a, device=cuda) for a in (
        meta.page_list, meta.page_mask, meta.page_lens))
    outs = [ops.tree_attention(*args, scale=0.2, pages_per_split=1)
            for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("S,window", [(8, 0), (256, 0), (128, 48)])
def test_flash_kernel(cuda, S, window, hd, dtype):
    q, k, v = (_rand((2, S, 32, hd), dtype, cuda),
               _rand((2, S, 8, hd), dtype, cuda),
               _rand((2, S, 8, hd), dtype, cuda))
    scale = hd ** -0.5
    before = ops.FLASH.launches
    out = ops.flash_prefill(q, k, v, scale=scale, window=window)
    assert ops.FLASH.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        out.float(),
        flash_prefill_ref(q, k, v, scale=scale, window=window).float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
def test_wrappers_reject_bad_operands(cuda):
    q = _rand((2, 32, 64), torch.float32, cuda)
    kp = _rand((8, 16, 8, 64), torch.float32, cuda)
    bt = torch.zeros((2, 3), dtype=torch.int64, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="block_tables"):
        ops.paged_attention(q, kp, kp, bt, lens, scale=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention(q, kp.transpose(1, 2).contiguous()
                            .transpose(1, 2), kp, bt.int(), lens, scale=0.1)
    with pytest.raises(ValueError, match="hd"):
        x = _rand((1, 8, 4, 48), torch.float32, cuda)
        ops.flash_prefill(x, x, x, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged", "tree"])
def test_engine_on_card_matches_cpu(cuda, mode):
    """A tiny engine on the card (kernels) against the same engine on
    the CPU (plain versions): same greedy tokens, close logits, and the
    kernels of the path launched."""
    cfg = dataclasses.replace(get_config("tiny-lm"), n_layers=2, d_model=128,
                              n_heads=4, n_kv_heads=2, head_dim=32,
                              vocab_size=64)
    lm_cpu = build_model(cfg, device="cpu")
    params = lm_cpu.init(torch.Generator().manual_seed(0))
    ecfg = EngineConfig(n_pages=64, page_size=8, max_batch=8,
                        max_seq_len=96, attention=mode, trace_logits=True)
    prompts = [list(map(int, RNG.integers(0, 64, n))) for n in (13, 6, 21)]
    outs = []
    ops.reset_launch_counts()
    for dev in ("cpu", cuda):
        lm = build_model(cfg, device=dev)
        e = PagedEngine(lm, tree_map(lambda a: a.to(dev), params), ecfg,
                        device=dev)
        sids = e.prefill_many(prompts)
        ids = e.branch(sids[0], 3) + e.branch(sids[2], 2)
        outs.append((e.decode(ids, 8, key=0, temperature=0.0),
                     e.logits_trace))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    kernel = ops.PAGED if mode == "paged" else ops.TREE
    assert kernel.launches > 0 and ops.FLASH.launches > 0
