"""The port's attention kernels.

On the CPU: each plain version (the wrappers' CPU path) against the
reference Pallas kernel in interpret mode, run as
``tests/test_kernels.py`` runs it and held to its tolerances (paged 2e-5
float32 / 2e-2 bfloat16, tree 3e-5, prefill 2e-5), on the same inputs
made with numpy from a seed.

The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import flash_prefill as jax_flash
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.tree_attention import tree_attention as jax_tree

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (NEG_INF, flash_prefill_ref,
                                     paged_attention_ref, tree_attention_ref,
                                     tree_attention_split_ref)
from repro_torch.kvcache import build_tree_metadata

RNG = np.random.default_rng(11)
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rand(shape, dtype="float32"):
    x = RNG.normal(size=shape).astype(np.float32)
    jd, td = DT[dtype]
    return jnp.asarray(x, jd), torch.as_tensor(x).to(td)


def _ints(a):
    return jnp.asarray(a), torch.as_tensor(a)


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

PAGED_CASES = [
    # B, H, K, hd, page_size, P, T
    (2, 4, 2, 32, 8, 16, 4),
    (3, 8, 8, 64, 16, 32, 5),
    (4, 8, 4, 64, 32, 16, 2),
]


def _paged_inputs(B, H, K, hd, S, P, T, dtype, zero_row=False):
    (jk, tk), (jv, tv) = _rand((P, S, K, hd), dtype), _rand((P, S, K, hd),
                                                          dtype)
    jq, tq = _rand((B, H, hd), dtype)
    bt = np.full((B, T), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B - int(zero_row)):
        n = int(RNG.integers(1, T + 1))
        bt[b, :n] = RNG.choice(P, n, replace=False)
        lens[b] = int(RNG.integers(1, n * S + 1))
    (jbt, tbt), (jl, tl) = _ints(bt), _ints(lens)
    return (jq, jk, jv, jbt, jl), (tq, tk, tv, tbt, tl)


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_pallas(case, dtype):
    B, H, K, hd, S, P, T = case
    ja, ta = _paged_inputs(B, H, K, hd, S, P, T, dtype, zero_row=True)
    out = jax_paged(*ja, scale=hd ** -0.5, interpret=True)
    ref = paged_attention_ref(*ta, scale=hd ** -0.5)
    assert ref.dtype == ta[0].dtype
    _close(out, ref, 2e-5 if dtype == "float32" else 2e-2)
    assert torch.all(ref[-1] == 0)      # the zero-length row


def test_paged_single_token_context():
    B, H, K, hd, S, P = 2, 4, 2, 32, 8, 8
    (jk, tk), (jv, tv), (jq, tq) = (_rand((P, S, K, hd)),
                                    _rand((P, S, K, hd)), _rand((B, H, hd)))
    (jbt, tbt) = _ints(np.asarray([[0, -1], [1, -1]], np.int32))
    (jl, tl) = _ints(np.asarray([1, 1], np.int32))
    out = jax_paged(jq, jk, jv, jbt, jl, scale=hd ** -0.5, interpret=True)
    _close(out, paged_attention_ref(tq, tk, tv, tbt, tl, scale=hd ** -0.5),
           1e-5)


# ---------------------------------------------------------------------------
# tree decode
# ---------------------------------------------------------------------------

TREE_CASES = [
    (4, 4, 2, 32, 8, 16, 5),
    (8, 8, 4, 64, 16, 32, 7),
]


def _tree_inputs(B, H, K, hd, S, P, N):
    (jk, tk), (jv, tv), (jq, tq) = (_rand((P, S, K, hd)),
                                    _rand((P, S, K, hd)), _rand((B, H, hd)))
    pl = RNG.choice(P, N, replace=False).astype(np.int32)
    mask = np.zeros((N, B), np.int8)
    mask[0] = 1                        # shared root page
    for b in range(B):
        for n in range(1, N):
            mask[n, b] = RNG.random() < 0.5
    lens = RNG.integers(1, S + 1, N).astype(np.int32)
    ints = [_ints(a) for a in (pl, mask, lens)]
    return ((jq, jk, jv) + tuple(j for j, _ in ints),
            (tq, tk, tv) + tuple(t for _, t in ints))


@pytest.mark.parametrize("case", TREE_CASES)
def test_tree_plain_matches_pallas(case):
    B, H, K, hd, S, P, N = case
    ja, ta = _tree_inputs(B, H, K, hd, S, P, N)
    out = jax_tree(*ja, scale=hd ** -0.5, interpret=True)
    _close(out, tree_attention_ref(*ta, scale=hd ** -0.5), 3e-5)


def test_tree_padded_metadata_inert():
    """Zero-length dump entries and fully masked rows contribute
    nothing; inactive rows come out exactly zero."""
    P, S, K, H, hd, B = 16, 8, 2, 4, 32, 6
    (jk, tk), (jv, tv), (jq, tq) = (_rand((P, S, K, hd)),
                                    _rand((P, S, K, hd)), _rand((B, H, hd)))
    meta = build_tree_metadata([[3, 4], [3, 5], [3, 6, 7], [], [], []],
                               [14, 12, 19, 0, 0, 0], S, pad_page=P - 1,
                               check=True)
    assert meta.page_list.shape[0] == 8 and meta.n_unique == 5
    ints = [_ints(a) for a in (meta.page_list, meta.page_mask,
                               meta.page_lens)]
    out = jax_tree(jq, jk, jv, *(j for j, _ in ints), scale=hd ** -0.5,
                   interpret=True)
    ref = tree_attention_ref(tq, tk, tv, *(t for _, t in ints),
                             scale=hd ** -0.5)
    _close(out, ref, 3e-5)
    assert torch.all(ref[3:] == 0)


def test_tree_fully_masked_tile_is_inert():
    B, H, K, hd, S, P, N = 8, 4, 2, 32, 8, 8, 4
    ja, ta = _tree_inputs(B, H, K, hd, S, P, N)
    mask = np.zeros((N, B), np.int8)
    mask[:, :4] = 1
    jm, tm = _ints(mask)
    ja = ja[:4] + (jm,) + ja[5:]
    ta = ta[:4] + (tm,) + ta[5:]
    out = jax_tree(*ja, scale=hd ** -0.5, interpret=True, block_b=4)
    ref = tree_attention_ref(*ta, scale=hd ** -0.5)
    assert torch.isfinite(ref).all() and torch.all(ref[4:] == 0)
    _close(out, ref, 3e-5)


@pytest.mark.parametrize("case", TREE_CASES)
@pytest.mark.parametrize("pps", [1, 2, 3, "N", "N+3"])
def test_tree_split_matches_pallas(case, pps):
    """The split + combine decomposition of the CUDA tree kernel, at
    every run length from one page per split to more than N."""
    B, H, K, hd, S, P, N = case
    pps = {"N": N, "N+3": N + 3}.get(pps, pps)
    ja, ta = _tree_inputs(B, H, K, hd, S, P, N)
    out = jax_tree(*ja, scale=hd ** -0.5, interpret=True)
    split = tree_attention_split_ref(*ta, scale=hd ** -0.5,
                                     pages_per_split=pps)
    _close(out, split, 3e-5)


@pytest.mark.parametrize("pps", [1, 2, 8, 11])
def test_tree_split_dump_splits_and_masked_rows(pps):
    """Padded metadata: with 2 pages per split, split 3 holds only dump
    entries; leaf 0 (entries 0, 1) has no page in splits 1-3; rows 3-5
    are fully masked and come out exactly zero."""
    P, S, K, H, hd, B = 16, 8, 2, 4, 32, 6
    (jk, tk), (jv, tv), (jq, tq) = (_rand((P, S, K, hd)),
                                    _rand((P, S, K, hd)), _rand((B, H, hd)))
    meta = build_tree_metadata([[3, 4], [3, 5], [3, 6, 7], [], [], []],
                               [14, 12, 19, 0, 0, 0], S, pad_page=P - 1,
                               check=True)
    assert meta.page_list.shape[0] == 8 and list(meta.page_lens[5:]) == [0] * 3
    ints = [_ints(a) for a in (meta.page_list, meta.page_mask,
                               meta.page_lens)]
    out = jax_tree(jq, jk, jv, *(j for j, _ in ints), scale=hd ** -0.5,
                   interpret=True)
    split = tree_attention_split_ref(tq, tk, tv, *(t for _, t in ints),
                                     scale=hd ** -0.5, pages_per_split=pps)
    _close(out, split, 3e-5)
    assert torch.all(split[3:] == 0)


def test_tree_split_rejects_empty_runs():
    _, ta = _tree_inputs(4, 4, 2, 32, 8, 16, 5)
    with pytest.raises(ValueError, match="pages_per_split"):
        tree_attention_split_ref(*ta, scale=0.2, pages_per_split=0)


def test_tree_equals_paged_for_disjoint_paths():
    """With no sharing, tree attention == per-sequence paged attention
    (both plain versions, against the reference paged kernel)."""
    B, H, K, hd, S, P = 3, 4, 2, 32, 8, 6
    (jk, tk), (jv, tv), (jq, tq) = (_rand((P, S, K, hd)),
                                    _rand((P, S, K, hd)), _rand((B, H, hd)))
    mask = np.zeros((6, B), np.int8)
    for b in range(B):
        mask[2 * b, b] = mask[2 * b + 1, b] = 1
    out_tree = tree_attention_ref(
        tq, tk, tv, torch.arange(6, dtype=torch.int32),
        torch.as_tensor(mask), torch.full((6,), S, dtype=torch.int32),
        scale=hd ** -0.5)
    bt = np.asarray([[0, 1], [2, 3], [4, 5]], np.int32)
    lens = np.full((B,), 2 * S, np.int32)
    (jbt, tbt), (jl, tl) = _ints(bt), _ints(lens)
    out_paged = paged_attention_ref(tq, tk, tv, tbt, tl, scale=hd ** -0.5)
    torch.testing.assert_close(out_tree, out_paged, rtol=2e-5, atol=2e-5)
    _close(jax_paged(jq, jk, jv, jbt, jl, scale=hd ** -0.5, interpret=True),
           out_tree, 2e-5)


# ---------------------------------------------------------------------------
# flash prefill
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, S, H, K, hd, causal, window, bq, bk
    (2, 128, 4, 2, 32, True, 0, 64, 64),
    (1, 256, 8, 4, 64, True, 64, 64, 64),
    (2, 64, 4, 4, 32, False, 0, 32, 32),
    (2, 8, 4, 2, 32, True, 0, 128, 128),      # bucket below the block
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas(case):
    B, S, H, K, hd, causal, window, bq, bk = case
    (jq, tq), (jk, tk), (jv, tv) = (_rand((B, S, H, hd)),
                                    _rand((B, S, K, hd)),
                                    _rand((B, S, K, hd)))
    out = jax_flash(jq, jk, jv, scale=hd ** -0.5, causal=causal,
                    window=window, block_q=bq, block_k=bk, interpret=True)
    ref = flash_prefill_ref(tq, tk, tv, scale=hd ** -0.5, causal=causal,
                            window=window)
    _close(out, ref, 2e-5)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest,
    ties away from zero, on the low 13 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = ((bits + 0x1000) & ~0x1FFF) & 0xFFFFFFFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _tc_matmul(a, b, passes):
    """A tensor-core product of float32 operands: TF32 inputs, exact
    products, fp32 result; ``passes`` 3 is the 3xTF32 split
    big.big + big.small + small.big, 1 a single TF32 pass."""
    ab, bb = _tf32(a), _tf32(b)
    out = ab.double() @ bb.double()
    if passes == 3:
        a_s, b_s = _tf32(a - ab), _tf32(b - bb)
        out = out + ab.double() @ b_s.double() + a_s.double() @ bb.double()
    return out.float()


def _flash_tensor_core(q, k, v, scale, passes):
    """Causal attention with both products as the fp32 CUDA kernel runs
    them on the tensor cores.  q (B,S,H,hd), k/v (B,S,K,hd)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qh = q.permute(0, 2, 1, 3)                               # (B,H,S,hd)
    kh = k.repeat_interleave(G, dim=2).permute(0, 2, 3, 1)   # (B,H,hd,S)
    vh = v.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)   # (B,H,S,hd)
    s = _tc_matmul(qh, kh, passes) * scale
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(causal, s, torch.tensor(NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(causal, torch.exp(s - m), 0.0)
    o = _tc_matmul(p, vh, passes) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -11), 3.0], dtype=torch.float32)
    want = [1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -9), 3.0]
    assert _tf32(x).tolist() == want


@pytest.mark.parametrize("passes,within", [(3, True), (1, False)])
def test_flash_tf32_passes_against_pallas(passes, within):
    """At hd 64, flash prefill with 3xTF32 products stays inside the
    reference's 2e-5 fp32 tolerance; one TF32 pass does not."""
    B, S, H, K, hd = 1, 128, 8, 4, 64
    (jq, tq), (jk, tk), (jv, tv) = (_rand((B, S, H, hd)),
                                    _rand((B, S, K, hd)),
                                    _rand((B, S, K, hd)))
    want = np.asarray(jax_flash(jq, jk, jv, scale=hd ** -0.5, causal=True,
                                block_q=64, block_k=64, interpret=True),
                      np.float32)
    got = _flash_tensor_core(tq, tk, tv, hd ** -0.5, passes).numpy()
    err = float(np.abs(got - want).max())
    assert (err <= 2e-5) == within, err


# ---------------------------------------------------------------------------
# the dispatch seam
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_version_on_cpu():
    """CPU tensors go to the plain version: same values, no launch."""
    ops.reset_launch_counts()
    _, ta = _paged_inputs(3, 4, 2, 32, 8, 16, 3, "float32")
    torch.testing.assert_close(ops.paged_attention(*ta, scale=0.2),
                               paged_attention_ref(*ta, scale=0.2))
    _, tt = _tree_inputs(4, 4, 2, 32, 8, 16, 5)
    torch.testing.assert_close(ops.tree_attention(*tt, scale=0.2),
                               tree_attention_ref(*tt, scale=0.2))
    _, q = _rand((1, 16, 4, 32))
    _, k = _rand((1, 16, 2, 32))
    torch.testing.assert_close(ops.flash_prefill(q, k, k, scale=0.2),
                               flash_prefill_ref(q, k, k, scale=0.2))
    assert [k.launches for k in ops.KERNELS] == [0, 0, 0]


def test_kernel_sources_name_the_pallas_kernel_they_replace():
    from repro_torch.kernels import build
    for k in ops.KERNELS:
        src = (build.CSRC / f"{k.name}.cu").read_text()
        pallas = k.replaces.split(":")[0]
        assert pallas.replace("src/", "") in src or pallas in src, k.name
        assert "Bound on the H100" in src
