"""The port on a CUDA device (marked ``cuda``; each test skips without a
card, deciding inside its fixture).  Imports nothing of jax, so it runs
on machines that have only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each CUDA kernel against its plain version on the card (tolerances of
the reference's kernel tests; the sampler's kernel bit for bit), its
launch counter, the sampler's known answers on the card, a tiny engine
on the card against the same engine on the CPU (plain path), the decode
forward replayed from CUDA graphs against the eager forward, and the
plain-PyTorch paths of the families' training (MoE dispatch and combine,
forward and backward) and of the contiguous cache, the card against the
CPU; a 1-device-mesh engine and the expert-parallel MoE layer on a
world-size-1 NCCL group.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, tiny_variant
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_prefill_f64, flash_prefill_ref,
                                     paged_attention_ref, tree_attention_ref)
from repro_torch.kvcache import build_tree_metadata
from repro_torch.models.model import build_model, tree_leaves, tree_map
from repro_torch.serving import EngineConfig, PagedEngine, sampler
from repro_torch.serving.engine import DecodeRunner

RNG = np.random.default_rng(3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _rand(shape, dtype, dev):
    return torch.as_tensor(RNG.normal(size=shape), dtype=dtype, device=dev)


def _live(n, dev):
    """The tree kernel's live count, a (1,) int32 tensor on ``dev``."""
    return torch.tensor([n], dtype=torch.int32, device=dev)


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


def _long_tables(S, P, T=150):
    """Block tables that span many splits: (pages, length) per row with
    -1 holes, a -1-only stretch, a shared prefix, rows ending mid-page
    and mid-split, zero-length and one-page rows."""
    rows = [(T, T * S - 5), (130, 130 * S - 9), (0, 0), (1, 7), (1, S),
            (37, 37 * S - 1), (129, 129 * S - 3), (64, 64 * S)]
    bt = np.full((len(rows), T), -1, np.int32)
    lens = np.zeros(len(rows), np.int32)
    for b, (n, length) in enumerate(rows):
        bt[b, :n] = RNG.choice(P, n, replace=False)
        lens[b] = length
    bt[6, :100] = bt[0, :100]
    bt[1, 3:130:7] = -1
    bt[7, 8:16] = -1
    return bt, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pps", [1, None, 1000])
def test_paged_kernel_splits(cuda, pps, hd, dtype, monkeypatch):
    """The split pass + combine over tables of up to 150 pages, at one
    page per split, the default, and more pages than any row holds."""
    if pps is not None:
        monkeypatch.setattr(ops, "PAGED_PAGES_PER_SPLIT", pps)
    H, K, S, P = 32, 8, 16, 512
    bt, lens = _long_tables(S, P)
    args = (_rand((len(lens), H, hd), dtype, cuda),
            _rand((P, S, K, hd), dtype, cuda),
            _rand((P, S, K, hd), dtype, cuda),
            torch.as_tensor(bt, device=cuda),
            torch.as_tensor(lens, device=cuda))
    before = ops.PAGED.launches
    out = ops.paged_attention(*args, scale=hd ** -0.5)
    assert ops.PAGED.launches == before + 1
    want = paged_attention_ref(*args, scale=hd ** -0.5).float()
    if dtype == torch.float32:
        rtol = atol = 2e-5
    else:
        # both sides compute in fp32 and round once to bf16: the fp32
        # tolerance plus two bf16 ulps (2**-7 of the value) per element,
        # far below the reference tests' 2e-2, which is near a typical
        # output of rows this long
        rtol, atol = 2 * 2 ** -7, 2e-5
    torch.testing.assert_close(out.float(), want, rtol=rtol, atol=atol)
    assert torch.all(out[2] == 0)


@pytest.mark.cuda
def test_paged_kernel_repeats_bitwise(cuda):
    """The combine merges splits in a fixed order with no atomics."""
    H, K, hd, S, P = 32, 8, 64, 16, 512
    bt, lens = _long_tables(S, P)
    args = (_rand((len(lens), H, hd), torch.float32, cuda),
            _rand((P, S, K, hd), torch.float32, cuda),
            _rand((P, S, K, hd), torch.float32, cuda),
            torch.as_tensor(bt, device=cuda),
            torch.as_tensor(lens, device=cuda))
    outs = [ops.paged_attention(*args, scale=0.125) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
def test_sampler_known_answers_on_card(cuda):
    """jax 0.9.0's answers (``jax_threefry_partitionable`` on)."""
    k0 = sampler.key(0)
    assert sampler.random_bits(k0[None], 4, cuda)[0].tolist() == [
        4070199207, 4202968722, 1427181096, 2012915765]
    zeros = torch.zeros(1, 128256, device=cuda)
    for seed, want in ((0, 73608), (7, 96183)):
        got = sampler.sample_tokens_rowwise(sampler.key(seed)[None], zeros)
        assert got.tolist() == [want]


# (rows, vocab): the cells' 256 rows at qwen2-vl's and deepseek-moe's
# vocab, 128 rows, an odd vocab whose rows start off 16-byte boundaries,
# and one row at the Llama 3 vocab
GUMBEL_SHAPES = [(256, 152064), (256, 102400), (128, 152064), (37, 4099),
                 (1, 128256)]


def _gumbel_logits(R, V, dtype, dev):
    """Logits of scale 3 with planted rows where R >= 6: all zeros (pure
    noise), exact ties at 1e30 (columns 9 and 10 in one 16-byte vector,
    V // 2 and V - 1 in later chunks: 9 wins), a -inf tail past V // 3,
    two NaNs (V // 2 wins), +inf at 7 and V - 2 (7 wins), all -inf (0
    wins).  One row: zeros."""
    rng = np.random.default_rng(R * 100003 + V)
    x = 3 * rng.standard_normal((R, V), dtype=np.float32)
    if R == 1:
        x[0] = 0
    if R >= 6:
        x[0] = 0
        x[1, [V - 1, V // 2, 10, 9]] = 1e30
        x[2, V // 3:] = -np.inf
        x[3, [V - 3, V // 2]] = np.nan
        x[4, [V - 2, 7]] = np.inf
        x[5] = -np.inf
    return torch.as_tensor(x).to(dtype).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GUMBEL_SHAPES)
def test_gumbel_kernel_matches_plain_bitwise(cuda, shape, dtype,
                                             temperature):
    """The sampler's kernel gives the plain version's tokens on the card
    bit for bit, the same over three calls, one launch count a call."""
    R, V = shape
    keys = sampler.split(sampler.key(R + V), R)
    logits = _gumbel_logits(R, V, dtype, cuda)
    want = sampler.gumbel_argmax(keys, logits, temperature).to(torch.int32)
    before = ops.GUMBEL.launches
    outs = [ops.gumbel_sample(keys, logits, temperature) for _ in range(3)]
    assert ops.GUMBEL.launches == before + 3
    for got in outs:
        assert got.dtype == torch.int32 and got.device == logits.device
        bad = torch.nonzero(got != want).flatten().tolist()
        if bad:
            r = bad[0]
            pert = (logits[r].float() / temperature
                    + sampler.gumbel(keys[r:r + 1], V, cuda)[0])
            a, b = int(got[r]), int(want[r])
            pytest.fail(f"{len(bad)} rows differ, first {r}: kernel {a} "
                        f"({pert[a].item()!r}), plain {b} "
                        f"({pert[b].item()!r})")
    if R >= 6:
        assert outs[0][1:6].tolist() == [9, outs[0][2].item(), V // 2, 7, 0]
        assert outs[0][2].item() < V // 3


@pytest.mark.cuda
def test_gumbel_kernel_launches_once_a_sampled_draw(cuda):
    """``sample_tokens_rowwise`` launches the kernel once per sampled
    draw and not at all when greedy."""
    keys = sampler.split(sampler.key(3), 4)
    logits = _rand((4, 1000), torch.bfloat16, cuda)
    before = ops.GUMBEL.launches
    sampler.sample_tokens_rowwise(keys, logits, 0.0)
    assert ops.GUMBEL.launches == before
    tok = sampler.sample_tokens_rowwise(keys, logits, 1.0)
    assert ops.GUMBEL.launches == before + 1
    assert tok.dtype == np.int32 and tok.shape == (4,)


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
    for n_live in (None, _live(meta.n_unique, cuda)):
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
                             n_live=_live(meta.n_unique, cuda))
    torch.testing.assert_close(
        out, tree_attention_ref(*args, scale=hd ** -0.5), rtol=3e-5,
        atol=3e-5)
    assert torch.all(out[torch.as_tensor(masked, device=cuda)] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("pps", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_kernel_device_live_count(cuda, dtype, pps):
    """A grid sized for the whole 64-entry bucket, reading the live count
    from the device, against the same launch walking every entry
    (``n_live=None``): bitwise equal at counts 1, pps - 1, pps, N - 1
    and N (the entries past the count are dump entries), one launch
    each."""
    B, H, K, hd, S, P, N = 24, 8, 2, 64, 16, 160, 64
    q, kp, vp = (_rand((B, H, hd), dtype, cuda),
                 _rand((P, S, K, hd), dtype, cuda),
                 _rand((P, S, K, hd), dtype, cuda))
    step = pps or ops.TREE_PAGES_PER_SPLIT
    for n in (1, step - 1, step, N - 1, N):
        pl = np.full(N, P - 1, np.int32)
        pl[:n] = RNG.choice(P - 1, n, replace=False)
        mask = np.zeros((N, B), np.int8)
        mask[:n] = RNG.random((n, B)) < 0.4
        mask[0, :B - 2] = 1               # the last two rows stay masked
        mask[:, B - 2:] = 0
        lens = np.zeros(N, np.int32)
        lens[:n] = RNG.integers(1, S + 1, n)
        args = (q, kp, vp) + tuple(torch.as_tensor(a, device=cuda)
                                   for a in (pl, mask, lens))
        before = ops.TREE.launches
        full = ops.tree_attention(*args, scale=hd ** -0.5,
                                  pages_per_split=pps)
        dev = ops.tree_attention(*args, scale=hd ** -0.5,
                                 pages_per_split=pps, n_live=_live(n, cuda))
        assert ops.TREE.launches == before + 2
        assert torch.equal(full, dev), n
        assert torch.all(dev[B - 2:] == 0)
        want = tree_attention_ref(*(a.float() if a.is_floating_point()
                                    else a for a in args), scale=hd ** -0.5)
        tol = 3e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(dev.float(), want, rtol=tol, atol=tol)


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
@pytest.mark.parametrize("hd", [32, 64, 96, 112, 128])
@pytest.mark.parametrize("S,window", [(8, 0), (256, 0), (128, 48), (1024, 0),
                                      (2048, 0)])
def test_flash_kernel(cuda, S, window, hd, dtype):
    q, k, v = (_rand((2, S, 32, hd), dtype, cuda),
               _rand((2, S, 8, hd), dtype, cuda),
               _rand((2, S, 8, hd), dtype, cuda))
    scale = hd ** -0.5
    before = ops.FLASH.launches
    out = ops.flash_prefill(q, k, v, scale=scale, window=window)
    assert ops.FLASH.launches == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    plain = flash_prefill_ref(q, k, v, scale=scale, window=window)
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                               atol=tol)
    if dtype == torch.float32 and S >= 1024:
        # long buckets: the kernel and the plain version against the
        # same function in float64; the kernel may be no farther from it
        # than 2e-5 and than twice the plain version
        want = flash_prefill_f64(q, k, v, scale=scale, window=window)
        err = float((out.double() - want).abs().max())
        err_plain = float((plain.double() - want).abs().max())
        assert err <= 2e-5 and err <= 2 * err_plain, (err, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(256, 0), (256, 64), (1024, 0)])
def test_flash_kernel_zamba2_heads(cuda, S, window, dtype):
    """zamba2-7b's shared attention block: hd 112, 32 heads over 32 kv
    heads (G = 1); a 64-token window as mixtral's at tiny size; fp32
    buckets of 1024 also against float64 (2e-5, and no farther than
    twice the plain version)."""
    q, k, v = (_rand((2, S, 32, 112), dtype, cuda) for _ in range(3))
    scale = 112 ** -0.5
    out = ops.flash_prefill(q, k, v, scale=scale, window=window)
    plain = flash_prefill_ref(q, k, v, scale=scale, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                               atol=tol)
    if dtype == torch.float32 and S >= 1024:
        want = flash_prefill_f64(q, k, v, scale=scale, window=window)
        err = float((out.double() - want).abs().max())
        err_plain = float((plain.double() - want).abs().max())
        assert err <= 2e-5 and err <= 2 * err_plain, (err, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged", "tree"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_at_zamba2_heads(cuda, kernel, dtype):
    """The decode kernels at zamba2-7b's head shape (H = K = 32, hd 112,
    G = 1), page size 16: the paged kernel over the long tables of the
    split tests, the tree kernel over shared prefixes with fully masked
    rows."""
    H = K = 32
    hd, S, P = 112, 16, 512
    kp, vp = (_rand((P, S, K, hd), dtype, cuda) for _ in range(2))
    if kernel == "paged":
        bt, lens = _long_tables(S, P)
        q = _rand((len(lens), H, hd), dtype, cuda)
        args = (q, kp, vp, torch.as_tensor(bt, device=cuda),
                torch.as_tensor(lens, device=cuda))
        out = ops.paged_attention(*args, scale=hd ** -0.5)
        want = paged_attention_ref(*args, scale=hd ** -0.5)
        tol, empty = 2e-5, [2]
    else:
        B, n_act = 24, 16
        tables = ([[3, 4, 9], [3, 4, 10], [3, 5], [3, 5, 11, 12]]
                  * (n_act // 4) + [[]] * (B - n_act))
        lengths = [40, 35, 32, 60] * (n_act // 4) + [0] * (B - n_act)
        meta = build_tree_metadata(tables, lengths, S, pad_page=P - 1,
                                   check=True)
        q = _rand((B, H, hd), dtype, cuda)
        args = (q, kp, vp) + tuple(torch.as_tensor(a, device=cuda) for a in (
            meta.page_list, meta.page_mask, meta.page_lens))
        out = ops.tree_attention(*args, scale=hd ** -0.5,
                                 n_live=_live(meta.n_unique, cuda))
        want = tree_attention_ref(*args, scale=hd ** -0.5)
        tol, empty = 3e-5, list(range(n_act, B))
    # bf16: both sides compute in fp32 and round once to bf16
    rtol = 0.0 if dtype == torch.float32 else 2 * 2 ** -7
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=tol)
    assert torch.all(out[empty] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [1024, 2048])
def test_flash_kernel_long_buckets_scaled_scores(cuda, S, hd):
    """Long fp32 buckets with q and k 3x unit scale (scores of std 9,
    peaked rows; v at the unit scale the 2e-5 bar is set for): the plain
    version is itself about 2e-5 from float64 here, so the kernel is
    held to the float64 oracle: within 2e-5, and no farther than twice
    the plain version."""
    q, k = (3 * _rand((2, S, n, hd), torch.float32, cuda) for n in (32, 8))
    v = _rand((2, S, 8, hd), torch.float32, cuda)
    scale = hd ** -0.5
    out = ops.flash_prefill(q, k, v, scale=scale)
    plain = flash_prefill_ref(q, k, v, scale=scale)
    want = flash_prefill_f64(q, k, v, scale=scale)
    err = float((out.double() - want).abs().max())
    err_plain = float((plain.double() - want).abs().max())
    assert err <= 2e-5 and err <= 2 * err_plain, (err, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged", "tree"])
def test_decode_kernels_at_page_size_8_and_two_groups(cuda, kernel):
    """The shapes of the trained tiny models' serving paths: 8 slots per
    page, H 4 / K 2 (G = 2), hd 64, rows sharing prefixes and ending
    mid-page, a zero-length row."""
    B, H, K, hd, S, P = 10, 4, 2, 64, 8, 96
    q, kp, vp = (_rand((B, H, hd), torch.float32, cuda),
                 _rand((P, S, K, hd), torch.float32, cuda),
                 _rand((P, S, K, hd), torch.float32, cuda))
    tables = [[1, 2, 3 + b] + ([20 + b] if b % 2 else []) for b in
              range(B - 1)] + [[]]
    lengths = [2 * S + 1 + (b % S) + (S if b % 2 else 0)
               for b in range(B - 1)] + [0]
    if kernel == "paged":
        bt = np.full((B, 4), -1, np.int32)
        for b, t in enumerate(tables):
            bt[b, :len(t)] = t
        args = (q, kp, vp, torch.as_tensor(bt, device=cuda),
                torch.as_tensor(lengths, dtype=torch.int32, device=cuda))
        out = ops.paged_attention(*args, scale=hd ** -0.5)
        want = paged_attention_ref(*args, scale=hd ** -0.5)
        tol = 2e-5
    else:
        meta = build_tree_metadata(tables, lengths, S, pad_page=P - 1,
                                   check=True)
        args = (q, kp, vp) + tuple(torch.as_tensor(a, device=cuda) for a in (
            meta.page_list, meta.page_mask, meta.page_lens))
        out = ops.tree_attention(*args, scale=hd ** -0.5,
                                 n_live=_live(meta.n_unique, cuda))
        want = tree_attention_ref(*args, scale=hd ** -0.5)
        tol = 3e-5
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    assert torch.all(out[-1] == 0)


@pytest.mark.cuda
def test_training_step_on_card(cuda):
    """One full training step of a tiny LM on the card (plain attention,
    no kernel): a finite loss equal to the CPU's, every param's grad
    present and finite, the update applied to every leaf."""
    from repro_torch.training import TrainConfig, train_lm
    from repro_torch.training.task import ArithmeticTask
    cfg = dataclasses.replace(get_config("tiny-lm"), n_layers=2, d_model=128,
                              n_heads=4, n_kv_heads=2, d_ff=256,
                              vocab_size=32)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in ArithmeticTask(
        n_ops=3, seq_len=48).lm_batch(np.random.default_rng(0), 8).items()}
    lm = build_model(cfg, device=cuda)
    leaves = [a.to(cuda).requires_grad_(True) for a in
              tree_leaves(params)]
    it = iter(leaves)
    loss = lm.loss(tree_map(lambda _: next(it), params), batch)
    grads = torch.autograd.grad(loss, leaves)       # raises if one is unused
    assert torch.isfinite(loss)
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    lm_cpu = build_model(cfg, device="cpu")
    want = lm_cpu.loss(params, {k: v.cpu() for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    before = ops.FLASH.launches + ops.PAGED.launches + ops.TREE.launches
    trained, hist = train_lm(lm, tree_map(lambda a: a.to(cuda), params),
                             ArithmeticTask(n_ops=3, seq_len=48),
                             TrainConfig(steps=1, batch=8, log_every=1))
    assert np.isfinite(hist[0])
    assert all(not torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(trained), tree_leaves(params)))
    assert ops.FLASH.launches + ops.PAGED.launches + ops.TREE.launches \
        == before


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
@pytest.mark.parametrize("arch,dtype", [
    pytest.param("tiny-lm", "float32", id="float32"),
    pytest.param("tiny-lm", "bfloat16", id="bf16"),
    pytest.param("deepseek-moe-16b", "bfloat16", id="bf16-moe")])
def test_engine_on_card_matches_cpu(cuda, arch, dtype, mode):
    """A tiny engine on the card (kernels, noise drawn on the card)
    against the same engine on the CPU (plain versions), and the kernels
    of the path launched.  In float32: the same greedy and sampled
    tokens, logits within 1e-4.  In bfloat16 (dense, and MoE through the
    expert ``bmm``), decoding at bf16 with its K/V in the float32 pool:
    logits within bf16 rounding, 8 units (2**-8) at the largest logit,
    the tolerance the CPU tests hold decode to its own prefill.  There a
    row's logits are compared while its greedy tokens agree; where they
    part, the card's token must score within that tolerance of the CPU's
    best: a near tie that the two summation orders break apart, as the
    dense case showed on the card.  The MoE routes every token to every
    expert: a top-k choice below that flips where two gates tie within
    rounding, a discrete change no rounding tolerance covers."""
    cfg = tiny_variant(get_config(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, top_k=cfg.moe.n_experts))
    cfg = dataclasses.replace(cfg, n_layers=2, d_model=128, n_heads=4,
                              n_kv_heads=2, head_dim=32, vocab_size=64,
                              dtype=dtype)
    exact = dtype == "float32"
    lm_cpu = build_model(cfg, device="cpu")
    params = lm_cpu.cast_params(lm_cpu.init(torch.Generator().manual_seed(0)))
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
                     e.logits_trace,
                     e.decode(ids, 6, key=3, temperature=1.0) if exact
                     else None))
    (cpu, cpu_tr, cpu_sampled), (card, card_tr, card_sampled) = outs
    if exact:
        assert cpu == card and cpu_sampled == card_sampled
        for a, b in zip(cpu_tr, card_tr):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    else:
        assert len(cpu_tr) == len(card_tr) == 9
        np.testing.assert_allclose(
            card_tr[0], cpu_tr[0], rtol=0,
            atol=8 * 2.0 ** -8 * np.abs(cpu_tr[0]).max())
        compared = 0
        for t, (a, b) in enumerate(zip(cpu_tr[1:], card_tr[1:])):
            for j, i in enumerate(ids):
                if cpu[i][:t] != card[i][:t]:
                    continue        # the rows' inputs differ from here on
                tol = 8 * 2.0 ** -8 * np.abs(a[j]).max()
                np.testing.assert_allclose(b[j], a[j], rtol=0, atol=tol)
                assert a[j, card[i][t]] >= a[j].max() - tol
                compared += 1
        assert compared >= 3 * len(ids)
    kernel = ops.PAGED if mode == "paged" else ops.TREE
    assert kernel.launches > 0 and ops.FLASH.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged", "tree"])
@pytest.mark.parametrize("arch,dtype", [
    pytest.param("qwen2-vl-7b", "float32", id="mrope-float32"),
    pytest.param("qwen2-vl-7b", "bfloat16", id="mrope-bf16"),
    pytest.param("deepseek-moe-16b", "bfloat16", id="moe-bf16"),
    pytest.param("zamba2-7b", "float32", id="hybrid-float32")])
def test_graph_decode_matches_eager_bitwise(cuda, arch, dtype, mode):
    """The decode forward replayed from CUDA graphs against the same
    engine with an eager runner (``DecodeRunner()``), traced: over 40
    iterations whose tree buckets grow, are replayed out of capture
    order and shrink within a bucket (``test_torch_decode_graphs``'s
    drive), the same logits bit for bit and the same greedy tokens; one
    capture per key and a replay for every other iteration; each
    kernel's launches (a replay adds its capture's), the MoE's routed
    and dropped counts and the copy-on-write pages equal the eager
    run's."""
    from test_torch_decode_graphs import _drive
    from repro_torch import tracing
    cfg = dataclasses.replace(tiny_variant(get_config(arch)), dtype=dtype)
    lm = build_model(cfg, device=cuda)
    params = lm.cast_params(lm.init(torch.Generator().manual_seed(0)))
    params = tree_map(lambda a: a.to(cuda), params)
    runs = []
    for graphed in (False, True):
        e = PagedEngine(lm, params, EngineConfig(
            n_pages=96, page_size=4, max_batch=8, max_seq_len=128,
            attention=mode, trace_logits=True), device=cuda)
        assert e.runner.graphed
        if not graphed:
            e.runner = DecodeRunner()
        ops.reset_launch_counts()
        tracing.enable()
        tracing.reset()
        try:
            out, n = _drive(e, cfg.vocab_size)
            snap = tracing.snapshot()["counters"]
        finally:
            tracing.disable()
        runs.append((e, out, n, snap))
    (eager, out_e, n, c_e), (e, out_g, n_g, c_g) = runs
    assert n == n_g >= 32 and out_e == out_g
    # the prefill's logits lead each trace
    assert len(eager.logits_trace) == len(e.logits_trace) == n + 1
    for x, y in zip(eager.logits_trace, e.logits_trace):
        np.testing.assert_array_equal(x, y)
    keys = len(e.runner._keys)
    assert (keys == 1) if mode == "paged" else (keys >= 3)
    assert c_g["decode.graph_captures"] == e.n_decode_graph_captures == keys
    assert c_g["decode.graph_replays"] == n - keys
    assert c_e["decode.graph_captures"] == c_e["decode.graph_replays"] == 0
    for name, v in c_e.items():
        if not name.startswith("decode.graph"):
            assert c_g[name] == v, name
    if cfg.moe is not None:
        assert c_g[f"moe.routed/{cfg.name}"] > 0
    kernel = ops.PAGED if mode == "paged" else ops.TREE
    for entry in e.runner._keys.values():
        assert dict(entry["launches"])[kernel] == e.n_kv_layers


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged", "tree"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "deepseek-moe-16b"])
def test_family_engine_on_card_matches_cpu(cuda, arch, mode):
    """Tiny zamba2 (hybrid: mamba state pages + the shared attention
    block) and tiny deepseek-moe engines on the card against the same
    engines on the CPU: same greedy tokens after a branch, close logits,
    the kernels of the path launched, state pages bitwise preserved by a
    swap round trip."""
    cfg = tiny_variant(get_config(arch))
    lm_cpu = build_model(cfg, device="cpu")
    params = lm_cpu.init(torch.Generator().manual_seed(0))
    ecfg = EngineConfig(n_pages=64, page_size=8, max_batch=8,
                        max_seq_len=64, attention=mode, trace_logits=True)
    prompts = [list(map(int, RNG.integers(0, cfg.vocab_size, n)))
               for n in (13, 6, 21)]
    outs = []
    ops.reset_launch_counts()
    for dev in ("cpu", cuda):
        lm = build_model(cfg, device=dev)
        e = PagedEngine(lm, tree_map(lambda a: a.to(dev), params), ecfg,
                        device=dev)
        sids = e.prefill_many(prompts)
        ids = e.branch(sids[0], 3) + e.branch(sids[2], 2)
        out = e.decode(ids, 6, key=0, temperature=0.0)
        if e.state is not None:
            before = {n: a.clone() for n, a in e.state.arrays.items()}
            pages = [e.state_of[i] for i in ids]
            e.swap_out(sids[:1] + ids[:3])
            e.swap_in(sids[:1] + ids[:3])
            for n, a in e.state.arrays.items():
                got = a[:, [e.state_of[i] for i in ids]]
                assert torch.equal(got, before[n][:, pages])
        outs.append((out, e.logits_trace,
                     e.decode(ids, 4, key=0, temperature=0.0)))
    assert outs[0][0] == outs[1][0] and outs[0][2] == outs[1][2]
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    kernel = ops.PAGED if mode == "paged" else ops.TREE
    assert kernel.launches > 0 and ops.FLASH.launches > 0


@pytest.mark.cuda
def test_swap_pinned_roundtrip_on_card(cuda):
    """Swap-out on the card snapshots the pages and copies them into
    pinned host memory on a side stream; the freed pages are overwritten
    (another problem's prefill) before ``resolve()``.  The host copy and
    the restored pages are bitwise the originals, and sampled decode
    resumes as on a twin engine that never swapped."""
    cfg = dataclasses.replace(get_config("tiny-lm"), n_layers=2, d_model=128,
                              n_heads=4, n_kv_heads=2, head_dim=32,
                              vocab_size=64)
    lm = build_model(cfg, device=cuda)
    params = lm.init(torch.Generator(device=cuda).manual_seed(0))
    ecfg = EngineConfig(n_pages=64, page_size=8, max_batch=8,
                        max_seq_len=96, attention="paged")
    prompt = list(map(int, RNG.integers(0, 64, 40)))
    filler_tokens = list(map(int, RNG.integers(0, 64, 90)))

    def seq_kv(e, ids):
        return [[t.clone() for l in range(e.pool.n_layers)
                 for t in e.pool.gather_kv(l, e.alloc.seqs[s].block_table,
                                           e.alloc.seqs[s].length)]
                for s in ids]

    streams = []
    for swap in (False, True):
        e = PagedEngine(lm, params, ecfg, device=cuda)
        sid = e.prefill(prompt)
        ids = [sid] + e.branch(sid, 3)
        e.decode(ids[1:], 5, key=1, temperature=1.0)
        if swap:
            before = seq_kv(e, ids)
            pages = e.alloc.exclusive_pages(ids)
            snap = (e.pool.k[:, pages].cpu(), e.pool.v[:, pages].cpu())
            assert e.swap_out(ids) == len(pages)
            (stale, gather), = e._spill[e.alloc.seqs[sid].ns]
            assert stale == pages
            assert all(t.is_pinned() for t in gather._host_t)
            # the freed pages are reused before the host copy is read
            filler = e.prefill(filler_tokens[:8 * len(pages)])
            assert sorted(e.alloc.seqs[filler].block_table) == sorted(pages)
            host_k, host_v = gather.resolve()
            assert torch.equal(torch.from_numpy(host_k), snap[0])
            assert torch.equal(torch.from_numpy(host_v), snap[1])
            e.free(filler)
            assert e.swap_in(ids) == len(pages)
            after = seq_kv(e, ids)
            assert all(torch.equal(a, b) for x, y in zip(before, after)
                       for a, b in zip(x, y))
        streams.append(list(e.decode(ids[1:], 6, key=2,
                                     temperature=1.0).values()))
        e.alloc.check_invariants()
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# qwen2-vl-7b's head shape: 28 query heads over 4 kv heads (G = 7, odd and
# not a power of two), hd 128, page size 16
# ---------------------------------------------------------------------------

QWEN_H, QWEN_K, QWEN_HD = 28, 4, 128


def _allocator_tree(S, P, problems=4, leaves=8, n_rows=32):
    """Block tables and lengths of a search tree built with the port's
    allocator: each problem's prompt (ending mid-page) branches into
    ``leaves`` leaves, each of which appends its own tail (the shared
    partial last page is copied on write, so shared pages are full).
    Returns (allocator, row seq ids padded with None to ``n_rows``)."""
    from repro_torch.kvcache.allocator import PageAllocator
    alloc = PageAllocator(P - 1, S)
    rows = []
    for _ in range(problems):
        h = alloc.new_seq(int(RNG.integers(8 * S, 14 * S)) + S // 2)
        for kid in alloc.branch(h.seq_id, leaves):
            alloc.append_tokens(kid.seq_id, int(RNG.integers(1, 3 * S)))
            rows.append(kid.seq_id)
        alloc.free_seq(h.seq_id)
    alloc.check_invariants()
    return alloc, rows + [None] * (n_rows - len(rows))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged", "tree"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_at_qwen2_vl_heads(cuda, kernel, dtype):
    """Both decode kernels at G 7, hd 128 over one allocator-built tree
    of 4 problems x 8 leaves and 8 inactive rows (32 rows, as the
    smoke's sweep): the paged kernel's 16-lane head segments (112 of 128
    threads on) and the tree kernel's (leaf, head) pairs, in float32
    (2e-5 / 3e-5) and bfloat16 (one bf16 rounding on top)."""
    S, P = 16, 512
    alloc, rows = _allocator_tree(S, P)
    kp, vp = (_rand((P, S, QWEN_K, QWEN_HD), dtype, cuda) for _ in range(2))
    q = _rand((len(rows), QWEN_H, QWEN_HD), dtype, cuda)
    scale = QWEN_HD ** -0.5
    live = [r for r in rows if r is not None]
    if kernel == "paged":
        T = max(len(alloc.seqs[r].block_table) for r in live)
        bt = np.full((len(rows), T), -1, np.int32)
        lens = np.zeros(len(rows), np.int32)
        for b, r in enumerate(live):
            t = alloc.seqs[r].block_table
            bt[b, :len(t)] = t
            lens[b] = alloc.seqs[r].length
        args = (q, kp, vp, torch.as_tensor(bt, device=cuda),
                torch.as_tensor(lens, device=cuda))
        out = ops.paged_attention(*args, scale=scale)
        want = paged_attention_ref(*args, scale=scale)
        tol = 2e-5
    else:
        meta = alloc.tree_metadata(rows, pad_page=P - 1, check=True)
        assert meta.n_unique < sum(len(alloc.seqs[r].block_table)
                                   for r in live)      # pages are shared
        args = (q, kp, vp) + tuple(torch.as_tensor(a, device=cuda) for a in (
            meta.page_list, meta.page_mask, meta.page_lens))
        out = ops.tree_attention(*args, scale=scale,
                                 n_live=_live(meta.n_unique, cuda))
        want = tree_attention_ref(*args, scale=scale)
        tol = 3e-5
    rtol = 0.0 if dtype == torch.float32 else 2 * 2 ** -7
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=tol)
    assert torch.all(out[len(live):] == 0)


@pytest.mark.cuda
def test_tree_kernel_leaf_chunks_at_qwen2_vl_heads(cuda):
    """At 32 rows the float32 leaves' state does not fit one CTA (about
    279 KB against the 227 KB opt-in), so the split pass cuts the batch
    into two leaf chunks of 16; bf16 halves the staged pages and queries
    and keeps one chunk of 32."""
    S, P = 16, 256
    for dtype, leaves in ((torch.float32, 16), (torch.bfloat16, 32)):
        q = _rand((32, QWEN_H, QWEN_HD), dtype, cuda)
        kp = _rand((P, S, QWEN_K, QWEN_HD), dtype, cuda)
        assert ops.tree_leaves_per_cta(q, kp, 64) == leaves, dtype
    assert ops.tree_leaves_per_cta(q[:16].float(), kp.float(), 64) == 16


@pytest.mark.cuda
@pytest.mark.parametrize("S,dtype", [(100, torch.float32),
                                     (256, torch.float32),
                                     (1024, torch.float32),
                                     (100, torch.bfloat16),
                                     (256, torch.bfloat16)])
def test_flash_kernel_qwen2_vl_heads(cuda, S, dtype):
    """Flash prefill at G 7, hd 128: a bucket that is not a multiple of
    the tile, the sweep's bucket, and a long fp32 bucket also against
    float64 (2e-5, and no farther than twice the plain version)."""
    q = _rand((2, S, QWEN_H, QWEN_HD), dtype, cuda)
    k, v = (_rand((2, S, QWEN_K, QWEN_HD), dtype, cuda) for _ in range(2))
    scale = QWEN_HD ** -0.5
    out = ops.flash_prefill(q, k, v, scale=scale)
    plain = flash_prefill_ref(q, k, v, scale=scale)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                               atol=tol)
    if dtype == torch.float32 and S >= 1024:
        want = flash_prefill_f64(q, k, v, scale=scale)
        err = float((out.double() - want).abs().max())
        err_plain = float((plain.double() - want).abs().max())
        assert err <= 2e-5 and err <= 2 * err_plain, (err, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged", "tree"])
def test_vlm_engine_on_card_matches_cpu(cuda, mode):
    """qwen2-vl-tiny with 7 query heads over 1 kv head on the card
    against the same engine on the CPU: same greedy tokens after a
    branch, close logits, the kernels of the path launched; and
    ``forward`` with patch embeds and distinct M-RoPE streams close to
    the CPU's."""
    cfg = dataclasses.replace(tiny_variant(get_config("qwen2-vl-7b")),
                              n_heads=7, n_kv_heads=1)
    lm_cpu = build_model(cfg, device="cpu")
    params = lm_cpu.init(torch.Generator().manual_seed(0))
    ecfg = EngineConfig(n_pages=64, page_size=8, max_batch=8,
                        max_seq_len=64, attention=mode, trace_logits=True)
    prompts = [list(map(int, RNG.integers(0, cfg.vocab_size, n)))
               for n in (13, 6, 21)]
    embeds = RNG.normal(size=(2, 6, cfg.frontend_dim)).astype(np.float32)
    toks = RNG.integers(0, cfg.vocab_size, (2, 5))
    pos = np.stack([np.r_[np.zeros(6), np.arange(3, 8)],
                    np.r_[np.repeat(np.arange(2), 3), np.arange(3, 8)],
                    np.r_[np.tile(np.arange(3), 2), np.arange(3, 8)]])
    pos = np.broadcast_to(pos[:, None], (3, 2, 11)).astype(np.int32)
    outs = []
    ops.reset_launch_counts()
    for dev in ("cpu", cuda):
        lm = build_model(cfg, device=dev)
        p = tree_map(lambda a: a.to(dev), params)
        e = PagedEngine(lm, p, ecfg, device=dev)
        sids = e.prefill_many(prompts)
        ids = e.branch(sids[0], 3) + e.branch(sids[2], 2)
        logits, _ = lm.forward(p, {
            "embeds": torch.as_tensor(embeds, device=dev),
            "tokens": torch.as_tensor(toks, device=dev),
            "positions": torch.as_tensor(pos.copy(), device=dev)})
        outs.append((e.decode(ids, 6, key=0, temperature=0.0),
                     e.logits_trace, logits.cpu()))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(outs[1][2], outs[0][2], rtol=1e-4, atol=1e-4)
    kernel = ops.PAGED if mode == "paged" else ops.TREE
    assert kernel.launches > 0 and ops.FLASH.launches > 0


@pytest.mark.cuda
def test_moe_dispatch_and_combine_on_card_match_cpu(cuda):
    """One MoE block of tiny deepseek-moe (shared experts, capacity 8 so
    replicas drop): output, aux, and the grads of sum(y^2) + aux to x
    and every weight, the card against the CPU."""
    from repro_torch.models import moe as MOE
    cfg = tiny_variant(get_config("deepseek-moe-16b"))
    blk = MOE.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.as_tensor(RNG.normal(size=(64, cfg.d_model)),
                        dtype=torch.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda a: a.to(dev).requires_grad_(True), blk)
        xx = x.to(dev).requires_grad_(True)
        y, aux = MOE.moe_apply(p, xx, cfg, capacity=8)
        ((y ** 2).sum() + aux).backward()
        out.append([y, aux, xx.grad] + [a.grad for a in tree_leaves(p)])
    for a, b in zip(*out):
        scale = float(b.detach().abs().max())
        torch.testing.assert_close(a.detach().cpu(), b.detach(),
                                   rtol=1e-4, atol=1e-5 * max(scale, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b",
                                  "zamba2-7b", "rwkv6-7b"])
def test_contiguous_decode_on_card_matches_cpu(cuda, arch):
    """``prefill`` then 3 ``decode_step``s on the contiguous cache (the
    mixtral ring, zamba2's hybrid groups, rwkv6 states): logits and every
    cache leaf, the card against the CPU."""
    cfg = tiny_variant(get_config(arch))
    cpu = torch.device("cpu")
    m_cpu, m_dev = build_model(cfg, device=cpu), build_model(cfg,
                                                              device=cuda)
    params = m_cpu.init(torch.Generator().manual_seed(1))
    p_dev = tree_map(lambda a: a.to(cuda), params)
    toks = torch.as_tensor(RNG.integers(0, cfg.vocab_size, (2, 99)))
    with torch.no_grad():
        lg_c, c_c = m_cpu.prefill(params, {"tokens": toks[:, :96]}, 99)
        lg_d, c_d = m_dev.prefill(p_dev, {"tokens": toks[:, :96].to(cuda)},
                                  99)
        torch.testing.assert_close(lg_d.cpu(), lg_c, rtol=1e-4, atol=1e-4)
        for t in range(96, 99):
            lg_c, c_c = m_cpu.decode_step(params, toks[:, t:t + 1], c_c)
            lg_d, c_d = m_dev.decode_step(p_dev, toks[:, t:t + 1].to(cuda),
                                          c_d)
            torch.testing.assert_close(lg_d.cpu(), lg_c, rtol=1e-4,
                                       atol=1e-4)
    for a, b in zip(tree_leaves(c_d), tree_leaves(c_c)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.fixture
def nccl_mesh(cuda):
    """A (1,1) mesh over a world-size-1 NCCL group (started once per
    process, kept: a process has one default group)."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device=cuda)
    assert torch.distributed.get_backend() == "nccl"
    return mesh


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged", "tree"])
def test_one_device_mesh_engine_on_card(cuda, nccl_mesh, mode):
    """A tiny engine on a 1-device mesh gives the mesh-less engine's
    tokens and logits on the card, the kernels launching, its pool
    placed pages-on-model with no fallback; a 2-device mesh is refused
    at the kernel seam."""
    cfg = dataclasses.replace(get_config("tiny-lm"), n_layers=2, d_model=128,
                              n_heads=4, n_kv_heads=2, head_dim=32,
                              vocab_size=64)
    lm = build_model(cfg, device=cuda)
    params = lm.init(torch.Generator(device=cuda).manual_seed(0))
    prompts = [list(map(int, RNG.integers(0, 64, n))) for n in (13, 6, 21)]
    outs = []
    for mesh in (None, nccl_mesh):
        ops.reset_launch_counts()
        e = PagedEngine(lm, params, EngineConfig(
            n_pages=64, page_size=8, max_batch=8, max_seq_len=96,
            attention=mode, trace_logits=True, mesh=mesh), device=cuda)
        sids = e.prefill_many(prompts)
        ids = e.branch(sids[0], 3) + e.branch(sids[2], 2)
        outs.append((e.decode(ids, 8, key=0, temperature=0.0),
                     e.logits_trace))
        kernel = ops.PAGED if mode == "paged" else ops.TREE
        assert kernel.launches > 0 and ops.FLASH.launches > 0
        # the mesh engine decodes eagerly; the mesh-less one replays
        assert (e.n_decode_graph_captures > 0) == (mesh is None)
        assert (e.n_decode_graph_replays > 0) == (mesh is None)
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_array_equal(a, b)
    assert e.shard_fallbacks == [] and e.pool_placements[1].is_shard(1)

    class TwoDevices:
        def size(self, dim=None):
            return 2

    with pytest.raises(ValueError, match="shard_map"):
        ops.check_mesh_compat(TwoDevices(), use_kernel=True)


@pytest.mark.cuda
def test_expert_parallel_layer_on_one_rank_nccl(cuda, nccl_mesh):
    """``moe_apply_expert_parallel`` on a (1,1) mesh of the NCCL group
    against ``moe_apply`` on the card (the reference's 2e-4), its four
    all_to_alls run."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import layer_slice
    cfg = tiny_variant(get_config("deepseek-moe-16b"))
    lm = build_model(cfg, device=cuda)
    params = lm.init(torch.Generator(device=cuda).manual_seed(0))
    gi = next(i for i, g in enumerate(params["groups"]) if "moe" in g)
    p = layer_slice(params["groups"][gi], 0)["moe"]
    x = _rand((64, cfg.d_model), torch.float32, cuda)
    y_ref, aux_ref = MOE.moe_apply(p, x, cfg)
    saved = (MOE.MESH, MOE.DATA_AXES, MOE.N_GROUPS)
    MOE.MESH, MOE.DATA_AXES, MOE.N_GROUPS = nccl_mesh, ("data",), 1
    try:
        n0 = MOE.N_ALL_TO_ALL
        y, aux = MOE.moe_apply_auto(p, x, cfg)
        assert MOE.N_ALL_TO_ALL - n0 == 4
    finally:
        MOE.MESH, MOE.DATA_AXES, MOE.N_GROUPS = saved
    assert y.device == x.device and not hasattr(y, "device_mesh")
    np.testing.assert_allclose(y.cpu().numpy(), y_ref.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
