"""Dispatch seam of the hand-written kernels (port of ``repro.kernels.ops``;
the attention kernels, and the decode sampler's Gumbel-max draw).

Each wrapper takes the plain PyTorch version (``ref.py``; the sampler's
in ``serving/sampler.py``) for tensors on the CPU, and for tensors on a
CUDA device launches the hand-written kernel from ``csrc/`` or raises —
it never falls back. The kernel runs on ``torch.cuda.current_stream()``,
allocates nothing itself (the wrapper allocates the output), and the
wrapper raises if the launch reports an error.

Every kernel keeps a plain launch counter (``Kernel.launches``) of its
runs, so a run can show that its main path went through the kernels:
raised by one where its wrapper launches it, and by each replay of a
captured decode forward for every launch the capture recorded
(``serving.engine.DecodeRunner``; a capture itself runs nothing).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build
from .ref import flash_prefill_ref, paged_attention_ref, tree_attention_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh codes


class Kernel:
    """One hand-written CUDA kernel: its C entry point and launch count."""

    def __init__(self, name: str, argtypes, replaces: str):
        self.name = name
        self.symbol = f"{name}_launch"
        self.argtypes = argtypes
        self.replaces = replaces        # the Pallas kernel it ports
        self.launches = 0
        self._fn = None

    @property
    def source(self) -> str:
        return f"src/repro_torch/kernels/csrc/{self.name}.cu"

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = build.load(self.name)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = _I
            self._fn = (lib, fn)
        lib, fn = self._fn
        rc = fn(*args)
        if rc != 0:
            msg = lib.cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed: CUDA error "
                               f"{rc} ({msg})")
        self.launches += 1


def check_mesh_compat(mesh, *, use_kernel: bool) -> None:
    """Wrapper-seam guard for mesh-aware engines.

    The kernels run per device: called on operands sharded across a
    >1-device mesh they would compute on a shard as if it were the whole
    pool.  Engines therefore call this at build time, with
    ``use_kernel`` true on a CUDA device (where the kernels decide), and
    a multi-device mesh with kernels is refused up front.
    """
    if mesh is None or not use_kernel:
        return
    size = mesh.size()
    if size > 1:
        raise ValueError(
            f"use_kernel=True on a {size}-device mesh: the CUDA "
            f"decode/prefill kernels are per-device and not yet wrapped "
            f"in local_map (the port's shard_map) — run the plain "
            f"PyTorch path (use_kernel=False) on multi-device meshes, or "
            f"a 1-device mesh with kernels")


PAGED = Kernel("paged_attention", [_P] * 8 + [_I] * 7 + [_F, _I, _P],
               "src/repro/kernels/paged_attention.py:116")
TREE = Kernel("tree_attention", [_P] * 11 + [_I] * 7 + [_F, _I, _P],
              "src/repro/kernels/tree_attention.py:217")
FLASH = Kernel("flash_prefill", [_P] * 4 + [_I] * 7 + [_F, _I, _P],
               "src/repro/kernels/flash_prefill.py:98")
# no Pallas kernel: jax.random.categorical per row, which XLA fuses
GUMBEL = Kernel("gumbel_sample", [_P] * 5 + [_I] * 4 + [_F, _I, _P],
                "src/repro/serving/sampler.py:28")
KERNELS = (PAGED, TREE, FLASH, GUMBEL)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Checks shared by the wrappers
# ---------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(*ts: torch.Tensor) -> None:
    """The kernels stage operands with 16-byte async copies."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def _dtype_code(q: torch.Tensor) -> int:
    code = _DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {q.dtype}")
    return code


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

# block-table entries each CTA of the paged kernel's split pass walks:
# the grid is (rows, kv heads, ceil(T / PAGED_PAGES_PER_SPLIT)).  Fewer
# give more CTAs and more partials for the combine pass; more give each
# CTA a longer double-buffered page stream.  Read at every call (the
# wrapper's signature has no such argument).  chip_smoke.py's replay
# sweep on an NVIDIA H100 80GB HBM3 (700 W), on the largest paged call of
# its llama3.2-1b main path (32 rows, 9456 attended slots, T 32, 8 kv
# heads, fp32), read 0.0427, 0.0365, 0.0331, 0.0387, 0.0452 and 0.0527 ms
# at 1, 2, 4, 8, 16 and 32 pages per split (PERF.md).
PAGED_PAGES_PER_SPLIT = 4


def paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                    scale: float) -> torch.Tensor:
    """q (B,H,hd); k/v_pool (P,S,K,hd); block_tables (B,T) int32 (-1
    pad); lengths (B,) int32.  Returns (B,H,hd) in q's dtype.

    On a CUDA device: a split pass over ``PAGED_PAGES_PER_SPLIT``
    block-table entries per CTA and a combine pass (two launches, one
    count); the split size does not change the result.
    """
    if _on_cpu(q):
        return paged_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                                   scale=scale)
    B, H, hd = q.shape
    P, S, K, _ = k_pool.shape
    T = block_tables.shape[1]
    dev, dt = q.device, q.dtype
    code = _dtype_code(q)
    _check("q", q, dev, dt, (B, H, hd))
    _check("k_pool", k_pool, dev, dt, (P, S, K, hd))
    _check("v_pool", v_pool, dev, dt, (P, S, K, hd))
    _check("block_tables", block_tables, dev, torch.int32, (B, T))
    _check("lengths", lengths, dev, torch.int32, (B,))
    _check_aligned(q, k_pool, v_pool)
    G = H // K if K else 0
    if H % K or not 1 <= G <= 32 or hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"paged_attention takes G = H/K in 1..32 and hd a "
                         f"multiple of 8 up to 256, got H={H} K={K} hd={hd}")
    pps = int(PAGED_PAGES_PER_SPLIT)
    if pps < 1:
        raise ValueError(f"PAGED_PAGES_PER_SPLIT must be >= 1, got {pps}")
    pps = max(1, min(pps, T))
    n_splits = -(-T // pps)
    out = torch.empty_like(q)
    # one scratch buffer for the split partials: acc (n_splits, B, H, hd)
    # and (m, l) (n_splits, B, H, 2), float32
    acc_bytes = n_splits * B * H * hd * 4
    scratch = torch.empty(acc_bytes + n_splits * B * H * 2 * 4,
                          dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    PAGED.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 base, base + acc_bytes, B, K, G, hd, S, T, pps,
                 float(scale), code, _stream(dev))
    return out


# entries of page_list each CTA of the tree kernel's split pass walks.
# Fewer give more CTAs ((live entries / pages_per_split) x K) and more
# partials for the combine pass to merge; more give each CTA a longer
# double-buffered page stream.  chip_smoke.py's replay sweep on an NVIDIA
# H100 80GB HBM3 (700 W), on the largest tree call of its llama3.2-1b
# main path (32 rows, 8 kv heads, 256 live pages, fp32), read 0.086,
# 0.067, 0.059, 0.055, 0.084 and 0.117 ms at 1, 2, 4, 8, 16 and 32
# pages per split (PERF.md).
TREE_PAGES_PER_SPLIT = 8


def tree_attention(q, k_pool, v_pool, page_list, page_mask, page_lens, *,
                   scale: float, pages_per_split: Optional[int] = None,
                   n_live=None) -> torch.Tensor:
    """q (B,H,hd); k/v_pool (P,S,K,hd); page_list (N,) int32; page_mask
    (N,B) int8; page_lens (N,) int32.  Returns (B,H,hd).

    ``pages_per_split`` is the split pass's page run per CTA (None =
    ``TREE_PAGES_PER_SPLIT``).  ``n_live``, None or a (1,) int32 tensor
    on q's device, is the count of leading ``page_list`` entries that may
    be live (every later entry must be a zero-length dump entry): the
    grid covers all N entries and the kernel reads the count, so CTAs
    past it exit at once (one launch shape for any count, as a CUDA
    graph replays).  It does not change the result.
    """
    if n_live is not None:
        if not isinstance(n_live, torch.Tensor):
            raise TypeError(f"n_live must be None or a (1,) int32 tensor on "
                            f"q's device, got {type(n_live).__name__}")
        _check("n_live", n_live, q.device, torch.int32, (1,))
    if _on_cpu(q):
        return tree_attention_ref(q, k_pool, v_pool, page_list, page_mask,
                                  page_lens, scale=scale)
    B, H, hd = q.shape
    P, S, K, _ = k_pool.shape
    N = page_list.shape[0]
    dev, dt = q.device, q.dtype
    code = _dtype_code(q)
    _check("q", q, dev, dt, (B, H, hd))
    _check("k_pool", k_pool, dev, dt, (P, S, K, hd))
    _check("v_pool", v_pool, dev, dt, (P, S, K, hd))
    _check("page_list", page_list, dev, torch.int32, (N,))
    _check("page_mask", page_mask, dev, torch.int8, (N, B))
    _check("page_lens", page_lens, dev, torch.int32, (N,))
    _check_aligned(q, k_pool, v_pool)
    G = H // K if K else 0
    if H % K or not 1 <= G <= 32 or hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"tree_attention takes G = H/K in 1..32 and hd a "
                         f"multiple of 8 up to 256, got H={H} K={K} hd={hd}")
    pps = TREE_PAGES_PER_SPLIT if pages_per_split is None \
        else int(pages_per_split)
    if pps < 1:
        raise ValueError(f"pages_per_split must be >= 1, got "
                         f"{pages_per_split}")
    pps = max(1, min(pps, N))
    n_splits = -(-N // pps)
    out = torch.empty_like(q)
    # one scratch buffer for the split partials: acc (n_splits, B, H, hd)
    # and (m, l) (n_splits, B, H, 2) in float32, hit flags (n_splits, B)
    acc_bytes = n_splits * B * H * hd * 4
    ml_bytes = n_splits * B * H * 2 * 4
    scratch = torch.empty(acc_bytes + ml_bytes + n_splits * B,
                          dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    TREE.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_list.data_ptr(), page_mask.data_ptr(),
                page_lens.data_ptr(), out.data_ptr(), base, base + acc_bytes,
                base + acc_bytes + ml_bytes,
                None if n_live is None else n_live.data_ptr(), B, N, S, K, G,
                hd, pps, float(scale), code, _stream(dev))
    return out


def tree_leaves_per_cta(q, k_pool, n_entries: int, *,
                        pages_per_split: Optional[int] = None) -> int:
    """The leaves one CTA of the tree kernel's split pass serves for a
    call (q (B,H,hd), k_pool (P,S,K,hd) on a CUDA device, ``n_entries``
    covered page-list entries): all B when one CTA's shared memory holds
    every leaf's queries and state, else fewer, and the batch is cut
    into ceil(B / leaves) leaf chunks.  A chunk's CTAs stream the pages
    some leaf of the chunk needs, so a page that leaves of two chunks
    share is read twice.  A query of the kernel's own sizing; it
    launches nothing."""
    B, H, hd = q.shape
    _, S, K, _ = k_pool.shape
    pps = TREE_PAGES_PER_SPLIT if pages_per_split is None \
        else int(pages_per_split)
    pps = max(1, min(pps, n_entries))
    lib = build.load(TREE.name)
    fn = lib.tree_attention_leaves_per_cta
    fn.argtypes, fn.restype = [_I] * 6, _I
    lb = fn(B, S, H // K, hd, pps, _dtype_code(q))
    if lb <= 0:
        raise RuntimeError(f"tree_attention: no leaf fits one CTA at B={B} "
                           f"S={S} G={H // K} hd={hd} ({lb})")
    return lb


FLASH_HEAD_DIMS = (32, 64, 96, 112, 128)   # the kernel's template instances


def flash_prefill(q, k, v, *, scale: float, causal: bool = True,
                  window: int = 0) -> torch.Tensor:
    """Causal flash attention over a right-padded prompt bucket.

    q (B,S,H,hd); k/v (B,S,K,hd) -> (B,S,H,hd).  Right padding plus
    causality keeps padded keys out of every valid query's scores (the
    reference kernel's contract: there is no length operand).
    """
    if _on_cpu(q):
        return flash_prefill_ref(q, k, v, scale=scale, causal=causal,
                                 window=window)
    B, S, H, hd = q.shape
    K = k.shape[2]
    dev, dt = q.device, q.dtype
    code = _dtype_code(q)
    _check("q", q, dev, dt, (B, S, H, hd))
    _check("k", k, dev, dt, (B, S, K, hd))
    _check("v", v, dev, dt, (B, S, K, hd))
    _check_aligned(q, k, v)
    if H % K or H < K or hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_prefill takes G = H/K >= 1 and hd in "
                         f"{FLASH_HEAD_DIMS}, got H={H} K={K} hd={hd}")
    out = torch.empty_like(q)
    FLASH.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, K, H // K, hd, int(bool(causal)), int(window),
                 float(scale), code, _stream(dev))
    return out


# The sampler's draw pass: columns per CTA at most (16 a thread of 256)
# and at least (one a thread); between the two the chunk is cut so that
# the grid holds GUMBEL_CTAS_PER_SM CTAs per SM over all rows.
GUMBEL_MAX_CHUNK = 4096
GUMBEL_MIN_CHUNK = 256
GUMBEL_CTAS_PER_SM = 8


def gumbel_chunk(rows: int, vocab: int, n_sm: int) -> int:
    """Columns each CTA of ``gumbel_sample``'s draw pass takes for a
    (rows, vocab) call on a card of ``n_sm`` SMs: a multiple of 8 (a
    16-byte vector of bf16 logits) in [GUMBEL_MIN_CHUNK,
    GUMBEL_MAX_CHUNK], small enough that rows x ceil(vocab / chunk) CTAs
    fill the card where the call has that many columns."""
    per_row = -(-GUMBEL_CTAS_PER_SM * n_sm // max(rows, 1))
    chunk = -(-vocab // per_row)
    chunk = -(-chunk // 8) * 8
    return max(GUMBEL_MIN_CHUNK, min(GUMBEL_MAX_CHUNK, chunk))


def gumbel_sample(keys, logits: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """One Gumbel-max draw per row: keys (R, 2) uint32 words (numpy or
    anything ``np.asarray`` takes), logits (R, V) float32 or bfloat16,
    contiguous, temperature > 0.  Returns (R,) int32 on the logits'
    device: ``argmax(logits / temperature + gumbel(keys[r], V))`` per row.

    On the CPU: the plain version (``serving.sampler.gumbel_argmax``).  On
    a CUDA device: the draw pass and, when a row spans more than one
    chunk, the merge pass (two launches, one count); the tokens equal the
    plain version's on the same device bit for bit.
    """
    from ..serving import sampler
    if logits.dim() != 2:
        raise ValueError(f"logits must be (rows, vocab), got shape "
                         f"{tuple(logits.shape)}")
    R, V = logits.shape
    if np.shape(keys) != (R, 2):
        raise ValueError(f"{np.shape(keys)} keys for {R} rows")
    code = _dtype_code(logits)
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    if not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    k = sampler.as_keys(keys)
    if _on_cpu(logits):
        return sampler.gumbel_argmax(k, logits, temperature).to(torch.int32)
    dev = logits.device
    out = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return out
    kt = torch.from_numpy(np.ascontiguousarray(k).view(np.int32)).to(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk = gumbel_chunk(R, V, n_sm)
    n_chunks = -(-V // chunk)
    # (value, column) partials of the draw pass: float32 and int32
    part = torch.empty(2 * R * n_chunks, dtype=torch.int32, device=dev)
    # torch scales a float32 CUDA tensor by a Python scalar as a product
    # with the float32 reciprocal: the plain version's logits / T
    inv_t = float(np.float32(1.0) / np.float32(temperature))
    GUMBEL.launch(logits.data_ptr(), kt.data_ptr(), out.data_ptr(),
                  part.data_ptr(), part.data_ptr() + 4 * R * n_chunks, R, V,
                  chunk, n_chunks, inv_t, code, _stream(dev))
    return out
