"""Dispatch seam of the attention kernels (port of ``repro.kernels.ops``).

Each wrapper takes the plain PyTorch version (``ref.py``) for tensors on
the CPU, and for tensors on a CUDA device launches the hand-written
kernel from ``csrc/`` or raises — it never falls back.  The kernel runs
on ``torch.cuda.current_stream()``, allocates nothing itself (the
wrapper allocates the output), and the wrapper raises if the launch
reports an error.

Every kernel keeps a plain launch counter (``Kernel.launches``), raised
by one where its wrapper launches it and nowhere else, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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


PAGED = Kernel("paged_attention", [_P] * 6 + [_I] * 6 + [_F, _I, _P],
               "src/repro/kernels/paged_attention.py:116")
TREE = Kernel("tree_attention", [_P] * 10 + [_I] * 7 + [_F, _I, _P],
              "src/repro/kernels/tree_attention.py:217")
FLASH = Kernel("flash_prefill", [_P] * 4 + [_I] * 7 + [_F, _I, _P],
               "src/repro/kernels/flash_prefill.py:98")
KERNELS = (PAGED, TREE, FLASH)


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

def paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                    scale: float) -> torch.Tensor:
    """q (B,H,hd); k/v_pool (P,S,K,hd); block_tables (B,T) int32 (-1
    pad); lengths (B,) int32.  Returns (B,H,hd) in q's dtype."""
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
    if H % K or not 1 <= H // K <= 32 or hd > 256:
        raise ValueError(f"paged_attention takes G = H/K in 1..32 and "
                         f"hd <= 256, got H={H} K={K} hd={hd}")
    out = torch.empty_like(q)
    PAGED.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 B, K, H // K, hd, S, T, float(scale), code, _stream(dev))
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
                   n_live: Optional[int] = None) -> torch.Tensor:
    """q (B,H,hd); k/v_pool (P,S,K,hd); page_list (N,) int32; page_mask
    (N,B) int8; page_lens (N,) int32.  Returns (B,H,hd).

    ``pages_per_split`` is the split pass's page run per CTA (None =
    ``TREE_PAGES_PER_SPLIT``).  ``n_live``, when the caller knows it on
    the host, is the count of leading ``page_list`` entries that may be
    live (every later entry must be a zero-length dump entry); the grid
    then covers only those.  Neither changes the result.
    """
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
    n_cover = N if n_live is None else max(0, min(int(n_live), N))
    pps = max(1, min(pps, n_cover))
    n_splits = -(-n_cover // pps)
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
                base + acc_bytes + ml_bytes, B, n_cover, S, K, G, hd, pps,
                float(scale), code, _stream(dev))
    return out


FLASH_HEAD_DIMS = (32, 64, 96, 128)    # the kernel's template instances


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
