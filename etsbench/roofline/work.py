"""The work one kernel call asks for, and the least time the card needs
for it: the yardstick of the kernels' roofline shares.

A call's work is what its inputs need, whatever kernel implements it:
every input byte read once, every output byte written once, and the
operations of the function itself.  A kernel that reads a page twice,
or computes padded rows, spends more than this and shows a lower share.

``tree_call`` counts a tree-attention decode call from the host-side
metadata that drives it: q of the rows that attend anything, every live
K/V page's valid slots once, the page list / mask / lengths of the live
entries, and the output; operations 4 * heads * head_dim per (row,
attended token), each row attending its own ancestry.

``flash_call`` counts a causal prefill call on the rows' unpadded
lengths: q, k, v read once and the output written once for the valid
tokens; operations 4 * heads * head_dim * n (n + 1) / 2 per row of n
tokens.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def tree_call(page_mask: np.ndarray, page_lens: np.ndarray, n_live: int,
              n_heads: int, n_kv_heads: int, head_dim: int,
              el_bytes: int) -> Tuple[int, int]:
    """(bytes, operations) of one tree-attention call."""
    mask = np.asarray(page_mask[:n_live], dtype=np.int64)
    lens = np.asarray(page_lens[:n_live], dtype=np.int64)
    rows = int(mask.any(axis=0).sum())
    kv = int(lens.sum()) * n_kv_heads * head_dim * 2 * el_bytes
    q_out = 2 * rows * n_heads * head_dim * el_bytes
    meta = n_live * (4 + 4 + mask.shape[1])
    flops = 4 * n_heads * head_dim * int((mask.sum(axis=1) * lens).sum())
    return kv + q_out + meta, flops


def flash_call(lengths: Sequence[int], n_heads: int, n_kv_heads: int,
               head_dim: int, el_bytes: int) -> Tuple[int, int]:
    """(bytes, operations) of one causal prefill call over rows of the
    given valid lengths."""
    n = np.asarray(lengths, dtype=np.int64)
    nbytes = int(n.sum()) * (2 * n_heads + 2 * n_kv_heads) * head_dim \
        * el_bytes
    flops = 4 * n_heads * head_dim * int((n * (n + 1) // 2).sum())
    return nbytes, flops


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """Least seconds the card needs: bytes at peak bandwidth or
    operations at the dtype's peak rate, whichever is longer."""
    return max(nbytes / PEAKS["bytes_per_s"],
               flops / PEAKS["flops_per_s"][dtype])
