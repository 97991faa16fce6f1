"""Device-side paged KV pool (port of ``repro.kvcache.pool``).

Layout: ``k, v: (n_layers, n_pages, page_size, n_kv_heads, head_dim)``.
Unlike the reference's functional ``.at[]`` updates, writes and
copy-on-write copies here go **in place** into the pool tensors: the
engine owns the only reference, so no copy of the pool is ever needed.

Also holds ``paged_attention_ref``, the plain PyTorch version of the
paged decode kernel (its CPU path and its oracle on the card).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .allocator import CopyOp

NEG_INF = -1e30


def pow2_bucket(n: int, lo: int = 8) -> int:
    """Smallest power-of-two >= n (at least ``lo``) — the padding bucket.

    Host-built axes that vary across calls (prefill token/row counts,
    PRM batch/length, tree-step page counts) are padded to these buckets,
    so a run sees O(log max_size) distinct shapes.
    """
    b = lo
    while b < n:
        b *= 2
    return b


class KVPool:
    def __init__(self, n_layers: int, n_pages: int, page_size: int,
                 n_kv_heads: int, head_dim: int, *, dtype=torch.float32,
                 device):
        self.n_layers = n_layers
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
        self.shape = shape
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)

    def write_tokens(self, layer_k: torch.Tensor, layer_v: torch.Tensor,
                     pages: torch.Tensor, slots: torch.Tensor) -> None:
        """Write B new tokens across all layers, in place.

        layer_k/v: (L, B, K, hd) — per-layer K/V of the new tokens.
        pages, slots: (B,) physical page + in-page slot per token.
        """
        self.k[:, pages, slots] = layer_k.to(self.k.dtype)
        self.v[:, pages, slots] = layer_v.to(self.v.dtype)

    def copy_pages(self, ops: Sequence[CopyOp]) -> None:
        """Execute CoW copies (partial page duplication), in place."""
        if not ops:
            return
        dev = self.k.device
        src = torch.tensor([o.src_page for o in ops], device=dev)
        dst = torch.tensor([o.dst_page for o in ops], device=dev)
        # copying the whole page is safe: slots beyond n_valid are dead
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]


# ---------------------------------------------------------------------------
# Plain paged attention — oracle and CPU path of kernels/csrc/paged_attention
# ---------------------------------------------------------------------------

def paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                        scale: float) -> torch.Tensor:
    """Decode attention over a paged pool.

    q            : (B, H, hd)       one query token per sequence
    k_pool/v_pool: (P, S, K, hd)    single layer's pool
    block_tables : (B, T) int32     padded with -1
    lengths      : (B,) int32       context length per sequence
    Returns (B, H, hd).

    A row with no valid slots (all-(-1) table / zero length — an inactive
    batch row) returns zeros via masked normalization rather than a
    softmax over an empty set.
    """
    B, H, hd = q.shape
    P, S, K, _ = k_pool.shape
    T = block_tables.shape[1]
    G = H // K
    dev = q.device
    flat_k = k_pool.reshape(P * S, K, hd)
    flat_v = v_pool.reshape(P * S, K, hd)
    bt = block_tables.long()
    safe = torch.clamp(bt, min=0)
    idx = (safe[:, :, None] * S
           + torch.arange(S, device=dev)[None, None, :]).reshape(B, T * S)
    kk = flat_k[idx]                                    # (B, T*S, K, hd)
    vv = flat_v[idx]
    valid = (torch.arange(T * S, device=dev)[None, :]
             < lengths.long()[:, None]) \
        & (bt[:, :, None] >= 0).expand(B, T, S).reshape(B, T * S)
    qg = q.reshape(B, K, G, hd)
    scores = torch.einsum("bkgh,bckh->bkgc", qg.float(), kk.float()) * scale
    vb = valid[:, None, None]
    scores = torch.where(vb, scores, torch.tensor(NEG_INF, device=dev))
    m = scores.amax(dim=-1, keepdim=True)
    probs = torch.where(vb, torch.exp(scores - m), 0.0)
    probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgc,bckh->bkgh", probs, vv.float())
    return out.reshape(B, H, hd).to(q.dtype)
