"""Plain PyTorch versions of the three attention kernels.

Each is the CPU path of its kernel's wrapper (``kernels/ops.py``) and the
oracle the CUDA kernel is held against on the card.  They compute what
``repro.kernels.ref`` computes, in float32.
"""
from __future__ import annotations

import torch

from ..kvcache.pool import NEG_INF, paged_attention_ref  # noqa: F401


def tree_attention_ref(q, k_pool, v_pool, page_list, page_mask, page_lens,
                       *, scale: float) -> torch.Tensor:
    """Oracle for the tree decode kernel.

    q (B,H,hd); k/v_pool (P,S,K,hd); page_list (N,); page_mask (N,B);
    page_lens (N,).  Leaf b attends to all valid slots of pages with
    page_mask[n, b] — softmax over the union.  Zero-length (dump) page
    entries contribute nothing, and a fully-masked batch row yields an
    all-zero output.
    """
    B, H, hd = q.shape
    P, S, K, _ = k_pool.shape
    N = page_list.shape[0]
    G = H // K
    dev = q.device
    pl = page_list.long()
    kk = k_pool[pl].reshape(N * S, K, hd)
    vv = v_pool[pl].reshape(N * S, K, hd)
    slot_ok = (torch.arange(S, device=dev)[None, :]
               < page_lens.long()[:, None])                 # (N, S)
    ok = page_mask.bool()[:, None, :] & slot_ok[:, :, None]  # (N, S, B)
    ok = ok.reshape(N * S, B).T                             # (B, N*S)
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgh,ckh->bkgc", qg, kk.float()) * scale
    okb = ok[:, None, None, :]
    s = torch.where(okb, s, torch.tensor(NEG_INF, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(okb, torch.exp(s - m), 0.0)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgc,ckh->bkgh", p, vv.float())
    return out.reshape(B, H, hd).to(q.dtype)


def tree_attention_split_ref(q, k_pool, v_pool, page_list, page_mask,
                             page_lens, *, scale: float,
                             pages_per_split: int) -> torch.Tensor:
    """The tree kernel's split + combine arithmetic in plain PyTorch (a
    model for the tests; the wrapper's CPU path is ``tree_attention_ref``).

    Split s covers entries [s * pages_per_split, (s + 1) *
    pages_per_split) of ``page_list`` and keeps, for each (leaf, head),
    the max m, the sum l of exp(score - m) and acc = sum exp(score - m)
    * v over the slots the leaf attends in the split.  A leaf with no
    live masked entry in a split has no partial.  The combine merges a
    leaf's partials in split order with log-sum-exp rescaling and
    returns acc / max(l, 1e-30), so a fully masked row is exactly zero.
    """
    if pages_per_split < 1:
        raise ValueError(f"pages_per_split must be >= 1, got "
                         f"{pages_per_split}")
    B, H, hd = q.shape
    P, S, K, _ = k_pool.shape
    N = page_list.shape[0]
    G = H // K
    dev = q.device
    pps = min(int(pages_per_split), max(N, 1))
    n_splits = -(-N // pps)
    pad = n_splits * pps - N
    pl = torch.nn.functional.pad(page_list.long(), (0, pad))
    lens = torch.nn.functional.pad(page_lens.long(), (0, pad))
    mask = torch.nn.functional.pad(page_mask.bool(), (0, 0, 0, pad))
    kk = k_pool[pl].float().reshape(n_splits, pps * S, K, hd)
    vv = v_pool[pl].float().reshape(n_splits, pps * S, K, hd)
    slot_ok = torch.arange(S, device=dev)[None, :] < lens[:, None]
    ok = mask[:, None, :] & slot_ok[:, :, None]             # (Np, S, B)
    ok = ok.reshape(n_splits, pps * S, B).permute(2, 0, 1)  # (B, n, C)
    okb = ok[:, None, None]                                 # (B,1,1,n,C)
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgh,nckh->bkgnc", qg, kk) * scale
    s = torch.where(okb, s, torch.tensor(NEG_INF, device=dev))
    m = s.amax(dim=-1)                                      # (B,K,G,n)
    p = torch.where(okb, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnc,nckh->bkgnh", p, vv)
    hit = ok.any(dim=-1)                                    # (B, n)
    M = torch.full((B, K, G), NEG_INF, device=dev)
    L = torch.zeros((B, K, G), device=dev)
    A = torch.zeros((B, K, G, hd), device=dev)
    for i in range(n_splits):
        h = hit[:, i][:, None, None]
        m_new = torch.where(h, torch.maximum(M, m[..., i]), M)
        c_old, c_new = torch.exp(M - m_new), torch.exp(m[..., i] - m_new)
        L = torch.where(h, L * c_old + l[..., i] * c_new, L)
        A = torch.where(h[..., None], A * c_old[..., None]
                        + acc[..., i, :] * c_new[..., None], A)
        M = m_new
    out = A / torch.clamp(L, min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def flash_prefill_ref(q, k, v, *, scale: float, causal: bool = True,
                      window: int = 0) -> torch.Tensor:
    """Oracle for the prefill kernel.  q/k/v (B, S, H|K, hd); causal
    (optionally windowed) attention over the whole bucket, in float32."""
    return _flash(q, k, v, scale, causal, window, torch.float32)


def flash_prefill_f64(q, k, v, *, scale: float, causal: bool = True,
                      window: int = 0) -> torch.Tensor:
    """The same function computed in float64 from the same inputs: the
    yardstick both the kernel and ``flash_prefill_ref`` are held to on
    long buckets.  Returns float64."""
    return _flash(q, k, v, scale, causal, window, torch.float64)


def _flash(q, k, v, scale, causal, window, dt) -> torch.Tensor:
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    dev = q.device
    qg = q.reshape(B, S, K, G, hd).to(dt)
    s = torch.einsum("bskgh,bckh->bkgsc", qg, k.to(dt)) * scale
    qpos = torch.arange(S, device=dev)[:, None]
    kpos = torch.arange(S, device=dev)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=dt, device=dev))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgsc,bckh->bskgh", p, v.to(dt))
    out = out.reshape(B, S, H, hd)
    return out.to(q.dtype) if dt == torch.float32 else out
