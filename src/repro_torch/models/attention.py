"""GQA attention with RoPE, qk-norm and sliding window (port of
``repro.models.attention``, dense and encoder paths).

The einsum math here is the plain attention the PRM and the embedder run
(the reference computes them in jnp, not Pallas).  Layouts follow the
reference: q (B,S,H,hd), k/v (B,C,K,hd), GQA groups G = H // K.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import apply_rope, dense_init, matmul, rms_norm, rope_angles

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def attn_init(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(generator, d, cfg.n_heads * hd, dtype),
        "wk": dense_init(generator, d, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(generator, d, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(generator, cfg.n_heads * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=generator.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=generator.device)
    return p


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------

def make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
              window: int = 0, kv_valid: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Boolean attention mask (B, S_q, S_kv) from position arrays.

    q_pos: (B, S_q) absolute positions of queries.
    kv_pos: (B, S_kv) absolute positions of keys (-1 => empty slot).
    window: sliding window size (0 = unlimited).
    """
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    mask = k >= 0
    if causal:
        mask = mask & (k <= q)
    if window:
        mask = mask & (k > q - window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    return mask


# sequences at or above this length use the blocked (flash-style) path in
# attn_full; below it the dense einsum path is used
BLOCKED_ATTN_THRESHOLD = 2048
BLOCK_Q = 512
BLOCK_K = 1024


def masked_attention(q, k, v, mask, *, scale: float) -> torch.Tensor:
    """Plain attention.  q (B,S,H,hd), k/v (B,C,K,hd), mask (B,S,C)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,bckh->bkgsc", qg, k).float() * scale
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsc,bckh->bskgh", probs.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def blocked_attention(q, k, v, q_pos, kv_pos, *, scale: float, causal: bool,
                      window: int = 0, block_q: int = BLOCK_Q,
                      block_k: int = BLOCK_K) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: a loop over KV blocks with
    an online softmax, for each query block.  Never materializes the
    (S_q, S_kv) scores.

    q (B,S,H,hd); k/v (B,C,K,hd); q_pos (B,S); kv_pos (B,C) (-1 = empty).
    """
    B, S, H, hd = q.shape
    C, K = k.shape[1], k.shape[2]
    G = H // K
    bq = min(block_q, S)
    bk = min(block_k, C)
    assert S % bq == 0 and C % bk == 0, (S, bq, C, bk)
    neg = torch.tensor(NEG_INF, device=q.device)
    outs = []
    for q0 in range(0, S, bq):
        qi = q[:, q0:q0 + bq].reshape(B, bq, K, G, hd).float()
        qp = q_pos[:, q0:q0 + bq]
        m = torch.full((B, K, G, bq), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, bq), device=q.device)
        acc = torch.zeros((B, K, G, bq, hd), device=q.device)
        for k0 in range(0, C, bk):
            ki = k[:, k0:k0 + bk].float()
            vi = v[:, k0:k0 + bk].float()
            kp = kv_pos[:, k0:k0 + bk]
            s = torch.einsum("bqkgh,bckh->bkgqc", qi, ki) * scale
            ok = kp[:, None, :] >= 0
            if causal:
                ok = ok & (kp[:, None, :] <= qp[:, :, None])
            if window:
                ok = ok & (kp[:, None, :] > qp[:, :, None] - window)
            okb = ok[:, None, None]
            s = torch.where(okb, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(okb, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckh->bkgqh", p, vi)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,K,G,bq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))           # (B,bq,K,G,hd)
    return torch.cat(outs, dim=1).reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _project_qkv(p, x, cfg, positions):
    """Project + rope.  positions: (B,S)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = matmul(x, p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = matmul(x, p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = matmul(x, p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if cfg.n_heads > 0:
        ang = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    return q, k, v


def attn_full(p, x, cfg, positions) -> torch.Tensor:
    """Whole-sequence attention (PRM / encoder).  Returns y (B,S,d)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    window = cfg.sliding_window
    if S >= BLOCKED_ATTN_THRESHOLD:
        y = blocked_attention(q, k, v, positions, positions,
                              causal=cfg.causal, window=window,
                              scale=cfg.head_dim ** -0.5)
    else:
        mask = make_mask(positions, positions, causal=cfg.causal,
                         window=window)
        y = masked_attention(q, k, v, mask, scale=cfg.head_dim ** -0.5)
    return matmul(y.reshape(B, S, -1), p["wo"])
