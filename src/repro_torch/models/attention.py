"""GQA attention with RoPE (M-RoPE for the VLM), qk-norm, sliding
window and contiguous KV caches (port of ``repro.models.attention``).

Three entry modes, as in the reference:
  * ``attn_full``    — whole-sequence attention (training / encoder /
                       the PRM and the embedder).
  * ``attn_prefill`` — whole-sequence attention that also fills a
                       contiguous KV cache of ``cache_len`` slots.
  * ``attn_decode``  — one new token per sequence against such a cache,
                       with per-sequence write positions.  Sliding-window
                       archs use a ring cache of ``window`` slots
                       (absolute positions are stored beside K/V, so
                       masking stays exact); ``init_kv_cache(quant=True)``
                       stores K/V as int8 with per-token, per-head scales.

The einsum math here is plain attention (the reference computes these
paths in jnp, not Pallas; the paged engine's kernels live in
``repro_torch.kernels``).  Layouts follow the reference: q (B,S,H,hd),
k/v (B,C,K,hd), GQA groups G = H // K.
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
    """Project + rope.  positions: (B,S), or (3,B,S) for M-RoPE."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = matmul(x, p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = matmul(x, p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = matmul(x, p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if cfg.n_heads > 0:
        ang = rope_angles(positions, hd, cfg.rope_theta, cfg.mrope_sections)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    return q, k, v


def _self_attention(q, k, v, pos2d, cfg, window: int) -> torch.Tensor:
    """q/k/v of one sequence attending to itself: blocked from
    ``BLOCKED_ATTN_THRESHOLD`` tokens on, dense einsum below."""
    if q.shape[1] >= BLOCKED_ATTN_THRESHOLD:
        return blocked_attention(q, k, v, pos2d, pos2d, causal=cfg.causal,
                                 window=window, scale=cfg.head_dim ** -0.5)
    mask = make_mask(pos2d, pos2d, causal=cfg.causal, window=window)
    return masked_attention(q, k, v, mask, scale=cfg.head_dim ** -0.5)


def attn_full(p, x, cfg, positions, *,
              window_override: Optional[int] = None) -> torch.Tensor:
    """Whole-sequence attention (train / PRM / encoder).  positions
    (B,S), or (3,B,S) for M-RoPE, whose masks use stream 0;
    ``window_override`` replaces ``cfg.sliding_window`` (long mode).
    Returns y (B,S,d)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    pos2d = positions if positions.dim() == 2 else positions[0]
    window = cfg.sliding_window if window_override is None \
        else window_override
    y = _self_attention(q, k, v, pos2d, cfg, window)
    return matmul(y.reshape(B, S, -1), p["wo"])


# ---------------------------------------------------------------------------
# Contiguous KV cache: prefill and one-token decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
                  quant: bool = False, device=None) -> dict:
    """Empty cache: K/V zeros, positions -1 (empty slot).  SWA archs may
    pass ``cache_len=window`` (a ring).  ``quant=True``: K/V as symmetric
    int8 ``{"q", "s"}`` with one float32 scale per token and head."""
    shp = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    pos = torch.full((batch, cache_len), -1, dtype=torch.int32,
                     device=device)
    if quant:
        sshp = shp[:-1] + (1,)

        def leaf():
            return {"q": torch.zeros(shp, dtype=torch.int8, device=device),
                    "s": torch.zeros(sshp, dtype=torch.float32,
                                     device=device)}

        return {"k": leaf(), "v": leaf(), "pos": pos}
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device),
            "pos": pos}


def _kv_quantize(x: torch.Tensor):
    """x (..., hd) -> (int8 q, float32 s) with s shaped (..., 1).  The
    division is float32 and ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    x = x.float()
    amax = torch.amax(x.abs(), dim=-1, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def _kv_resolve(c, dtype=torch.float32) -> torch.Tensor:
    """Cache leaf -> dense tensor (dequantized if int8)."""
    if isinstance(c, dict):
        return c["q"].to(dtype) * c["s"].to(dtype)
    return c


def attn_prefill(p, x, cfg, positions, cache_len: int,
                 cache_dtype=torch.bfloat16):
    """Full attention + a cache of the (possibly windowed) prompt.
    Returns (y (B,S,d), cache).

    Masks use ``cfg.sliding_window`` (not a long-mode window), and the
    cache is never quantized, as in the reference.  With a window and
    ``cache_len <= window`` the cache is a ring holding the last
    ``cache_len`` tokens at slot ``pos % cache_len``; otherwise it holds
    the first ``min(S, cache_len)`` tokens from slot 0."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    pos2d = positions if positions.dim() == 2 else positions[0]
    y = _self_attention(q, k, v, pos2d, cfg, cfg.sliding_window)
    y = matmul(y.reshape(B, S, -1), p["wo"])

    cache = init_kv_cache(cfg, B, cache_len, cache_dtype, device=x.device)
    take = min(S, cache_len)
    if cfg.sliding_window and cache_len <= cfg.sliding_window:
        # Ring: the reference writes through a one-hot contraction (so
        # SPMD can partition it); a scatter-add by index onto the zero
        # cache gives the same values, colliding slots summed as the
        # contraction sums them.
        ks, vs, ps = k[:, -take:], v[:, -take:], pos2d[:, -take:]
        slots = (ps % cache_len).long()                  # (B, take)
        idx = slots[:, :, None, None].expand_as(ks)
        cache["k"] = cache["k"].scatter_add(1, idx, ks.to(cache_dtype))
        cache["v"] = cache["v"].scatter_add(1, idx, vs.to(cache_dtype))
        written = torch.zeros((B, cache_len), dtype=torch.bool,
                              device=x.device).scatter(1, slots, True)
        pos_val = torch.zeros((B, cache_len), device=x.device).scatter_add(
            1, slots, ps.float()).to(torch.int32)
        cache["pos"] = torch.where(written, pos_val, cache["pos"])
    else:
        cache["k"][:, :take] = k[:, :take].to(cache_dtype)
        cache["v"][:, :take] = v[:, :take].to(cache_dtype)
        cache["pos"][:, :take] = pos2d[:, :take]
    return y, cache


def attn_decode(p, x, cfg, cache, write_pos):
    """One-token decode.  x (B,1,d); write_pos (B,) absolute positions.
    Returns (y (B,1,d), new cache); the cache given is not modified.

    The slot is ``write_pos % C`` when the cache is a window ring
    (``cfg.sliding_window`` and ``C <= window``), else ``write_pos``; a
    slot past the cache's end writes nothing, as the reference's one-hot
    write.  int8 caches quantize the new token's K/V."""
    B = x.shape[0]
    quantized = isinstance(cache["k"], dict)
    C = (cache["k"]["q"] if quantized else cache["k"]).shape[1]
    if cfg.mrope_sections:
        positions = write_pos[None, :, None].expand(3, B, 1)
    else:
        positions = write_pos[:, None]
    q, k, v = _project_qkv(p, x, cfg, positions)

    windowed = bool(cfg.sliding_window) and C <= cfg.sliding_window
    slots = (write_pos % C) if windowed else write_pos
    oh = slots[:, None] == torch.arange(C, device=x.device)[None, :]
    oh4 = oh[:, :, None, None]                           # (B, C, 1, 1)

    def write(leaf, new):
        """Put new (B, K, hd) into leaf at the one-hot slot."""
        if isinstance(leaf, dict):
            nq, ns = _kv_quantize(new)
            return {"q": torch.where(oh4, nq[:, None], leaf["q"]),
                    "s": torch.where(oh4, ns[:, None], leaf["s"])}
        return torch.where(oh4, new[:, None].to(leaf.dtype), leaf)

    kc = write(cache["k"], k[:, 0])
    vc = write(cache["v"], v[:, 0])
    pc = torch.where(oh, write_pos[:, None].to(cache["pos"].dtype),
                     cache["pos"])
    mask = make_mask(write_pos[:, None], pc, causal=cfg.causal,
                     window=cfg.sliding_window)
    y = masked_attention(q, _kv_resolve(kc, q.dtype),
                         _kv_resolve(vc, q.dtype), mask,
                         scale=cfg.head_dim ** -0.5)
    y = matmul(y.reshape(B, 1, -1), p["wo"])
    return y, {"k": kc, "v": vc, "pos": pc}
