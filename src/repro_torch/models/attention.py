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

from .layers import (_ContiguousGrad, apply_rope, dense_init, matmul,
                     on_mesh, rms_norm, rope_angles)

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
# the blocks of the DTensor path (the dry run, which counts operations
# and never computes): the same FLOPs in 64x fewer block steps than at
# BLOCK_Q x BLOCK_K, each step's scores (4096 x 4096 per head) held
SHARDED_BLOCK = 4096


def masked_attention(q, k, v, mask, *, scale: float) -> torch.Tensor:
    """Plain attention.  q (B,S,H,hd), k/v (B,C,K,hd), mask (B,S,C)."""
    if hasattr(q, "device_mesh"):
        return _sharded_masked_attention(q, k, v, mask, scale=scale)
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


def _sharded_masked_attention(q, k, v, mask, *, scale: float):
    """``masked_attention`` on DTensors (the dry run's decode against a
    cache whose sequence shards over ``model``, the serve policy):
    flash-decoding inside ``local_map``.  Each rank scores its batch rows
    against its slice of the cache, and the softmax max, denominator and
    weighted values combine over the ``model`` group with all-reduces."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    m_i = names.index("model")
    split = k.shape[1] % mesh.size(m_i) == 0
    group = mesh.get_group("model")
    # rows follow the cache's own batch sharding (re-sharding a cache's
    # rows over other mesh dims would gather it)
    if isinstance(k, DTensor):
        rows = [k.placements[i].is_shard(0) for i in range(len(names))]
    else:
        n_dp = 1
        for i in range(len(names)):
            n_dp *= mesh.size(i) if i != m_i else 1
        rows = [q.shape[0] % n_dp == 0] * len(names)

    def plc(seq_dim):
        return tuple((Shard(seq_dim) if split and seq_dim is not None
                      else Replicate()) if i == m_i else
                     (Shard(0) if rows[i] else Replicate())
                     for i in range(len(names)))

    def local(ql, kl, vl, ml):
        B, S, H, hd = ql.shape
        K = kl.shape[2]
        qg = ql.reshape(B, S, K, H // K, hd)
        s = torch.einsum("bskgh,bckh->bkgsc", qg, kl).float() * scale
        s = torch.where(ml[:, None, None], s,
                        torch.tensor(NEG_INF, device=s.device))
        m = s.amax(dim=-1)
        if split:
            m = all_reduce(m, "max", group)
        p = torch.exp(s - m[..., None])
        l = p.sum(dim=-1)
        acc = torch.einsum("bkgsc,bckh->bskgh", p.to(vl.dtype), vl).float()
        if split:
            l = all_reduce(l, "sum", group)
            acc = all_reduce(acc, "sum", group)
        l = l.permute(0, 3, 1, 2)[..., None]                # (B,S,K,G,1)
        return (acc / l).reshape(B, S, H, hd).to(ql.dtype)

    fn = local_map(local, out_placements=list(plc(None)),
                   in_placements=(plc(None), plc(1), plc(1), plc(2)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*(on_mesh(t, mesh) for t in (q, k, v, mask)))


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

def _split_heads(t, B, S, n_heads, hd):
    """(B, S, n_heads*hd) -> (B, S, n_heads, hd).  A DTensor whose last
    dim is sharded over a mesh dim that does not divide the heads (GQA
    K/V heads fewer than the ``model`` dim) is replicated over that mesh
    dim first: DTensor cannot split a sharded dim unevenly."""
    if hasattr(t, "device_mesh"):
        mesh = t.device_mesh
        plc = list(t.placements)
        bad = [i for i, pl in enumerate(plc)
               if pl.is_shard(t.ndim - 1) and n_heads % mesh.size(i)]
        if bad:
            from torch.distributed.tensor import Replicate
            for i in bad:
                plc[i] = Replicate()
            t = t.redistribute(mesh, plc)
    return t.reshape(B, S, n_heads, hd)


def _project_qkv(p, x, cfg, positions):
    """Project + rope.  positions: (B,S), or (3,B,S) for M-RoPE."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = _split_heads(matmul(x, p["wq"]), B, S, cfg.n_heads, hd)
    k = _split_heads(matmul(x, p["wk"]), B, S, cfg.n_kv_heads, hd)
    v = _split_heads(matmul(x, p["wv"]), B, S, cfg.n_kv_heads, hd)
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
    if hasattr(q, "device_mesh"):
        return _sharded_self_attention(q, k, v, pos2d, cfg, window)
    if q.shape[1] >= BLOCKED_ATTN_THRESHOLD:
        return blocked_attention(q, k, v, pos2d, pos2d, causal=cfg.causal,
                                 window=window, scale=cfg.head_dim ** -0.5)
    mask = make_mask(pos2d, pos2d, causal=cfg.causal, window=window)
    return masked_attention(q, k, v, mask, scale=cfg.head_dim ** -0.5)


def _sharded_self_attention(q, k, v, pos2d, cfg, window: int):
    """``_self_attention`` on DTensors (the dry run): each rank attends
    its own batch rows and query heads, inside ``local_map`` (the
    reference's GSPMD partitions the same einsums), long sequences in
    ``SHARDED_BLOCK`` blocks.  Batch shards over
    the data dims; query heads over ``model`` where they divide it and
    whole GQA groups stay on a rank; K/V heads shard with them where
    every rank holds whole K/V heads, else K/V replicate over ``model``
    and each rank slices the heads its queries read."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    B, H, K = q.shape[0], q.shape[2], k.shape[2]
    G = H // K
    msize = mesh.size(names.index("model"))
    n_dp = 1
    for i, n in enumerate(names):
        n_dp *= mesh.size(i) if n != "model" else 1
    rows = B % n_dp == 0
    Hl = H // msize
    heads = H % msize == 0 and (Hl % G == 0 or G % Hl == 0)
    kv_heads = heads and Hl % G == 0

    def plc(head_dim):
        return tuple((Shard(head_dim) if head_dim is not None else
                      Replicate()) if n == "model" else
                     (Shard(0) if rows else Replicate()) for n in names)

    q_plc = plc(2 if heads else None)
    kv_plc = plc(2 if kv_heads else None)

    def local(ql, kl, vl, pl):
        ql, kl, vl = (_ContiguousGrad.apply(t) for t in (ql, kl, vl))
        if heads and not kv_heads:          # this rank's query heads
            h0 = mesh.get_local_rank("model") * Hl
            kl = kl[:, :, h0 // G:(h0 + Hl - 1) // G + 1]
            vl = vl[:, :, h0 // G:(h0 + Hl - 1) // G + 1]
        if ql.shape[1] >= BLOCKED_ATTN_THRESHOLD:
            out = blocked_attention(
                ql, kl, vl, pl, pl, causal=cfg.causal, window=window,
                scale=cfg.head_dim ** -0.5, block_q=SHARDED_BLOCK,
                block_k=SHARDED_BLOCK)
        else:
            out = _self_attention(ql, kl, vl, pl, cfg, window)
        return _ContiguousGrad.apply(out)

    fn = local_map(local, out_placements=list(q_plc),
                   in_placements=(q_plc, kv_plc, kv_plc, plc(None)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v, on_mesh(pos2d, mesh))


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

    take = min(S, cache_len)
    ring = bool(cfg.sliding_window) and cache_len <= cfg.sliding_window
    if ring or S != cache_len:
        cache = init_kv_cache(cfg, B, cache_len, cache_dtype,
                              device=x.device)
    if ring:
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
    elif S == cache_len:
        # the prompt fills the cache: K/V themselves, no zeros to copy
        # into (nor, on DTensors, a replicated cache)
        cache = {"k": k.to(cache_dtype), "v": v.to(cache_dtype),
                 "pos": pos2d.to(torch.int32)}
    else:
        cache["k"][:, :take] = k[:, :take].to(cache_dtype)
        cache["v"][:, :take] = v[:, :take].to(cache_dtype)
        cache["pos"][:, :take] = pos2d[:, :take]
    return y, cache


def _where(cond, new, leaf):
    """``torch.where(cond, new, leaf)`` for a cache write.  On a DTensor
    cache (the dry run) the condition and the new values are laid out as
    the cache first, where their dims are the cache's (broadcast dims
    replicate), so the write stays on each rank's shard instead of
    DTensor gathering the cache."""
    if hasattr(leaf, "device_mesh"):
        from torch.distributed.tensor import Replicate, Shard
        mesh = leaf.device_mesh

        def follow(t):
            return on_mesh(t, mesh).redistribute(mesh, [
                p if isinstance(p, Shard) and t.shape[p.dim] ==
                leaf.shape[p.dim] else Replicate() for p in leaf.placements])
        cond, new = follow(cond), follow(new)
    return torch.where(cond, new, leaf)


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
            return {"q": _where(oh4, nq[:, None], leaf["q"]),
                    "s": _where(oh4, ns[:, None], leaf["s"])}
        return _where(oh4, new[:, None].to(leaf.dtype), leaf)

    kc = write(cache["k"], k[:, 0])
    vc = write(cache["v"], v[:, 0])
    pc = _where(oh, write_pos[:, None].to(cache["pos"].dtype), cache["pos"])
    mask = make_mask(write_pos[:, None], pc, causal=cfg.causal,
                     window=cfg.sliding_window)
    y = masked_attention(q, _kv_resolve(kc, q.dtype),
                         _kv_resolve(vc, q.dtype), mask,
                         scale=cfg.head_dim ** -0.5)
    y = matmul(y.reshape(B, 1, -1), p["wo"])
    return y, {"k": kc, "v": vc, "pos": pc}
