"""RWKV6 ("Finch") mixer — data-dependent per-channel decay WKV (port of
``repro.models.rwkv6``).

Recurrence per head (key dim == value dim == hd):
    wkv_t = S_{t-1} + diag(u) k_t v_t^T          (bonus for current token)
    y_t   = r_t^T wkv_t                          (1 x hd)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T        (w_t in (0,1), per channel)

w_t derives from the token-shifted input through a low-rank MLP; r/k/v/g
use learned token-shift mixing with full-rank projections, as in the
reference.

Chunked evaluation for prefill: a loop over chunks of Q tokens; within a
chunk the pairwise term uses the factorized q' = r * exp(cumw_{t-1}),
k' = k * exp(-cumw_j) trick.  The per-step log-decay is clamped to
>= LOG_W_MIN in both the chunked path and the recurrent oracle, so they
agree.  The reference computes this in plain jnp (no Pallas kernel), and
so does the port, in plain PyTorch.

State per layer: S (B,H,hd,hd) float32 + token-shift tail x_prev (B,2,d)
(index 0: time-mix shift, 1: channel-mix shift).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, group_norm_heads, per_rank

LOG_W_MIN = -2.0  # per-step decay floor (see module docstring)


def _dims(cfg):
    hd = cfg.ssm.head_dim
    H = cfg.d_model // hd
    return H, hd


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def rwkv_init(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """Fresh time-mix params (the reference's shapes and scales; another
    random stream)."""
    d = cfg.d_model
    H, hd = _dims(cfg)
    dev = generator.device
    lora = max(32, d // 64)
    mu = torch.rand((5, d), generator=generator, device=dev) * 0.5 + 0.25
    u = torch.randn((H, hd), generator=generator, device=dev) * 0.1
    return {
        "mu": mu.to(dtype),
        "wr": dense_init(generator, d, d, dtype),
        "wk": dense_init(generator, d, d, dtype),
        "wv": dense_init(generator, d, d, dtype),
        "wg": dense_init(generator, d, d, dtype),
        "wo": dense_init(generator, d, d, dtype),
        "w1": dense_init(generator, d, lora, dtype),
        "w2": dense_init(generator, lora, d, dtype, scale=0.1),
        "w_bias": torch.full((d,), -0.5, device=dev),
        "u": u,
        "gn_w": torch.ones((d,), dtype=dtype, device=dev),
        "gn_b": torch.zeros((d,), dtype=dtype, device=dev),
    }


def init_rwkv_state(cfg, batch: int, dtype=torch.float32,
                    device=None) -> dict:
    H, hd = _dims(cfg)
    return {
        "S": torch.zeros((batch, H, hd, hd), dtype=dtype, device=device),
        "x_prev": torch.zeros((batch, 2, cfg.d_model), dtype=dtype,
                              device=device),
    }


# ---------------------------------------------------------------------------
# Shared projections
# ---------------------------------------------------------------------------

def _proj(p, x, x_shift, cfg):
    """x, x_shift: (B,T,d).  Returns r,k,v (B,T,H,hd), g (B,T,d), logw
    (B,T,H,hd) float32."""
    H, hd = _dims(cfg)
    B, T, d = x.shape

    def mix(i):
        mu = p["mu"][i].to(x.dtype)
        return x * mu + x_shift * (1.0 - mu)

    r = (mix(0) @ p["wr"].to(x.dtype)).reshape(B, T, H, hd)
    k = (mix(1) @ p["wk"].to(x.dtype)).reshape(B, T, H, hd)
    v = (mix(2) @ p["wv"].to(x.dtype)).reshape(B, T, H, hd)
    g = F.silu(mix(3) @ p["wg"].to(x.dtype))
    dd = torch.tanh(mix(4).float() @ p["w1"].float()) @ p["w2"].float()
    logw = -torch.exp(torch.clamp(dd + p["w_bias"], -6.0, 2.0))  # < 0
    logw = torch.clamp(logw, LOG_W_MIN, -1e-4).reshape(B, T, H, hd)
    return r, k, v, g, logw


def _finish(p, y, g, cfg):
    """y: (B,T,H,hd) float32 -> output projection with group-norm + gate."""
    H, hd = _dims(cfg)
    B, T = y.shape[:2]
    y = y.reshape(B, T, H * hd).to(g.dtype)
    y = group_norm_heads(p["gn_w"], p["gn_b"], y, H, cfg.norm_eps)
    return (y * g) @ p["wo"].to(g.dtype)


# ---------------------------------------------------------------------------
# Chunked scan (prefill)
# ---------------------------------------------------------------------------

def _wkv_chunk(S, r, k, v, logw, u):
    """One chunk.  S: (B,H,hd,hd) float32; r,k,v (B,Q,H,hd); logw same;
    u (H,hd).  Returns (S_new, y (B,Q,H,hd))."""
    r, k, v = r.float(), k.float(), v.float()
    Q = r.shape[1]
    cum = torch.cumsum(logw, dim=1)                      # (B,Q,H,hd) <= 0
    cum_prev = cum - logw                                # exclusive cumsum
    q_f = r * torch.exp(cum_prev)                        # r_t * W_{t-1}
    k_f = k * torch.exp(-cum)                            # k_j / W_j
    # strict-lower intra-chunk attention (j < t)
    scores = torch.einsum("bqhc,bthc->bhqt", q_f, k_f)
    strict = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    scores = torch.where(strict[None, None], scores, 0.0)
    y = torch.einsum("bhqt,bthv->bqhv", scores, v)
    # bonus (current token)
    bonus = torch.einsum("bqhc,bqhc->bqh", r, u[None, None] * k)
    y = y + bonus[..., None] * v
    # inter-chunk: contribution of the carried state
    y = y + torch.einsum("bqhc,bhcv->bqhv", q_f, S)
    # state update: S' = diag(W_Q) S + sum_j diag(W_Q/W_j) k_j v_j^T
    decay_to_end = torch.exp(cum[:, -1:] - cum)          # (B,Q,H,hd)
    S_new = S * torch.exp(cum[:, -1])[..., None] \
        + torch.einsum("bthc,bthv->bhcv", k * decay_to_end, v)
    return S_new, y


def rwkv_apply_full(p, x, cfg, state: Optional[dict] = None,
                    lengths: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence time-mix.  x: (B,T,d) -> (y (B,T,d), new state).

    ``lengths`` (B,) marks per-row valid prefixes of a right-padded
    batch: k/v/logw at padded positions are zeroed (identity steps) and
    the returned ``x_prev[0]`` is gathered at position lengths[b]-1.
    Padded outputs are garbage and must be discarded; a row with
    lengths[b] == 0 keeps its incoming state.
    """
    if hasattr(x, "device_mesh"):       # DTensors: per rank, see per_rank
        st = (None, None) if state is None \
            else (state["S"], state["x_prev"])
        return per_rank(
            lambda pl, xl, S, xp, ln: rwkv_apply_full(
                pl, xl, cfg, None if S is None else {"S": S, "x_prev": xp},
                ln), p, [x, *st, lengths], 3)
    H, hd = _dims(cfg)
    B, T, d = x.shape
    if state is None:
        state = init_rwkv_state(cfg, B, device=x.device)
    x_shift = torch.cat([state["x_prev"][:, 0:1].to(x.dtype), x[:, :-1]],
                        dim=1)
    r, k, v, g, logw = _proj(p, x, x_shift, cfg)
    if lengths is not None:
        valid = (torch.arange(T, device=x.device)[None, :]
                 < lengths.long()[:, None])[..., None, None]   # (B,T,1,1)
        k = torch.where(valid, k, 0.0)
        v = torch.where(valid, v, 0.0)
        logw = torch.where(valid, logw, 0.0)

    Q = min(cfg.ssm.chunk_size, T)
    pad = (-T) % Q
    if pad:
        # pad with identity steps: k = v = 0, logw = 0 (no state change)
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    S = state["S"].float()
    ys = []
    for c0 in range(0, T + pad, Q):
        sl = slice(c0, c0 + Q)
        S, y = _wkv_chunk(S, r[:, sl], k[:, sl], v[:, sl], logw[:, sl],
                          p["u"])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    out = _finish(p, y, g, cfg)
    if lengths is None:
        last = x[:, -1]
    else:
        idx = torch.clamp(lengths.long() - 1, min=0)
        last = x[torch.arange(B, device=x.device), idx]
        last = torch.where((lengths > 0)[:, None], last,
                           state["x_prev"][:, 0].to(x.dtype))
    x_prev = state["x_prev"].clone()
    x_prev[:, 0] = last.to(x_prev.dtype)
    return out, {"S": S, "x_prev": x_prev}


# ---------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------

def rwkv_decode_step(p, x, cfg, state) -> Tuple[torch.Tensor, dict]:
    """x: (B,1,d) -> (y (B,1,d), new state)."""
    if hasattr(x, "device_mesh"):       # DTensors: per rank, see per_rank
        return per_rank(lambda pl, xl, S, xp: rwkv_decode_step(
            pl, xl, cfg, {"S": S, "x_prev": xp}),
            p, [x, state["S"], state["x_prev"]], 3)
    x_shift = state["x_prev"][:, 0:1].to(x.dtype)
    r, k, v, g, logw = _proj(p, x, x_shift, cfg)
    r32, k32, v32 = (a[:, 0].float() for a in (r, k, v))
    S = state["S"].float()                               # (B,H,hd,hd)
    wkv = S + p["u"][None, :, :, None] * k32[..., None] * v32[..., None, :]
    y = torch.einsum("bhc,bhcv->bhv", r32, wkv)[:, None]  # (B,1,H,hd)
    w = torch.exp(logw[:, 0])                            # (B,H,hd)
    S_new = S * w[..., None] + k32[..., None] * v32[..., None, :]
    out = _finish(p, y, g, cfg)
    x_prev = state["x_prev"].clone()
    x_prev[:, 0] = x[:, 0].to(x_prev.dtype)
    return out, {"S": S_new, "x_prev": x_prev}


# ---------------------------------------------------------------------------
# Channel mix (RWKV FFN with token shift)
# ---------------------------------------------------------------------------

def channel_mix_init(generator: torch.Generator, cfg,
                     dtype=torch.float32) -> dict:
    d = cfg.d_model
    mu = torch.rand((2, d), generator=generator,
                    device=generator.device) * 0.5 + 0.25
    return {
        "mu": mu.to(dtype),
        "wk": dense_init(generator, d, cfg.d_ff, dtype),
        "wv": dense_init(generator, cfg.d_ff, d, dtype),
    }


def channel_mix_apply(p, x, x_shift):
    """x, x_shift: (B,T,d)."""
    mu = p["mu"].to(x.dtype)
    xk = x * mu[0] + x_shift * (1.0 - mu[0])
    h = torch.square(F.relu(xk @ p["wk"].to(x.dtype)))
    return h @ p["wv"].to(x.dtype)


# ---------------------------------------------------------------------------
# Oracle: per-token recurrence (tests only)
# ---------------------------------------------------------------------------

def rwkv_apply_recurrent(p, x, cfg, state: Optional[dict] = None):
    B, T, _ = x.shape
    if state is None:
        state = init_rwkv_state(cfg, B, device=x.device)
    ys = []
    for t in range(T):
        y, state = rwkv_decode_step(p, x[:, t:t + 1], cfg, state)
        ys.append(y)
    return torch.cat(ys, dim=1), state
