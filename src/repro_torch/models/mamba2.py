"""Mamba2 (SSD) mixer — chunked scan for prefill, O(1) state decode (port
of ``repro.models.mamba2``).

The chunked SSD algorithm: within a chunk of Q tokens the output is a
quadratic (Q, Q) term, across chunks a recurrence over the carried
state.  The chunk loop is a Python loop whose body holds one chunk's
quadratic term, so the working set stays one chunk; the products are
batched matmuls.  The reference computes this in plain jnp (no Pallas
kernel), and so does the port, in plain PyTorch.

State carried between chunks / decode steps:
  h    : (B, H, hd, ds)   SSD state, float32
  conv : (B, d_conv-1, d_xbc) depthwise-conv tail

Layout: n_groups = 1 (B/C shared across heads), as in Zamba2.  dtype
flow follows the reference op by op: projections cast the weight to the
input's dtype, the scan runs in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, per_rank, rms_norm_gated, softplus


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    d_xbc = d_in + 2 * s.d_state
    return d_in, n_heads, d_xbc


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def mamba_init(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """Fresh params (the reference's shapes and scales; another random
    stream)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, d_xbc = _dims(cfg)
    dev = generator.device
    conv_w = torch.randn((s.d_conv, d_xbc), generator=generator,
                         device=dev) * 0.1
    return {
        "z_proj": dense_init(generator, d, d_in, dtype),
        "xbc_proj": dense_init(generator, d, d_xbc, dtype),
        "dt_proj": dense_init(generator, d, H, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d_xbc,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 8.0, H, device=dev)),
        "dt_bias": torch.zeros((H,), device=dev),
        "D": torch.ones((H,), device=dev),
        "norm_w": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, d_in, d, dtype),
    }


def init_mamba_state(cfg, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    s = cfg.ssm
    d_in, H, d_xbc = _dims(cfg)
    return {
        "h": torch.zeros((batch, H, s.head_dim, s.d_state), dtype=dtype,
                         device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, d_xbc), dtype=dtype,
                            device=device),
    }


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _split_proj(p, x):
    """x (B,T,d) -> z (B,T,d_in), xBC (B,T,d_xbc), dt (B,T,H) (pre-softplus)."""
    z = x @ p["z_proj"].to(x.dtype)
    xBC = x @ p["xbc_proj"].to(x.dtype)
    dt = x @ p["dt_proj"].to(x.dtype)
    return z, xBC, dt


def _conv_full(p, xBC, conv_state):
    """Causal depthwise conv along T.  conv_state: (B, d_conv-1, d_xbc)."""
    w = p["conv_w"].to(xBC.dtype)                        # (K, C)
    K = w.shape[0]
    T = xBC.shape[1]
    ext = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    out = ext[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + ext[:, i:i + T] * w[i]
    out = out + p["conv_b"].to(xBC.dtype)
    new_state = ext[:, -(K - 1):] if K > 1 else conv_state
    return F.silu(out), new_state


def _conv_step(p, xBC_t, conv_state):
    """One-token conv.  xBC_t: (B, C)."""
    w = p["conv_w"].to(xBC_t.dtype)
    ext = torch.cat([conv_state.to(xBC_t.dtype), xBC_t[:, None]], dim=1)
    out = (ext * w[None]).sum(dim=1) + p["conv_b"].to(xBC_t.dtype)
    return F.silu(out), ext[:, 1:]


# ---------------------------------------------------------------------------
# Chunked SSD scan (prefill)
# ---------------------------------------------------------------------------

def _ssd_chunk(carry_h, xh, Bm, Cm, dA, dt):
    """One chunk.  carry_h: (B,H,hd,ds) float32.

    xh (B,Q,H,hd), Bm/Cm (B,Q,ds), dA (B,Q,H) [negative log-decay*dt],
    dt (B,Q,H).  Returns (h_next, y (B,Q,H,hd) float32).
    """
    xdt = (xh * dt[..., None]).float()                   # (B,Q,H,hd)
    cum = torch.cumsum(dA, dim=1)                        # (B,Q,H) (<= 0)
    Q = xh.shape[1]
    Cf, Bf = Cm.float(), Bm.float()
    # --- intra-chunk quadratic term -----------------------------------
    scores = torch.einsum("bqn,btn->bqt", Cf, Bf)        # (B,Q,Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))[None, :, :, None]
    # mask the exponent before exp: for t > q the argument is positive
    delta = cum[:, :, None, :] - cum[:, None, :, :]      # (B,Q,T,H)
    decay = torch.where(causal, torch.exp(torch.where(causal, delta, 0.0)),
                        0.0)
    y_intra = torch.einsum("bqth,bthp->bqhp", scores[..., None] * decay, xdt)
    # --- inter-chunk (state from previous chunks) ----------------------
    y_inter = torch.einsum("bqn,bhpn->bqhp", Cf, carry_h) \
        * torch.exp(cum)[..., None]
    # --- state update ---------------------------------------------------
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)       # (B,Q,H)
    s_new = torch.einsum("bthp,btn->bhpn", xdt * decay_to_end[..., None], Bf)
    chunk_decay = torch.exp(cum[:, -1])[:, :, None, None]   # (B,H,1,1)
    h_next = carry_h * chunk_decay + s_new
    return h_next, y_intra + y_inter


def mamba_apply_full(p, x, cfg, state: Optional[dict] = None,
                     lengths: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence mixer.  x: (B,T,d).  Returns (y (B,T,d), new state).

    ``lengths`` (B,) marks per-row valid prefixes of a right-padded
    batch: positions >= lengths[b] become identity steps (dt = 0, so no
    state write and no decay) and the returned state is exactly the
    state after lengths[b] tokens — the conv tail is gathered per row.
    Outputs at padded positions are garbage and must be discarded.  A
    row with lengths[b] == 0 keeps its incoming state.
    """
    if hasattr(x, "device_mesh"):       # DTensors: per rank, see per_rank
        st = (None, None) if state is None else (state["h"], state["conv"])
        return per_rank(
            lambda pl, xl, h, conv, ln: mamba_apply_full(
                pl, xl, cfg, None if h is None else {"h": h, "conv": conv},
                ln), p, [x, *st, lengths], 3)
    s = cfg.ssm
    d_in, H, d_xbc = _dims(cfg)
    hd, ds = s.head_dim, s.d_state
    B, T, _ = x.shape
    if state is None:
        state = init_mamba_state(cfg, B, device=x.device)

    z, xBC_raw, dt_raw = _split_proj(p, x)
    xBC, conv_new = _conv_full(p, xBC_raw, state["conv"])
    if lengths is not None and s.d_conv > 1:
        # per-row conv tail: the raw (pre-silu) xBC values at positions
        # [len-K+1, len) — ext index len..len+K-2 (identity for len==0)
        K = s.d_conv
        ext = torch.cat([state["conv"].to(xBC_raw.dtype), xBC_raw], dim=1)
        idx = lengths.long()[:, None] + torch.arange(K - 1, device=x.device)
        conv_new = torch.gather(
            ext, 1, idx[..., None].expand(B, K - 1, d_xbc)
        ).to(state["conv"].dtype)
    xh = xBC[..., :d_in].reshape(B, T, H, hd)
    Bm = xBC[..., d_in:d_in + ds]
    Cm = xBC[..., d_in + ds:]
    dt = softplus(dt_raw.float() + p["dt_bias"])         # (B,T,H)
    if lengths is not None:
        valid = torch.arange(T, device=x.device)[None, :] \
            < lengths.long()[:, None]                    # (B, T)
        dt = torch.where(valid[..., None], dt, 0.0)
    A = -torch.exp(p["A_log"])                           # (H,) negative
    dA = dt * A                                          # (B,T,H) <= 0

    Q = min(s.chunk_size, T)
    pad = (-T) % Q
    if pad:
        # identity steps: dt = 0 (no state write), dA = 0 (no decay)
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    h = state["h"].float()
    ys = []
    for c0 in range(0, T + pad, Q):
        sl = slice(c0, c0 + Q)
        h, y = _ssd_chunk(h, xh[:, sl], Bm[:, sl], Cm[:, sl], dA[:, sl],
                          dt[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]                      # float32
    y = y + p["D"][None, None, :, None] * xh[:, :T].float()
    y = y.reshape(B, T, d_in).to(x.dtype)
    y = rms_norm_gated(p["norm_w"], y, z, cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"h": h, "conv": conv_new}


# ---------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------

def mamba_decode_step(p, x, cfg, state) -> Tuple[torch.Tensor, dict]:
    """x: (B,1,d) -> (y (B,1,d), new state)."""
    if hasattr(x, "device_mesh"):       # DTensors: per rank, see per_rank
        return per_rank(lambda pl, xl, h, conv: mamba_decode_step(
            pl, xl, cfg, {"h": h, "conv": conv}),
            p, [x, state["h"], state["conv"]], 3)
    s = cfg.ssm
    d_in, H, d_xbc = _dims(cfg)
    hd, ds = s.head_dim, s.d_state
    B = x.shape[0]
    z, xBC, dt_raw = _split_proj(p, x[:, 0:1])
    xBC_t, conv_new = _conv_step(p, xBC[:, 0], state["conv"])
    xh = xBC_t[:, :d_in].reshape(B, H, hd)
    Bm = xBC_t[:, d_in:d_in + ds]
    Cm = xBC_t[:, d_in + ds:]
    dt = softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                            # (B,H)
    h = state["h"].float()
    xdt = (xh * dt[..., None]).float()                   # (B,H,hd)
    h_new = h * decay[..., None, None] \
        + xdt[..., None] * Bm.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm.float())
    y = y + p["D"][None, :, None] * xh.float()
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rms_norm_gated(p["norm_w"], y, z, cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"h": h_new, "conv": conv_new}


# ---------------------------------------------------------------------------
# Oracle: naive per-token recurrence (tests only)
# ---------------------------------------------------------------------------

def mamba_apply_recurrent(p, x, cfg, state: Optional[dict] = None):
    """Token-by-token reference for mamba_apply_full."""
    B, T, _ = x.shape
    if state is None:
        state = init_mamba_state(cfg, B, device=x.device)
    ys = []
    for t in range(T):
        y, state = mamba_decode_step(p, x[:, t:t + 1], cfg, state)
        ys.append(y)
    return torch.cat(ys, dim=1), state
