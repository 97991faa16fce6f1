"""Core layers: norms, RoPE, MLPs, inits, cross-entropy (port of
``repro.models.layers``).

Plain functions on tensors; params are nested dicts of tensors in the
reference layout (``x @ w`` with ``w`` shaped ``(d_in, d_out)``).  Every
function follows the reference's dtype flow op by op: norms and RoPE
compute in float32 and return the input dtype, and a product of two
dtypes computes in their promoted type (``matmul`` below), as jnp does.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jnp's type promotion (bf16 @ f32 computes in f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# Initializers (same shapes and scales as the reference; the numbers
# differ, because the random stream differs)
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device) * std
    return w.to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator,
                    device=generator.device) * 0.02
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * w.float()).to(dt)


def rms_norm_gated(w: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2-style: RMSNorm(x * silu(z))."""
    return rms_norm(w, x * F.silu(z.float()).to(x.dtype), eps)


def group_norm_heads(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                     n_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """RWKV-style per-head group norm.  x: (..., H*hd)."""
    dt = x.dtype
    shp = x.shape
    x = x.reshape(shp[:-1] + (n_heads, shp[-1] // n_heads)).float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = ((x - mu) * torch.rsqrt(var + eps)).reshape(shp)
    return (x * w.float() + b.float()).to(dt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """Rotation angles for the given positions.

    positions: (..., S) int for ordinary RoPE, or (3, ..., S) for M-RoPE
    (temporal/height/width position streams; Qwen2-VL).  Returns
    (..., S, head_dim//2) float32 angles.
    """
    inv = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions.float()[..., None] * inv
    if not mrope_sections:
        return ang
    # M-RoPE: split the hd/2 frequency channels into (t, h, w) sections
    # and drive each section with its own position stream
    if positions.shape[0] != 3:
        raise ValueError(f"M-RoPE needs (3, ..., S) positions, got "
                         f"{tuple(positions.shape)}")
    if sum(mrope_sections) != inv.shape[0]:
        raise ValueError(f"mrope_sections {mrope_sections} do not sum to "
                         f"head_dim/2 = {inv.shape[0]}")
    parts, off = [], 0
    for i, s in enumerate(mrope_sections):
        parts.append(ang[i, ..., off:off + s])
        off += s
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); angles: (..., S, hd/2) -> rotated x (same dtype)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = torch.cos(angles)[..., None, :]      # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype=torch.float32) -> dict:
    p = {"w_up": dense_init(generator, d_model, d_ff, dtype),
         "w_down": dense_init(generator, d_ff, d_model, dtype)}
    if act == "swiglu":
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = matmul(x, p["w_up"])
    if act == "swiglu":
        h = F.silu(matmul(x, p["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask=None) -> torch.Tensor:
    """Mean CE over valid tokens.  logits (..., V) any float dtype,
    reduced in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
