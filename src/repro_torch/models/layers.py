"""Core layers: norms, RoPE, MLPs, inits (port of ``repro.models.layers``).

Plain functions on tensors; params are nested dicts of tensors in the
reference layout (``x @ w`` with ``w`` shaped ``(d_in, d_out)``).  Every
function follows the reference's dtype flow op by op: norms and RoPE
compute in float32 and return the input dtype, and a product of two
dtypes computes in their promoted type (``matmul`` below), as jnp does.
"""
from __future__ import annotations

import math

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


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> torch.Tensor:
    """(..., S) int positions -> (..., S, head_dim//2) float32 angles."""
    inv = rope_freqs(head_dim, theta, device=positions.device)
    return positions.float()[..., None] * inv


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
