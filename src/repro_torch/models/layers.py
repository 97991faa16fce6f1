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

def gather_last(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its last dim sharded, that dim replicated (an
    all-gather); anything else as it is.  A norm over a sharded feature
    dim would otherwise leave DTensor to reshard the sequence instead."""
    if not hasattr(x, "device_mesh") or not any(
            p.is_shard(x.ndim - 1) for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(x.ndim - 1) else p for p in x.placements])


def on_mesh(t, mesh):
    """A DTensor as it is; a plain tensor (made from no DTensor: a
    position ramp, a one-hot, labels) as the same value replicated on
    ``mesh``; None as None."""
    from torch.distributed.tensor import DTensor, Replicate
    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over a process group whose backward passes the
    gradient through: the sum's output is replicated over the group, so
    each rank's share of it gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed._functional_collectives import all_reduce
        y = all_reduce(x, "sum", group)
        return y.wait() if hasattr(y, "wait") else y

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (see ``_SumOver``)."""
    return _SumOver.apply(x, group)


def per_rank(fn, params, batched, n_out: int, *static):
    """``fn(params, *batched, *static)`` on DTensors (the dry run), each
    rank running the plain block on its own rows, inside ``local_map``:
    for blocks DTensor has no sharding strategy for (the SSM scans, the
    MoE baseline's sort dispatch).  ``params`` (a nested dict of
    tensors) replicate, an all-gather of what the policy sharded;
    ``batched`` (tensors or None, rows on dim 0) shard their rows over
    the mesh dims in order, as far as the row count divides.  Each of
    the ``n_out`` tensors ``fn`` returns has its rows on dim 0 too, and
    comes back with its rows laid out as the first batched input's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten, tree_unflatten
    x = next(t for t in batched if t is not None)
    p_leaves, p_spec = tree_flatten(params)
    mesh = next(t.device_mesh for t in [x, *p_leaves]
                if isinstance(t, DTensor))
    rows, split = x.shape[0], 1
    plc = []
    for i in range(mesh.ndim):
        if rows % (split * mesh.size(i)) == 0:
            split *= mesh.size(i)
            plc.append(Shard(0))
        else:
            plc.append(Replicate())
    plc = tuple(plc)
    rep = (Replicate(),) * mesh.ndim
    n_p = len(p_leaves)
    out_spec = []

    def local(*args):
        pl = tree_unflatten([_ContiguousGrad.apply(a)
                             for a in args[:n_p]], p_spec)
        out = fn(pl, *[None if a is None else _ContiguousGrad.apply(a)
                       for a in args[n_p:]], *static)
        leaves, spec = tree_flatten(out)
        out_spec.append(spec)
        return tuple(leaves)

    args = [on_mesh(t, mesh) for t in [*p_leaves, *batched]]
    in_plc = (rep,) * n_p + tuple(None if t is None else plc
                                  for t in batched)
    # a replicated param's gradient is the sum of the ranks' that split
    # the rows between them
    p_grad = tuple(Partial() if pl.is_shard() else Replicate()
                   for pl in plc)
    res = local_map(local, out_placements=(plc,) * n_out,
                    in_placements=in_plc,
                    in_grad_placements=(p_grad,) * n_p + in_plc[n_p:],
                    device_mesh=mesh, redistribute_inputs=True)(*args)
    if isinstance(x, DTensor):          # back to the rows' own layout
        back = [p if p.is_shard(0) else Replicate() for p in x.placements]
        res = [r.redistribute(mesh, back) for r in res]
    return tree_unflatten(list(res), out_spec[0])


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x = gather_last(x)
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

def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the incoming gradient contiguous:
    a gradient DTensor hands to or back from ``local_map`` may be
    strided, and the local ops' backwards view their gradients."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _sharded_nll(logits, labels):
    """``_nll`` of DTensor logits, each rank taking its rows inside
    ``local_map``.  With the vocab sharded over ``model`` the
    cross-entropy is vocab-parallel: each rank reduces its vocab slice
    (max, sum of exponentials, the label's logit where it falls in the
    slice) and the ``model`` group combines them, so no rank holds the
    whole vocab; DTensor's own gather over a sharded vocab would
    replicate the global logits for its backward."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    v_dim = logits.ndim - 1
    # rows keep their shards (partial sums are reduced); the vocab keeps
    # its shard over one mesh dim, the model dim
    plc = [p if isinstance(p, Shard) else Replicate()
           for p in logits.placements]
    vocab = [i for i, p in enumerate(plc) if p.is_shard(v_dim)]
    for i in vocab[1:]:
        plc[i] = Replicate()
    v_i = vocab[0] if vocab else None
    row_plc = tuple(Replicate() if i == v_i else p for i, p in
                    enumerate(plc))
    group = mesh.get_group(v_i) if v_i is not None else None

    def local(lg, lb):
        lg = _ContiguousGrad.apply(lg).float()
        if v_i is None:
            return _nll(lg, lb)
        n = lg.shape[-1]
        m = lg.detach().amax(dim=-1)
        m = all_reduce(m, "max", group)
        m = m.wait() if hasattr(m, "wait") else m
        se = sum_over(torch.exp(lg - m[..., None]).sum(dim=-1), group)
        rel = lb.long() - mesh.get_local_rank(v_i) * n
        ok = (rel >= 0) & (rel < n)
        gold = torch.gather(lg, -1, rel.clamp(0, n - 1)[..., None])[..., 0]
        gold = sum_over(gold * ok, group)
        return torch.log(se) + m - gold

    labels = on_mesh(labels, mesh)
    fn = local_map(local, out_placements=list(row_plc),
                   in_placements=(tuple(plc), row_plc),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(logits, labels)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask=None) -> torch.Tensor:
    """Mean CE over valid tokens.  logits (..., V) any float dtype,
    reduced in float32."""
    nll = _sharded_nll(logits, labels) if hasattr(logits, "device_mesh") \
        else _nll(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
