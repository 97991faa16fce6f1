"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro.models.moe``, the mesh-less path).

Two architectures use this block:
  * mixtral-8x7b      — 8 experts, top-2, no shared experts.
  * deepseek-moe-16b  — 64 fine-grained routed experts, top-6, +2 shared.

Dispatch: token replicas are sorted by expert id (a stable sort, as the
reference's), each replica's position within its expert comes from the
expert counts' cumsum, and slot (e, c) of a fixed (E, C, d) buffer
gathers the c-th replica routed to expert e; replicas past the capacity
C are dropped.  Expert compute is one batched matmul over the expert
axis; the combine gathers each replica's output back from its slot.
Both directions are gathers, as in the reference, and so are their
gradients: ``_Dispatch`` and ``_Combine`` are autograd Functions whose
backwards gather through the inverse mapping (the reference's
``custom_vjp`` pair), where autograd would scatter-add.  The reference
computes all of this in plain jnp (no Pallas kernel), and so does the
port, in plain PyTorch.

``moe_apply_dense`` is the naive loop-over-experts oracle used by tests.
Expert parallelism over a mesh is not ported: ``moe_apply_auto`` is
``moe_apply``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, matmul


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def moe_init(generator: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """Fresh params (the reference's shapes and scales; another random
    stream)."""
    m = cfg.moe
    d = cfg.d_model
    de = m.d_expert or cfg.d_ff

    def expert_bank(d_in, d_out):
        return torch.stack([dense_init(generator, d_in, d_out, dtype)
                            for _ in range(m.n_experts)])

    p = {
        "router": dense_init(generator, d, m.n_experts, torch.float32),
        "w_gate": expert_bank(d, de),     # (E, d, de)
        "w_up": expert_bank(d, de),       # (E, d, de)
        "w_down": expert_bank(de, d),     # (E, de, d)
    }
    if m.n_shared_experts:
        ds = de * m.n_shared_experts
        p["shared"] = {
            "w_gate": dense_init(generator, d, ds, dtype),
            "w_up": dense_init(generator, d, ds, dtype),
            "w_down": dense_init(generator, ds, d, dtype),
        }
    return p


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest values in
    descending order, ties broken toward the lower index (a stable
    descending sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_w, x, cfg) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Top-k routing in float32.  x: (S, d).  Returns (gates (S,k),
    idx (S,k), aux_loss)."""
    m = cfg.moe
    logits = x.float() @ router_w.float()                # (S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, m.top_k)                   # (S, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e; its gradient
    # flows through P only (f counts integer routes, as the reference's
    # one-hot of the indices)
    S = x.shape[0]
    f = torch.bincount(idx.reshape(-1), minlength=m.n_experts).float() \
        / (S * m.top_k)                                  # fraction routed
    P = probs.mean(0)                                    # mean router prob
    aux = m.n_experts * torch.sum(f * P)
    return gates, idx, aux


# ---------------------------------------------------------------------------
# Sort-based dispatch apply
# ---------------------------------------------------------------------------

def _w(w, dtype):
    """Resolve a (possibly int8-quantized) weight bank to compute dtype:
    ``{"q": int8 W, "s": scales}`` dequantizes as ``q * s``."""
    if isinstance(w, dict):
        return w["q"].to(dtype) * w["s"].to(dtype)
    return w.to(dtype)


def quantize_bank(w: torch.Tensor) -> dict:
    """Symmetric int8 quantization with per-out-channel scales: ``s`` is
    shaped like ``w`` but size 1 on every dim except the last."""
    amax = torch.amax(w.abs(), dim=tuple(range(w.ndim - 1)), keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s.float()}


def _expert_ffn(p, xe, act: str):
    """xe: (E, C, d) -> (E, C, d)."""
    h = torch.bmm(xe, _w(p["w_up"], xe.dtype))
    if act == "swiglu":
        g = torch.bmm(xe, _w(p["w_gate"], xe.dtype))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, _w(p["w_down"], xe.dtype))


# ---------------------------------------------------------------------------
# Gather-only dispatch/combine with gather-only backwards.
#
# Routing is a permutation with drops: each token replica fills at most
# one (expert, slot) and each slot is filled by at most one replica, so
# the transpose of either gather is itself a gather through the inverse
# mapping.  Replica r = token * k + j (token-major), so a token's k
# replicas are contiguous.
# ---------------------------------------------------------------------------

class _Dispatch(torch.autograd.Function):
    """x (S, d) -> xe_flat (E*C, d): slot i holds token ``src_token[i]``
    where ``slot_valid[i]``, else zeros.  Backward: replica r reads the
    gradient at its slot ``slot[r]`` where ``keep[r]``, and each token
    sums its k replicas."""

    @staticmethod
    def forward(ctx, x, src_token, slot_valid, slot, keep, k: int):
        ctx.save_for_backward(slot, keep)
        ctx.k = k
        return torch.where(slot_valid[:, None], x[src_token], 0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_xe):
        slot, keep = ctx.saved_tensors
        d_rep = torch.where(keep[:, None], d_xe[slot], 0)   # (Lg, d)
        d_x = d_rep.reshape(-1, ctx.k, d_rep.shape[-1]).sum(dim=1)
        return d_x, None, None, None, None, None


class _Combine(torch.autograd.Function):
    """ye_flat (E*C, d) -> ys (Lg, d) in replica order: replica r reads
    slot ``slot[r]`` where ``keep[r]``, else zeros.  Backward: slot i
    reads the gradient of the replica it holds, ``src_replica[i]``,
    where ``slot_valid[i]``."""

    @staticmethod
    def forward(ctx, ye_flat, slot, keep, src_replica, slot_valid):
        ctx.save_for_backward(src_replica, slot_valid)
        return torch.where(keep[:, None], ye_flat[slot], 0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_ys):
        src_replica, slot_valid = ctx.saved_tensors
        d_ye = torch.where(slot_valid[:, None], d_ys[src_replica], 0)
        return d_ye, None, None, None, None


def dispatch_plan(idx: torch.Tensor, E: int, C: int):
    """The routing maps of ``_Dispatch`` / ``_Combine`` for top-k expert
    indices ``idx`` (S, k) over ``E`` experts of capacity ``C``:
    (src_token, slot_valid) per slot (E*C,), (slot, keep) per replica
    (S*k,), and src_replica per slot."""
    S, k = idx.shape
    Lg = S * k                                           # replicas
    dev = idx.device
    eid = idx.reshape(Lg)                                # token-major
    order = torch.sort(eid, stable=True).indices         # (Lg,)
    rank = torch.empty_like(order)                       # inverse perm
    rank[order] = torch.arange(Lg, device=dev)
    counts = torch.bincount(eid, minlength=E)            # (E,)
    starts = torch.cumsum(counts, 0) - counts            # (E,)

    # slot (e, c) pulls the c-th replica routed to expert e
    slot_ar = torch.arange(E * C, device=dev)
    e_of_slot = slot_ar // C
    c_of_slot = slot_ar % C
    sorted_idx = starts[e_of_slot] + c_of_slot           # (E*C,)
    slot_valid = c_of_slot < counts[e_of_slot]           # capacity+presence
    src_replica = order[torch.clamp(sorted_idx, 0, Lg - 1)]
    src_token = src_replica // k

    # replica -> slot
    pos = rank - starts[eid]                             # (Lg,)
    keep = pos < C
    slot = torch.clamp(eid * C + pos, 0, E * C - 1)
    return src_token, slot_valid, slot, keep, src_replica


def moe_apply(p, x, cfg, *, capacity: int = 0):
    """MoE FFN with sort dispatch.  x: (S, d) flattened tokens.  Returns
    (y (S,d), aux_loss).

    capacity: per-expert capacity; 0 derives it from ``capacity_factor``
    (ceil(cf * replicas / E), padded to a multiple of 8).  One dispatch
    group (the reference's grouping follows data shards, and the port
    has no mesh).
    """
    m = cfg.moe
    S, d = x.shape
    E, k = m.n_experts, m.top_k
    gates, idx, aux = route(p["router"], x, cfg)
    Lg = S * k                                           # replicas
    if capacity <= 0:
        cap = int(m.capacity_factor * Lg / E) + 1
        capacity = -(-cap // 8) * 8
    C = capacity

    src_token, slot_valid, slot, keep, src_replica = dispatch_plan(
        idx, E, C)
    xe = _Dispatch.apply(x, src_token, slot_valid, slot, keep, k)
    ye = _expert_ffn(p, xe.reshape(E, C, d), cfg.act)    # (E, C, d)
    ys = _Combine.apply(ye.reshape(E * C, d), slot, keep, src_replica,
                        slot_valid)                      # (Lg, d)
    y = (ys.reshape(S, k, d) * gates[..., None].to(ye.dtype)).sum(dim=1)

    if "shared" in p:
        sh = p["shared"]
        h = F.silu(x @ sh["w_gate"].to(x.dtype)) * (x @ sh["w_up"].to(x.dtype))
        y = y + h @ sh["w_down"].to(x.dtype)
    return y, aux


def moe_apply_auto(p, x, cfg, *, capacity: int = 0):
    """The reference's mesh-aware entry; without a mesh, ``moe_apply``."""
    return moe_apply(p, x, cfg, capacity=capacity)


# ---------------------------------------------------------------------------
# Oracle (loop over experts, no capacity drop) — tests only
# ---------------------------------------------------------------------------

def moe_apply_dense(p, x, cfg):
    """Reference: compute every expert on every token, mask by gates."""
    m = cfg.moe
    gates, idx, aux = route(p["router"], x, cfg)
    S, d = x.shape
    y = torch.zeros((S, d), device=x.device)
    for e in range(m.n_experts):
        h = matmul(x, p["w_up"][e])
        if cfg.act == "swiglu":
            h = F.silu(matmul(x, p["w_gate"][e])) * h
        else:
            h = F.gelu(h, approximate="tanh")
        ye = matmul(h, p["w_down"][e])
        w_e = torch.where(idx == e, gates, 0.0).sum(-1)  # (S,)
        y = y + w_e[:, None] * ye.float()
    if "shared" in p:
        sh = p["shared"]
        h = F.silu(matmul(x, sh["w_gate"])) * matmul(x, sh["w_up"])
        y = y + matmul(h, sh["w_down"]).float()
    return y.to(x.dtype), aux
