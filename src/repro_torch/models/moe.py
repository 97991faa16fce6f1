"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro.models.moe``).

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

Expert parallelism (``moe_apply_expert_parallel``, the reference's
``shard_map`` path): experts shard over the mesh's ``model`` dim, tokens
over its data dims, and tokens travel to the rank that owns their expert
and back with ``all_to_all_single`` on the ``model`` group, inside
``local_map`` (the analogue of ``shard_map``).  ``moe_apply_auto`` takes
it when ``MESH`` is set and the experts divide the ``model`` dim.

``moe_apply_dense`` is the naive loop-over-experts oracle used by tests.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from .layers import _ContiguousGrad, dense_init, matmul, on_mesh, per_rank

# Set by the launch layer (the dry run, or a serving engine on a mesh):
# the mesh dims that shard the token dimension (("data",) or ("pod",
# "data")) and the number of dispatch groups (= number of token shards).
# Grouped dispatch keeps every sort/scatter/gather local to its group.
DATA_AXES = None
N_GROUPS = 1
# The DeviceMesh of the expert-parallel path (None: the baseline, one
# device's sort dispatch).
MESH = None
# all_to_all_single calls made by the expert-parallel path (four per MoE
# layer per forward), for callers that check the path ran.
N_ALL_TO_ALL = 0


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


def _counts(idx: torch.Tensor, E: int) -> torch.Tensor:
    """Routes per expert, (E,) int64: ``bincount`` with a static output
    shape (fake tensors, as the dry run uses, cannot size a bincount)."""
    flat = idx.reshape(-1).long()
    return torch.zeros(E, dtype=torch.long, device=idx.device).index_add_(
        0, flat, torch.ones_like(flat))


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
    f = _counts(idx, m.n_experts).float() / (S * m.top_k)   # fraction routed
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
    counts = _counts(eid, E)                             # (E,)
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


def _apply_group(p, x, gates, idx, cfg, C: int):
    """One dispatch group: tokens x (Sg, d) with their routes -> the
    routed experts' weighted sum (Sg, d)."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    S, d = x.shape
    src_token, slot_valid, slot, keep, src_replica = dispatch_plan(
        idx, E, C)
    _count_drops(cfg, keep)
    xe = _Dispatch.apply(x, src_token, slot_valid, slot, keep, k)
    ye = _expert_ffn(p, xe.reshape(E, C, d), cfg.act)    # (E, C, d)
    ys = _Combine.apply(ye.reshape(E * C, d), slot, keep, src_replica,
                        slot_valid)                      # (Lg, d)
    return (ys.reshape(S, k, d) * gates[..., None].to(ye.dtype)).sum(dim=1)


def _count_drops(cfg, keep: torch.Tensor) -> None:
    """Traced: the routed replicas and those capacity dropped, per
    model config (``moe.routed/<name>``, ``moe.dropped/<name>``); the
    drops are summed on the device."""
    if tracing.on:
        tracing.count(f"moe.routed/{cfg.name}", keep.numel())
        tracing.count(f"moe.dropped/{cfg.name}", (~keep).sum())


def _capacity(cfg, n_replicas: int, capacity: int) -> int:
    if capacity <= 0:
        cap = int(cfg.moe.capacity_factor * n_replicas / cfg.moe.n_experts) \
            + 1
        capacity = -(-cap // 8) * 8
    return capacity


def _shared(p, x):
    sh = p["shared"]
    h = F.silu(x @ sh["w_gate"].to(x.dtype)) * (x @ sh["w_up"].to(x.dtype))
    return h @ sh["w_down"].to(x.dtype)


def moe_apply(p, x, cfg, *, capacity: int = 0):
    """MoE FFN with grouped sort dispatch.  x: (S, d) flattened tokens.
    Returns (y (S,d), aux_loss).

    Tokens split into ``N_GROUPS`` groups (batch-major, so a group lives
    on one token shard), each with its own sort, capacity and un-sort.
    capacity: per-expert per-group capacity; 0 derives it from
    ``capacity_factor`` (ceil(cf * replicas per group / E), padded to a
    multiple of 8).
    """
    if hasattr(x, "device_mesh"):
        # DTensors (the dry run's baseline): each rank dispatches its own
        # tokens, one group, over the gathered expert banks (per_rank)
        def local(pl, xl):
            y, aux = _moe_groups(pl, xl, cfg, capacity, 1)
            return y, aux[None]
        y, aux = per_rank(local, p, [x], 2)
        return y, aux.mean()
    return _moe_groups(p, x, cfg, capacity, N_GROUPS)


def _moe_groups(p, x, cfg, capacity: int, n_groups: int):
    m = cfg.moe
    S, d = x.shape
    gates, idx, aux = route(p["router"], x, cfg)
    G = n_groups if S % max(n_groups, 1) == 0 else 1
    C = _capacity(cfg, S * m.top_k // G, capacity)
    if G == 1:
        y = _apply_group(p, x, gates, idx, cfg, C)
    else:
        Sg = S // G
        y = torch.cat([_apply_group(p, x[g * Sg:(g + 1) * Sg],
                                    gates[g * Sg:(g + 1) * Sg],
                                    idx[g * Sg:(g + 1) * Sg], cfg, C)
                       for g in range(G)])
    if "shared" in p:
        y = y + _shared(p, x)
    return y, aux


# ---------------------------------------------------------------------------
# Expert-parallel MoE (the reference's shard_map path)
#
# Shard experts on `model`, keep tokens on the data dims, and move each
# token's activation to the rank that owns its expert and back with
# all_to_all on the `model` group: per-device traffic is O(local tokens)
# instead of an all-gather of the dispatch tensor.  Used when MESH is set
# and n_experts % model == 0; other archs keep the baseline path.
# ---------------------------------------------------------------------------

def _all_to_all(x, split_axis: int, concat_axis: int, group, msize: int):
    """``jax.lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` on
    ``group``: chunk j of ``split_axis`` goes to rank j, and the chunks
    received from ranks 0..msize-1 concatenate along ``concat_axis``."""
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd
    global N_ALL_TO_ALL
    N_ALL_TO_ALL += 1
    shp = list(x.shape)
    c = shp[split_axis] // msize
    xs = x.reshape(shp[:split_axis] + [msize, c] + shp[split_axis + 1:])
    xs = xs.movedim(split_axis, 0).contiguous()          # (msize, chunk)
    chunk = xs.shape[1:]
    got = all_to_all_single_autograd(xs.reshape(msize * chunk[0],
                                                *chunk[1:]),
                                     None, None, group)
    got = got.reshape(msize, *chunk)                     # [i] from rank i
    out = got.movedim(0, concat_axis)
    shp_out = list(chunk)
    shp_out[concat_axis] *= msize
    return out.reshape(shp_out)


def moe_apply_expert_parallel(p, x, cfg, *, capacity: int = 0):
    """The expert-parallel MoE FFN on ``MESH``.  x (S, d) and the params
    are DTensors on ``MESH`` (plain tensors count as replicated); returns
    (y (S, d), aux) as the caller gave x: a DTensor, or a plain tensor.
    Falls back to ``moe_apply`` where the tokens per group do not divide
    the ``model`` dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = MESH
    m = cfg.moe
    S, d = x.shape
    E, k = m.n_experts, m.top_k
    names = mesh.mesh_dim_names
    msize = mesh.size(names.index("model"))
    G = N_GROUPS if S % max(N_GROUPS, 1) == 0 else 1
    Sg = S // G
    if Sg % msize != 0:
        return moe_apply(p, x, cfg, capacity=capacity)
    Sl = Sg // msize                  # tokens per device
    Lg = Sl * k
    C = _capacity(cfg, Lg, capacity)
    dp = DATA_AXES or ("data",)
    model_group = mesh.get_group("model")
    plain = not isinstance(x, DTensor)

    # the block's params, int8 banks ({"q", "s"}) included, as one flat
    # list: expert banks (E on dim 0) shard over model, the rest
    # (router, scales, shared experts) replicate
    from torch.utils._pytree import tree_flatten, tree_unflatten
    leaves, spec = tree_flatten(p)
    expert = [t.ndim == 3 and t.shape[0] == E and t.shape[1] > 1
              for t in leaves]

    def local_fn(x_dl, *pl):
        pl = tree_unflatten(list(pl), spec)
        # x_dl (Sg, d/msize): tokens on data, hidden on model; an
        # all_to_all trades hidden for tokens -> (Sl, d)
        x_dl = _ContiguousGrad.apply(x_dl)
        d_l = x_dl.shape[-1]
        xt = x_dl.reshape(msize, Sl, d_l)
        xl = _all_to_all(xt, 0, 2, model_group, msize)[0]       # (Sl, d)
        gates, idx, aux = route(pl["router"], xl, cfg)

        src_token, slot_valid, slot, keep, src_replica = dispatch_plan(
            idx, E, C)
        _count_drops(cfg, keep)
        xe = _Dispatch.apply(xl, src_token, slot_valid, slot, keep, k)
        xe = xe.reshape(E, C, d)
        # tokens -> owning expert rank (split E, concat capacity)
        xa = _all_to_all(xe, 0, 1, model_group, msize)   # (E_l, ms*C, d)
        ye = _expert_ffn(pl, xa, cfg.act)
        # results -> token owners
        ye = _all_to_all(ye, 1, 0, model_group, msize)   # (E, C, d)
        ys = _Combine.apply(ye.reshape(E * C, d), slot, keep, src_replica,
                            slot_valid)                  # (Lg, d)
        y = (ys.reshape(Sl, k, d) * gates[..., None].to(ys.dtype)).sum(1)
        if "shared" in pl:
            y = y + _shared(pl, xl)
        # the inverse hidden <-> token all_to_all: back to (Sg, d_l)
        yt = _all_to_all(y.reshape(Sl, msize, d_l), 1, 0, model_group,
                         msize)                           # (Sg, 1, d_l)
        # aux: one value per device; the data shards' values are
        # averaged below, as the reference's pmean and mean
        return _ContiguousGrad.apply(yt.reshape(Sg, d_l)), aux[None]

    def plc(spec):
        out = []
        for name in names:
            dim = None
            for i, ax in enumerate(spec):
                if ax == name or (ax == "DP" and name in dp):
                    dim = i
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)

    w_plc, rep = plc(("model", None, None)), plc(())
    # gradients: every rank routes its own tokens, so a replicated
    # weight's gradient sums over all ranks, an expert bank's over the
    # data ranks
    all_partial = (Partial(),) * mesh.ndim
    w_grad = tuple(p if p.is_shard() else Partial() for p in w_plc)
    x_plc = plc(("DP", "model"))
    fn = local_map(
        local_fn,
        out_placements=(x_plc, plc(("DP",))),
        in_placements=(x_plc,) + tuple(w_plc if e else rep for e in expert),
        in_grad_placements=(x_plc,) + tuple(w_grad if e else all_partial
                                            for e in expert),
        device_mesh=mesh, redistribute_inputs=True)
    args = [on_mesh(t, mesh) for t in [x, *leaves]]
    y, aux = fn(*args)
    aux = aux.mean()
    if plain:
        return _gathered(y), _gathered(aux)
    return y, aux


def _gathered(t):
    """A DTensor's global value as a plain tensor, its collective waited
    for."""
    t = t.full_tensor()
    return t.wait() if hasattr(t, "wait") else t


def moe_apply_auto(p, x, cfg, *, capacity: int = 0):
    """Expert-parallel path when configured & divisible, else baseline."""
    if MESH is not None and cfg.moe.n_experts % MESH.size(
            MESH.mesh_dim_names.index("model")) == 0:
        return moe_apply_expert_parallel(p, x, cfg, capacity=capacity)
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
