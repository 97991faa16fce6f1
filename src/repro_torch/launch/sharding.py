"""Path-based sharding policy for params, optimizer state, caches and
batches (port of ``repro.launch.sharding``).

Policies (per input-shape kind), as in the reference:
  * train   — FSDP + TP: weight matrices shard (contract-dim -> `data`,
    output-dim -> `model`); optimizer moments mirror params; batch shards
    over (`pod`, `data`).
  * serve (prefill/decode) — TP only: `data` is reserved for the request
    batch, weights replicate across it; KV caches shard batch -> `data`
    and *sequence* -> `model` (flash-decoding style — works for every GQA
    ratio incl. kv_heads < mesh axis, which head-sharding cannot do).

The rules are the reference's, verbatim: pure functions of path strings,
shapes and mesh axis sizes.  A spec is a tuple with one entry per tensor
dim — ``None``, an axis name, or a tuple of axis names — the entries of
the reference's ``PartitionSpec``.  :func:`placements` maps a spec to
DTensor placements on a ``DeviceMesh`` (a tuple of axes becomes
``Shard`` on each of them), and the ``*_shardings`` functions walk the
port's param, optimizer, cache and batch trees.  The port keeps the
reference's ``(d_in, d_out)`` weight layout and param paths
(``repro_torch.bridge`` copies reference params leaf for leaf), so the
rules apply unchanged.

Every rule is divisibility-checked against the mesh: a dim that doesn't
divide its axis is left unsharded and *recorded* — pass ``record=[]``
to any spec function and every dropped axis appends a
:class:`ShardFallback` (path, dim index, dim size, wanted axis, axis
size).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from ..models.model import tree_map_with_path
from .mesh import axis_sizes, batch_axes


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return axis_sizes(mesh)[name]


@dataclass(frozen=True)
class ShardFallback:
    """One divisibility fallback: the rule wanted ``axis`` on dim
    ``dim_index`` but ``dim % axis_size != 0`` left it unsharded."""
    path: str
    dim_index: int
    dim: int
    axis: object            # str or tuple of axis names
    axis_size: int


def fit_spec(mesh, shape: Tuple[int, ...], want: Tuple, *,
             record: Optional[List[ShardFallback]] = None,
             path: str = "") -> tuple:
    """Drop axes that don't divide their dim; pad/trim to rank.

    ``record`` (a caller-owned list) collects a :class:`ShardFallback`
    per dropped axis.
    """
    want = tuple(want) + (None,) * (len(shape) - len(want))
    # a one-axis tuple is that axis, as PartitionSpec normalizes it
    want = tuple(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for ax in want[: len(shape)])
    out = []
    for i, (dim, ax) in enumerate(zip(shape, want)):
        size = _axis_size(mesh, ax)
        if ax and dim % size == 0:
            out.append(ax)
        else:
            if ax and record is not None:
                record.append(ShardFallback(path=path, dim_index=i,
                                            dim=dim, axis=ax,
                                            axis_size=size))
            out.append(None)
    return tuple(out)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(i)`` where tensor dim ``i`` names that mesh dim (alone or in
    a tuple), else ``Replicate()``.  A tuple of axes on one tensor dim
    shards it over those mesh dims in mesh order, major first — the
    reference's ``PartitionSpec(("pod", "data"))``."""
    out = []
    for name in mesh.mesh_dim_names:
        dim = None
        for i, ax in enumerate(spec):
            if ax == name or (isinstance(ax, tuple) and name in ax):
                dim = i
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def local_shape(mesh, shape: Tuple[int, ...], spec: tuple) -> tuple:
    """The per-rank shape of a tensor of ``shape`` laid out by ``spec``
    (every sharded dim divides its axes: ``fit_spec`` sees to that)."""
    return tuple(d // _axis_size(mesh, ax) for d, ax in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): the leaf
    type of the ``*_shardings`` trees."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def local_shape(self, shape: Tuple[int, ...]) -> tuple:
        return local_shape(self.mesh, shape, self.spec)


# ---------------------------------------------------------------------------
# Parameter policy
# ---------------------------------------------------------------------------

# (regex on path tail, base rank, spec for the trailing `base rank` dims).
# `D` is replaced by the data axis in train mode / None in serve mode.
_PARAM_RULES: List[Tuple[str, int, Tuple]] = [
    (r"moe/(w_up|w_gate)(/q)?$", 3, ("model", "D", None)),  # (E,d,de) E%model
    (r"moe/w_down(/q)?$", 3, ("model", None, "D")),      # (E, de, d)
    (r"moe/router$", 2, ("D", None)),
    (r"shared/(w_up|w_gate)$", 2, ("D", "model")),
    (r"shared/w_down$", 2, ("model", "D")),
    (r"(wq|wk|wv|wg|w_up|w_gate|w1|in_proj|z_proj|xbc_proj|dt_proj|frontend_proj)$", 2,
     ("D", "model")),
    (r"(wo|w_down|w2|out_proj)$", 2, ("model", "D")),
    (r"embed$", 2, ("model", "D")),
    (r"lm_head$", 2, ("D", "model")),
    (r"value_head$", 2, (None, None)),
    (r"conv_w$", 2, (None, "model")),
    (r"(mu|w_bias|u|gn_w|gn_b|ln1|ln2|ln|ln_f|norm_w|conv_b|A_log|dt_bias"
     r"|D|q_norm|k_norm)$", 1, (None,)),
]

# MoE expert fallback when n_experts % model != 0 (e.g. mixtral 8e on 16):
_MOE_FALLBACK = {
    r"moe/(w_up|w_gate)(/q)?$": (None, "D", "model"),
    r"moe/w_down(/q)?$": (None, "model", "D"),
}


def param_spec(mesh, path: str, shape: Tuple[int, ...], *,
               train: bool,
               record: Optional[List[ShardFallback]] = None) -> tuple:
    for pat, base_rank, spec in _PARAM_RULES:
        if re.search(pat, path):
            lead = len(shape) - base_rank
            if lead < 0:  # e.g. 1D rule hit on scalar
                return ()
            tail_shape = shape[lead:]
            want = tuple("data" if s == "D" else s for s in
                         (tuple(spec)))
            # substitute serve-mode data axis
            want = tuple(None if (w == "data" and not train) else w
                         for w in want)
            # MoE expert fallback
            m = re.search(r"moe/(w_up|w_gate|w_down)(/q)?$", path)
            if m and tail_shape[0] % _axis_size(mesh, "model") != 0:
                for pat2, spec2 in _MOE_FALLBACK.items():
                    if re.search(pat2, path):
                        want = tuple(
                            "data" if s == "D" and train else
                            (None if s == "D" else s) for s in spec2)
                        break
            fitted = fit_spec(mesh, tail_shape, want, record=record,
                              path=path)
            return (None,) * lead + tuple(fitted)
    # fallback: replicate
    return ()


def param_shardings(mesh, params, *, train: bool,
                    record: Optional[List[ShardFallback]] = None):
    """Tree of :class:`NamedSharding` matching a params tree (tensors or
    anything with a ``.shape``)."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(
            mesh, path, tuple(leaf.shape), train=train, record=record)),
        params)


def opt_shardings(mesh, opt_state, *, train: bool = True):
    """m/v mirror params; scalar step replicates."""
    def assign(path, leaf):
        if path.startswith(("m/", "v/")):
            spec = param_spec(mesh, path.split("/", 1)[1],
                              tuple(leaf.shape), train=train)
        else:
            spec = ()
        return NamedSharding(mesh, spec)

    return tree_map_with_path(assign, opt_state)


# ---------------------------------------------------------------------------
# Cache policy (decode)
# ---------------------------------------------------------------------------

_CACHE_RULES: List[Tuple[str, int, Tuple]] = [
    # attention KV: (..., B, C, K, hd): batch->data, sequence->model
    # (also the int8-quantized {q, s} leaves of the same layout)
    (r"/(k|v)(/q)?$", 4, ("data", "model", None, None)),
    (r"/(k|v)/s$", 4, ("data", "model", None, None)),
    (r"/pos$", 2, ("data", None)),
    # rwkv state (..., B, H, hd, hd): heads->model
    (r"/S$", 4, ("data", "model", None, None)),
    (r"/x_prev$", 3, ("data", None, "model")),
    # mamba state (..., B, H, hd, ds) + conv tail (..., B, K-1, dxbc)
    (r"/h$", 4, ("data", "model", None, None)),
    (r"/conv$", 3, ("data", None, "model")),
    (r"next_pos$", 1, ("data",)),
]


def cache_spec(mesh, path: str, shape: Tuple[int, ...],
               record: Optional[List[ShardFallback]] = None) -> tuple:
    for pat, base_rank, spec in _CACHE_RULES:
        if re.search(pat, path):
            lead = len(shape) - base_rank
            fitted = fit_spec(mesh, shape[lead:], spec, record=record,
                              path=path)
            return (None,) * lead + tuple(fitted)
    return ()


def cache_shardings(mesh, cache,
                    record: Optional[List[ShardFallback]] = None):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, cache_spec(
            mesh, path, tuple(leaf.shape), record=record)), cache)


# ---------------------------------------------------------------------------
# Paged-pool policy (the serving engine's KV pool + decode operands)
# ---------------------------------------------------------------------------

def pool_spec(mesh, shape: Tuple[int, ...], *,
              record: Optional[List[ShardFallback]] = None) -> tuple:
    """Serve-mode layout of the paged KV pool
    ``(n_layers, n_pages, page_size, n_kv_heads, head_dim)``: the page
    axis shards over ``model`` (the paged analogue of the contiguous
    cache's sequence->``model`` rule).  Everything that *indexes* the
    pool — block tables, descendant bitmaps, page lists — stays
    replicated, so tree-metadata derivation is mesh-oblivious.
    """
    return fit_spec(mesh, shape, (None, "model", None, None, None),
                    record=record, path="pool/kv")


def engine_batch_spec(mesh, shape: Tuple[int, ...], *,
                      record: Optional[List[ShardFallback]] = None) -> tuple:
    """Decode/prefill host operands: leading (batch) axis -> ``data``
    (``("pod", "data")`` on a multi-pod mesh), trailing axes replicate.
    Pool-indexing metadata (block tables, the tree step's page lists
    and bitmaps) must NOT go through this spec: it stays replicated."""
    dp = batch_axes(mesh)
    return fit_spec(mesh, shape, (dp,) + (None,) * (len(shape) - 1),
                    record=record, path="engine/batch")


# ---------------------------------------------------------------------------
# Batch policy
# ---------------------------------------------------------------------------

def batch_shardings(mesh, batch, *, kind: str):
    """tokens/labels (B,S) -> batch over (pod,data); (3,B,S) positions."""
    dp = batch_axes(mesh)

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        if path == "positions" and len(shape) == 3:
            spec = fit_spec(mesh, shape, (None, dp, None))
        elif len(shape) >= 1:
            spec = fit_spec(mesh, shape, (dp,) + (None,) * (len(shape) - 1))
        else:
            spec = ()
        return NamedSharding(mesh, spec)

    return tree_map_with_path(assign, batch)
