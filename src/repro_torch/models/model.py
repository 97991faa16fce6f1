"""Language model: dense, VLM, encoder, MoE, SSM (mamba2, rwkv6) and
hybrid (zamba2) families (port of ``repro.models.model``).

``LM(cfg)`` is functional like the reference: params are a nested dict
of tensors in the reference layout, so the bridge from reference params
is a plain copy.

  * ``init(generator)``            — parameter init (fp32 master params)
  * ``forward(params, batch)``     — full-sequence logits (+ MoE aux)
  * ``loss(params, batch)``        — CE loss (+ MoE load-balance aux)
  * ``prefill(params, batch, cache_len)`` — last logits + contiguous
                                     KV/state cache
  * ``decode_step(params, tok, cache)``   — one-token step on that cache
  * ``init_cache(batch, cache_len)`` — empty cache tree
  * ``hidden(params, batch)``      — final-layer normed hidden states
  * ``reward(params, batch)``      — PRM scalar head (with_value_head)
  * ``embed_inputs`` / ``logits`` / ``ffn`` / ``*_layer_*`` — the pieces
                                     the paged engine composes

Caches and states are stacked over each group's layers on a leading
axis, in the reference's layout.  ``long_mode`` applies the config's
long-context window; ``quant_kv`` makes ``init_cache`` store K/V as int8;
``remat`` recomputes each layer in the backward pass (the reference's
``jax.checkpoint`` on each scan body).

Family specifics, as in the reference:
  dense/vlm/encoder — GQA attention (+ M-RoPE for VLM, bidirectional
      for encoder) + (Sw)iGLU/GELU MLP.
  moe     — GQA attention + sort-dispatch MoE FFN (models/moe.py).
  ssm     — RWKV6 time-mix + channel-mix (models/rwkv6.py), or Mamba2
      blocks (models/mamba2.py).
  hybrid  — Zamba2: Mamba2 backbone; one *shared* attention+MLP block
      applied after every ``attn_every``-th mamba layer
      (``hybrid_super`` groups, params stacked (count, attn_every, ...)).

Modality frontends (audio/VLM) are stubs, as in the reference: inputs
carry precomputed frame/patch embeddings (``batch["embeds"]``), which a
linear projector (``frontend_proj``) maps to d_model.

dtype flow follows the reference op by op: master params are fp32,
``forward``/``hidden``/``reward`` cast them to the compute type
``cfg.dtype`` first, and ``embed_inputs``/``logits`` cast the embedding
to the compute type where they read it.

``forward``, ``loss``, ``hidden`` and ``reward`` record autograd where
the params require grad (training); the serving callers run them under
``torch.no_grad()``.  The layer groups run as Python loops over the
stacked params (``_scan``), where the reference scans.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from ..device import resolve_device
from . import attention as A
from . import mamba2 as M
from . import moe as MOE
from . import rwkv6 as R
from .layers import dense_init, embed_init, matmul, mlp_apply, mlp_init, \
    per_rank, rms_norm, softmax_cross_entropy, sum_over

Params = Dict[str, Any]

# Set by the dry run (``repro_torch.launch.dryrun``): a spec (the
# entries of the reference's PartitionSpec, e.g. (("data",), None,
# "model")) for the residual stream between layers.  With ``d`` sharded
# on `model` the per-device residual checkpoint shrinks by the model-axis
# size.  Applies to DTensor activations only: each layer's output is
# redistributed to it, as the reference's ``with_sharding_constraint``.
ACT_SHARDING = None


def _lookup(table, tokens):
    """``table[tokens]``.  On DTensors (the dry run) each rank looks up
    its own rows of tokens inside ``local_map``: DTensor's gather over a
    sharded table has no strategy for tokens sharded over two mesh dims.
    A table whose vocab shards over ``model`` stays sharded (each rank
    looks up the tokens of its vocab slice, zeros elsewhere, and the
    ``model`` group sums them: Megatron's vocab-parallel embedding);
    any other table is gathered (``per_rank``)."""
    if not (hasattr(tokens, "device_mesh") or hasattr(table, "device_mesh")):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (table if isinstance(table, DTensor) else tokens).device_mesh
    m_i = mesh.mesh_dim_names.index("model")
    if not (isinstance(table, DTensor) and table.placements[m_i].is_shard(0)
            and isinstance(tokens, DTensor)):
        return per_rank(lambda pl, t: pl["t"][t], {"t": table}, [tokens], 1)
    group = mesh.get_group("model")
    rows = tuple(Shard(0) if i != m_i and p.is_shard(0) else Replicate()
                 for i, p in enumerate(tokens.placements))
    tab = tuple(Shard(0) if i == m_i else Replicate()
                for i in range(mesh.ndim))
    tab_grad = tuple(Shard(0) if i == m_i else
                     (Partial() if rows[i].is_shard() else Replicate())
                     for i in range(mesh.ndim))

    def local(t, tok):
        n = t.shape[0]
        rel = tok.long() - mesh.get_local_rank("model") * n
        ok = (rel >= 0) & (rel < n)
        e = t[rel.clamp(0, n - 1)] * ok[..., None].to(t.dtype)
        return sum_over(e, group)

    return local_map(local, out_placements=list(rows),
                     in_placements=(tab, rows),
                     in_grad_placements=(tab_grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def _constrain_act(x):
    if ACT_SHARDING is None or not hasattr(x, "device_mesh"):
        return x
    from ..launch.sharding import fit_spec, placements
    mesh = x.device_mesh
    spec = fit_spec(mesh, tuple(x.shape), ACT_SHARDING)
    return x.redistribute(mesh, placements(mesh, spec))


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensor leaves of a nested dict/list, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over every leaf, ``path`` the leaf's keys and
    list indices joined by ``/`` (``"groups/0/attn/wq"``), as the
    reference's sharding policy names jax tree paths."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}/{k}" if path
                                      else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}/{i}" if path
                                             else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def layer_slice(group: Params, l: int) -> Params:
    """Layer ``l``'s params out of a stacked (L, ...) group."""
    return tree_map(lambda a: a[l], group)


def _stack_init(fn: Callable[[], Params], n: int) -> Params:
    """Stack n param trees along a new leading axis.  The stack is
    allocated once and filled tree by tree, so the peak is the stack
    plus one tree (not two copies of the stack)."""
    first = fn()
    out = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i] = src

    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, fn(), i)
    return out


def compute_dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class LM:
    def __init__(self, cfg, *, long_mode: bool = False,
                 with_value_head: bool = False, remat: bool = True,
                 quant_kv: bool = False, device=None):
        self.cfg = cfg
        self.long_mode = long_mode
        self.with_value_head = with_value_head
        self.remat = remat
        self.quant_kv = quant_kv   # int8 K/V in init_cache
        self.device = resolve_device(device)
        # fp32 products on the card run in full fp32, as the reference
        # computes them: TF32 keeps ~3 decimal digits and would break the
        # fp32 parity the port is held to.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.plan = cfg.layer_plan()
        self.compute_dtype = compute_dtype_of(cfg)

    @property
    def window(self) -> int:
        """Effective attention window (0 = unlimited): the long-context
        window in long mode where the config has one, else
        ``cfg.sliding_window``."""
        cfg = self.cfg
        if self.long_mode and cfg.long_context_window:
            return cfg.long_context_window
        return cfg.sliding_window

    def attn_cache_len(self, seq_len: int) -> int:
        """Cache length an attention layer needs for ``seq_len``."""
        w = self.window
        return min(seq_len, w) if w else seq_len

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Fresh fp32 params on ``generator.device`` (same shapes and
        scales as the reference init; another random stream)."""
        cfg = self.cfg
        dt = torch.float32   # master params fp32; cast at apply time
        dev = generator.device
        p: Params = {"embed": embed_init(generator, cfg.vocab_size,
                                         cfg.d_model, dt)}
        if cfg.frontend_dim:
            p["frontend_proj"] = dense_init(generator, cfg.frontend_dim,
                                            cfg.d_model, dt)

        def ones():
            return torch.ones((cfg.d_model,), dtype=dt, device=dev)

        def attn_block():
            blk = {"ln1": ones(), "attn": A.attn_init(generator, cfg, dt),
                   "ln2": ones()}
            if cfg.arch_type == "moe":
                blk["moe"] = MOE.moe_init(generator, cfg, dt)
            else:
                blk["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff,
                                      cfg.act, dt)
            return blk

        def wkv_block():
            return {"ln1": ones(), "time_mix": R.rwkv_init(generator, cfg, dt),
                    "ln2": ones(),
                    "channel_mix": R.channel_mix_init(generator, cfg, dt)}

        def mamba_block():
            return {"ln": ones(), "mamba": M.mamba_init(generator, cfg, dt)}

        groups = []
        for kind, count in self.plan:
            if kind == "attn":
                groups.append(_stack_init(attn_block, count))
            elif kind == "wkv":
                groups.append(_stack_init(wkv_block, count))
            elif kind == "mamba":
                groups.append(_stack_init(mamba_block, count))
            elif kind == "hybrid_super":
                k_inner = cfg.attn_every
                groups.append(_stack_init(
                    lambda: _stack_init(mamba_block, k_inner), count))
            else:
                raise ValueError(kind)
        p["groups"] = groups
        if cfg.arch_type == "hybrid":
            p["shared_attn"] = attn_block()
        p["ln_f"] = ones()
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                      dt)
        if self.with_value_head:
            p["value_head"] = dense_init(generator, cfg.d_model, 1, dt)
        return p

    # ------------------------------------------------------------------
    # Param casting: master params stay fp32; compute in cfg.dtype
    # ------------------------------------------------------------------
    def cast_params(self, p: Params) -> Params:
        cdt = self.compute_dtype

        def cast(x):
            if x.is_floating_point() and x.dtype != cdt:
                return x.to(cdt)
            return x

        return tree_map(cast, p)

    # ------------------------------------------------------------------
    # Input embedding / output head
    # ------------------------------------------------------------------
    def embed_inputs(self, p: Params, batch: Dict[str, Any]):
        """Returns (x (B,S,d), positions (B,S), or (3,B,S) for M-RoPE).

        ``batch["embeds"]`` (B,S_f,frontend_dim), when given, is
        projected by ``frontend_proj`` and placed before the token
        embeddings; either part may be absent.  Without
        ``batch["positions"]`` the positions count 0..S-1, broadcast to
        the three M-RoPE streams where the config has sections."""
        cdt = self.compute_dtype
        parts = []
        if batch.get("embeds") is not None:
            parts.append(matmul(batch["embeds"].to(cdt),
                                p["frontend_proj"].to(cdt)))
        if batch.get("tokens") is not None:
            parts.append(_lookup(p["embed"].to(cdt), batch["tokens"]))
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        B, S = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
            if self.cfg.mrope_sections:
                positions = positions.expand(3, B, S)
        return x, positions

    def logits(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(p["ln_f"], x, self.cfg.norm_eps)
        head = p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]
        return matmul(x, head.to(self.compute_dtype))

    # ------------------------------------------------------------------
    # Layer bodies (full sequence, zero initial state)
    # ------------------------------------------------------------------
    def ffn(self, blk: Params, h: torch.Tensor):
        """The block's FFN: dense MLP, or MoE over the flattened tokens.
        Returns (y, aux)."""
        cfg = self.cfg
        if "moe" in blk:
            shp = h.shape
            y, aux = MOE.moe_apply_auto(blk["moe"], h.reshape(-1, shp[-1]),
                                        cfg)
            return y.reshape(shp), aux
        return mlp_apply(blk["mlp"], h, cfg.act), 0.0

    def _attn_layer_full(self, blk: Params, x, positions,
                         cache_len: Optional[int] = None):
        """Attention + FFN block over the whole sequence.  Returns (x,
        cache, aux): without ``cache_len`` attention masks with the
        effective window and the cache is None; with it, ``attn_prefill``
        fills a cache of ``cache_len`` slots (masks with
        ``cfg.sliding_window``, as the reference's prefill does)."""
        cfg = self.cfg
        h = rms_norm(blk["ln1"], x, cfg.norm_eps)
        if cache_len is None:
            y = A.attn_full(blk["attn"], h, cfg, positions,
                            window_override=self.window)
            cache = None
        else:
            y, cache = A.attn_prefill(blk["attn"], h, cfg, positions,
                                      cache_len,
                                      cache_dtype=self.compute_dtype)
        x = x + y
        h = rms_norm(blk["ln2"], x, cfg.norm_eps)
        y, aux = self.ffn(blk, h)
        return x + y, cache, aux

    def wkv_layer_full(self, blk: Params, x, state, lengths=None):
        """RWKV6 block over a (right-padded) sequence: time-mix, then
        channel-mix with its own token shift of the normed stream.
        Returns (x, new state); with ``lengths`` the state is exactly
        the post-prefix state of each row."""
        cfg = self.cfg
        B, T, d = x.shape
        h = rms_norm(blk["ln1"], x, cfg.norm_eps)
        y, tm_new = R.rwkv_apply_full(blk["time_mix"], h, cfg, state,
                                      lengths=lengths)
        x = x + y
        h2 = rms_norm(blk["ln2"], x, cfg.norm_eps)
        shift = torch.cat([state["x_prev"][:, 1:2].to(h2.dtype), h2[:, :-1]],
                          dim=1)
        y = R.channel_mix_apply(blk["channel_mix"], h2, shift)
        # channel-mix shift state: h2 at the last valid position
        if lengths is None:
            last = h2[:, -1]
        else:
            idx = torch.clamp(lengths.long() - 1, min=0)
            last = h2[torch.arange(B, device=x.device), idx]
            last = torch.where((lengths > 0)[:, None], last,
                               state["x_prev"][:, 1].to(h2.dtype))
        x_prev = torch.stack([tm_new["x_prev"][:, 0],
                              last.to(tm_new["x_prev"].dtype)], dim=1)
        return x + y, {"S": tm_new["S"], "x_prev": x_prev}

    def wkv_layer_decode(self, blk: Params, x, state):
        """RWKV6 block, one token.  x (B,1,d)."""
        cfg = self.cfg
        h = rms_norm(blk["ln1"], x, cfg.norm_eps)
        y, tm_new = R.rwkv_decode_step(blk["time_mix"], h, cfg, state)
        x = x + y
        h = rms_norm(blk["ln2"], x, cfg.norm_eps)
        shift = state["x_prev"][:, 1:2].to(h.dtype)
        y = R.channel_mix_apply(blk["channel_mix"], h, shift)
        x_prev = torch.stack([tm_new["x_prev"][:, 0],
                              h[:, 0].to(tm_new["x_prev"].dtype)], dim=1)
        return x + y, {"S": tm_new["S"], "x_prev": x_prev}

    def mamba_layer_full(self, blk: Params, x, state, lengths=None):
        h = rms_norm(blk["ln"], x, self.cfg.norm_eps)
        y, new = M.mamba_apply_full(blk["mamba"], h, self.cfg, state,
                                    lengths=lengths)
        return x + y, new

    def mamba_layer_decode(self, blk: Params, x, state):
        h = rms_norm(blk["ln"], x, self.cfg.norm_eps)
        y, new = M.mamba_decode_step(blk["mamba"], h, self.cfg, state)
        return x + y, new

    # ------------------------------------------------------------------
    # Full-sequence pass (train / prefill)
    # ------------------------------------------------------------------
    def _run_full(self, p: Params, x, positions, *,
                  cache_len: Optional[int] = None, init_states=None,
                  remat: bool = False):
        """Every layer group over the whole sequence.  Returns (x,
        per-group caches, total MoE aux).

        With ``cache_len`` (prefill) each group's cache is stacked over
        its layers as in the reference: attention ``{"k","v","pos"}``
        of ``attn_cache_len(cache_len)`` slots, rwkv ``{"S","x_prev"}``,
        mamba ``{"h","conv"}``, hybrid ``{"mamba", "attn"}``; without
        it the caches are None.  ``init_states`` (per group, stacked)
        replaces the zero recurrent states.  ``remat`` recomputes each
        layer (each hybrid super-block) in the backward pass instead of
        saving its activations, where autograd records."""
        cfg = self.cfg
        B = x.shape[0]
        x = _constrain_act(x)
        keep = cache_len is not None
        attn_clen = self.attn_cache_len(cache_len) if keep else None
        ckpt = _checkpointed if remat and torch.is_grad_enabled() \
            else _called
        caches = []
        aux_total = 0.0

        def state(gstate, l, init):
            return init() if gstate is None else layer_slice(gstate, l)

        def rwkv_init():
            return R.init_rwkv_state(cfg, B, device=x.device)

        def mamba_init():
            return M.init_mamba_state(cfg, B, device=x.device)

        for gi, (kind, count) in enumerate(self.plan):
            gp = p["groups"][gi]
            gstate = None if init_states is None else init_states[gi]
            if kind == "attn":
                def body(carry, l):
                    x, aux = carry
                    x, cache, a = ckpt(self._attn_layer_full,
                                       layer_slice(gp, l), x, positions,
                                       attn_clen)
                    return (_constrain_act(x), aux + a), cache

                (x, aux_total), cache = _scan(body, (x, aux_total), count,
                                              keep)
                caches.append(cache)
            elif kind in ("wkv", "mamba"):
                layer, init = (self.wkv_layer_full, rwkv_init) \
                    if kind == "wkv" else (self.mamba_layer_full, mamba_init)

                def body(x, l):
                    x, new = ckpt(layer, layer_slice(gp, l), x,
                                  state(gstate, l, init))
                    return _constrain_act(x), new

                x, new_states = _scan(body, x, count, keep)
                caches.append(new_states)
            elif kind == "hybrid_super":
                k_inner = cfg.attn_every
                shared = p["shared_attn"]
                mstates = None if gstate is None else gstate["mamba"]

                def super_block(blk, x, mstate):
                    def inner(x, j):
                        return self.mamba_layer_full(
                            layer_slice(blk, j), x,
                            state(mstate, j, mamba_init))

                    x, m_new = _scan(inner, x, k_inner, keep)
                    x, cache, _ = self._attn_layer_full(shared, x, positions,
                                                        attn_clen)
                    return x, {"mamba": m_new, "attn": cache}

                def body(x, l):
                    x, new = ckpt(super_block, layer_slice(gp, l), x,
                                  None if mstates is None
                                  else layer_slice(mstates, l))
                    return _constrain_act(x), new

                x, new = _scan(body, x, count, keep)
                caches.append(new)
            else:
                raise ValueError(kind)
        return x, (caches if keep else None), aux_total

    # ------------------------------------------------------------------
    # Public: train forward / loss
    # ------------------------------------------------------------------
    def forward(self, p: Params, batch: Dict[str, Any]):
        """Full-sequence logits (B,S,V) and the MoE aux loss (0 for
        the other families)."""
        p = self.cast_params(p)
        x, positions = self.embed_inputs(p, batch)
        x, _, aux = self._run_full(p, x, positions, remat=self.remat)
        return self.logits(p, x), aux

    def loss(self, p: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """Next-token CE over ``batch["labels"]`` (masked by
        ``loss_mask``) plus ``load_balance_coef`` x the MoE aux loss
        summed over layers."""
        logits, aux = self.forward(p, batch)
        labels = batch["labels"]
        # align: logits for positions covering the label span (suffix)
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]
        ce = softmax_cross_entropy(logits, labels, batch.get("loss_mask"))
        lb = self.cfg.moe.load_balance_coef if self.cfg.moe else 0.0
        return ce + lb * aux

    def hidden(self, p: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """Final-layer hidden states (B, S, d) — embedder API."""
        p = self.cast_params(p)
        x, positions = self.embed_inputs(p, batch)
        x, _, _ = self._run_full(p, x, positions)
        return rms_norm(p["ln_f"], x, self.cfg.norm_eps)

    def reward(self, p: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """PRM: per-position scalar scores (B, S), float32."""
        if not self.with_value_head:
            raise ValueError("reward needs a model built with_value_head")
        p = self.cast_params(p)
        x, positions = self.embed_inputs(p, batch)
        x, _, _ = self._run_full(p, x, positions)
        x = rms_norm(p["ln_f"], x, self.cfg.norm_eps)
        v = matmul(x, p["value_head"].to(x.dtype))[..., 0]
        return torch.sigmoid(v.float())

    # ------------------------------------------------------------------
    # Public: contiguous cache — prefill, init_cache, decode_step
    # ------------------------------------------------------------------
    def prefill(self, p: Params, batch: Dict[str, Any], cache_len: int):
        """Returns (last-token logits (B,V), cache).  ``batch`` as for
        ``forward`` (multimodal ``embeds`` and (3,B,S) positions too);
        the cache's ``next_pos`` is one past the last position (stream
        0 for M-RoPE)."""
        p = self.cast_params(p)
        x, positions = self.embed_inputs(p, batch)
        x, caches, _ = self._run_full(p, x, positions, cache_len=cache_len)
        pos2d = positions if positions.dim() == 2 else positions[0]
        cache = {"groups": caches, "next_pos": pos2d[:, -1] + 1}
        return self.logits(p, x[:, -1]), cache

    def init_cache(self, batch: int, cache_len: int, device=None):
        """Empty cache for ``batch`` sequences of up to ``cache_len``
        tokens (attention groups hold ``attn_cache_len(cache_len)``
        slots, int8 with ``quant_kv``), on ``device`` (default the
        model's; ``"meta"`` allocates nothing)."""
        cfg = self.cfg
        dev = self.device if device is None else device
        clen = self.attn_cache_len(cache_len)

        def kv():
            return A.init_kv_cache(cfg, batch, clen, self.compute_dtype,
                                   quant=self.quant_kv, device=dev)

        def rwkv():
            return R.init_rwkv_state(cfg, batch, device=dev)

        def mamba():
            return M.init_mamba_state(cfg, batch, device=dev)

        caches = []
        for kind, count in self.plan:
            if kind == "attn":
                caches.append(_stack_init(kv, count))
            elif kind == "wkv":
                caches.append(_stack_init(rwkv, count))
            elif kind == "mamba":
                caches.append(_stack_init(mamba, count))
            elif kind == "hybrid_super":
                caches.append({
                    "mamba": _stack_init(
                        lambda: _stack_init(mamba, cfg.attn_every), count),
                    "attn": _stack_init(kv, count)})
            else:
                raise ValueError(kind)
        return {"groups": caches,
                "next_pos": torch.zeros((batch,), dtype=torch.int32,
                                        device=dev)}

    def decode_step(self, p: Params, tokens, cache, write_pos=None):
        """One-token decode.  tokens (B,1) -> (logits (B,V), new cache);
        the token goes to ``write_pos`` (default ``cache["next_pos"]``).
        The cache given is not modified."""
        cfg = self.cfg
        p = self.cast_params(p)
        if write_pos is None:
            write_pos = cache["next_pos"]
        x = _lookup(p["embed"].to(self.compute_dtype), tokens)    # (B,1,d)
        new_caches = []
        for gi, (kind, count) in enumerate(self.plan):
            gp = p["groups"][gi]
            gc = cache["groups"][gi]
            if kind == "attn":
                def body(x, l):
                    return self._attn_layer_decode(
                        layer_slice(gp, l), x, layer_slice(gc, l),
                        write_pos)
            elif kind in ("wkv", "mamba"):
                layer = self.wkv_layer_decode if kind == "wkv" \
                    else self.mamba_layer_decode

                def body(x, l):
                    return layer(layer_slice(gp, l), x, layer_slice(gc, l))
            elif kind == "hybrid_super":
                def body(x, l):
                    blk, mstate = layer_slice(gp, l), \
                        layer_slice(gc["mamba"], l)
                    x, m_new = _scan(
                        lambda x, j: self.mamba_layer_decode(
                            layer_slice(blk, j), x, layer_slice(mstate, j)),
                        x, cfg.attn_every, True)
                    x, a_new = self._attn_layer_decode(
                        p["shared_attn"], x, layer_slice(gc["attn"], l),
                        write_pos)
                    return x, {"mamba": m_new, "attn": a_new}
            else:
                raise ValueError(kind)
            x, c_new = _scan(body, x, count, True)
            new_caches.append(c_new)
        logits = self.logits(p, x[:, 0])
        return logits, {"groups": new_caches, "next_pos": write_pos + 1}

    def _attn_layer_decode(self, blk: Params, x, c, write_pos):
        """Attention + FFN block, one token against its cache."""
        cfg = self.cfg
        h = rms_norm(blk["ln1"], x, cfg.norm_eps)
        y, c_new = self._attn_decode(blk["attn"], h, c, write_pos)
        x = x + y
        h = rms_norm(blk["ln2"], x, cfg.norm_eps)
        y, _ = self.ffn(blk, h)
        return x + y, c_new

    def _attn_decode(self, ap, h, c, write_pos):
        """Decode attention honouring the effective window."""
        cfg = self.cfg
        if self.window and not cfg.sliding_window:
            # long-mode override: pretend cfg has the window for masking
            cfg = dataclasses.replace(cfg, sliding_window=self.window)
        return A.attn_decode(ap, h, cfg, c, write_pos)


def _called(fn, *args):
    return fn(*args)


def _checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    (the reference's ``jax.checkpoint``; no dropout, so the recompute is
    the same computation)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _put(dst, src, i: int) -> None:
    """Write tree ``src`` into slot ``i`` of the stacked tree ``dst``."""
    if isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k], i)
    else:
        dst[i] = src


def _scan(body: Callable, carry, n: int, keep: bool):
    """``lax.scan`` over layers 0..n-1: ``body(carry, l) -> (carry, y)``.
    With ``keep`` the ys are stacked on a new leading axis, each written
    into the stack as its layer gives it (the peak is the stack plus one
    layer's y, not two copies); else they are dropped (None).  DTensor
    ys (the dry run) are stacked at the end instead: an empty stack of
    them would be replicated, and the stack keeps their shards."""
    out, ys = None, []
    for l in range(n):
        carry, y = body(carry, l)
        if keep and hasattr(tree_leaves(y)[0], "device_mesh"):
            ys.append(y)
        elif keep:
            if out is None:
                out = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)),
                               y)
            _put(out, y, l)
    if ys:
        it = [iter(tree_leaves(y)) for y in ys]
        out = tree_map(lambda _: torch.stack([next(i) for i in it]), ys[0])
    return carry, out


def build_model(cfg, **kw) -> LM:
    return LM(cfg, **kw)
