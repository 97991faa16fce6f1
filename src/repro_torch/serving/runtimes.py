"""Per-layer-group runtimes: the engine <-> model-family contract (port
of ``repro.serving.runtimes``).

The engine threads the residual stream through a stack of runtimes, one
per ``cfg.layer_plan()`` group:

  * :class:`AttentionRuntime` — dense GQA layers: the per-layer math of
    the reference engine body, op by op, with the pool writes in place
    and the attention through the kernel seam (``kernels/ops.py``).  A
    streamed prefill segment attends with the plain masked attention
    over the history it gathers from the pool, as the reference does.
  * :class:`MoERuntime` — the same attention, the MoE FFN.
  * :class:`RecurrentRuntime` — mamba2 (SSD) or rwkv6 (wkv) mixers.
    Their constant-size per-sequence state lives in a ``StatePool``, one
    page per sequence; rows address it through ``ctx.state_rows`` (the
    dump page for inactive rows), as KV rows address the paged pool
    through block tables.
  * :class:`HybridRuntime` — Zamba2 super-layers: ``attn_every`` mamba
    mixers, then the one *shared* attention+MLP block, whose KV for
    super-layer ``l`` lives at pool layer ``kv_offset + l``.

Each runtime's ``decode_step`` / ``prefill_into_pool`` /
``prefill_streamed`` take ``(params, x, ctx, pool_k, pool_v, state)``,
write KV and state in place and return the residual stream.  ``state``
is the state pool's tensors (``{name: (L, n_pages, ...)}``, empty for
attention-only stacks).  Prefill runs the masked chunked scan (identity
steps past ``ctx.lengths``), so a right-padded bucket leaves each row's
exact post-prompt state; a streamed segment reads the running state from
the pool and writes it back (a fresh page is the zero, empty-history
state).  State is gathered and scattered one layer at a time, so no
step holds more than one layer's state of its rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..kernels import ops
from ..models import attention as A
from ..models.layers import (apply_rope, matmul, mlp_apply, rms_norm,
                             rope_angles)
from ..models import mamba2 as M
from ..models import rwkv6 as R
from ..models.model import layer_slice


@dataclass
class DecodeCtx:
    """One lock-step decode iteration's per-row operands."""
    lengths: torch.Tensor   # (B,) context length == new token's position
    pages: torch.Tensor     # (B,) physical write page (dump for inactive)
    slots: torch.Tensor     # (B,) in-page write slot
    attend: Callable        # attend(kv_layer, q (B,H,hd), pool_k, pool_v)
    state_rows: Optional[torch.Tensor] = None   # (B,) state page per row


@dataclass
class PrefillCtx:
    """A right-padded prefill bucket, or one streamed segment."""
    positions: torch.Tensor   # (B,T), -1 at padded slots
    pos: torch.Tensor         # rope positions: positions, or (3,B,T)
    #                           for M-RoPE
    pages: torch.Tensor       # (B,T) write pages (dump at padding)
    slots: torch.Tensor       # (B,T) write slots
    lengths: torch.Tensor     # (B,) valid tokens per row
    hist_table: Optional[torch.Tensor] = None   # streamed: (B,Tp) block
    #                                             table, pow2 padded
    hist_len: int = 0         # streamed: tokens already in the pool
    state_rows: Optional[torch.Tensor] = None   # (B,) state page per row


def _attn_decode_layer(cfg, blk, x, ctx: DecodeCtx, kv_l, pool_k, pool_v,
                       ffn):
    """One attention layer of a lock-step decode: project/rope the new
    token, write its K/V at the reserved pool slot (in place), attend
    via ``ctx.attend``.  Only the attention runs in the pool's dtype; its
    output returns to q's (the projections'), as in prefill."""
    B = x.shape[0]
    h = rms_norm(blk["ln1"], x, cfg.norm_eps)
    ap = blk["attn"]
    hd = cfg.head_dim
    q = matmul(h, ap["wq"]).reshape(B, 1, cfg.n_heads, hd)
    k = matmul(h, ap["wk"]).reshape(B, 1, cfg.n_kv_heads, hd)
    v = matmul(h, ap["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(ap["q_norm"], q, cfg.norm_eps)
        k = rms_norm(ap["k_norm"], k, cfg.norm_eps)
    # plain RoPE on the context length, M-RoPE models included: for
    # text the three streams are equal, which is exactly plain RoPE
    ang = rope_angles(ctx.lengths[:, None], hd, cfg.rope_theta)
    q = apply_rope(q, ang)
    k = apply_rope(k, ang)
    pool_k[kv_l, ctx.pages, ctx.slots] = k[:, 0].to(pool_k.dtype)
    pool_v[kv_l, ctx.pages, ctx.slots] = v[:, 0].to(pool_v.dtype)
    # the kernels take q in the pool's dtype; wo takes q's, as in prefill
    y = ctx.attend(kv_l, q[:, 0].to(pool_k.dtype).contiguous(), pool_k,
                   pool_v).to(q.dtype)
    x = x + matmul(y.reshape(B, 1, -1), ap["wo"])
    h = rms_norm(blk["ln2"], x, cfg.norm_eps)
    return x + ffn(blk, h)


def _attn_prefill_layer(cfg, blk, x, ctx: PrefillCtx, kv_l, pool_k, pool_v,
                        ffn, dense: bool = False):
    """One attention layer of a one-shot prefill bucket: K/V go straight
    into the pool pages, attention runs the flash-prefill kernel seam, or
    with ``dense`` the plain masked attention (the reference's oracle)."""
    B, T = x.shape[:2]
    scale = cfg.head_dim ** -0.5
    h = rms_norm(blk["ln1"], x, cfg.norm_eps)
    q, k, v = A._project_qkv(blk["attn"], h, cfg, ctx.pos)
    pool_k[kv_l, ctx.pages, ctx.slots] = k.to(pool_k.dtype)
    pool_v[kv_l, ctx.pages, ctx.slots] = v.to(pool_v.dtype)
    if dense:
        mask = A.make_mask(ctx.positions, ctx.positions, causal=cfg.causal,
                           window=cfg.sliding_window)
        y = A.masked_attention(q, k, v, mask, scale=scale)
    else:
        y = ops.flash_prefill(q.contiguous(), k.contiguous(),
                              v.contiguous(), scale=scale, causal=cfg.causal,
                              window=cfg.sliding_window)
    x = x + matmul(y.reshape(B, T, -1), blk["attn"]["wo"])
    h = rms_norm(blk["ln2"], x, cfg.norm_eps)
    return x + ffn(blk, h)


def _streamed_hist(cfg, ctx: PrefillCtx, page_size: int):
    """History gather indices (B, Lh) and the (B, Ts, Lh + Ts) mask of
    one streamed segment: history slots count up to ``hist_len`` by
    absolute position (padded table entries and page tails beyond it are
    masked), then the segment itself, causally."""
    B = ctx.positions.shape[0]
    dev = ctx.positions.device
    Lh = ctx.hist_table.shape[1] * page_size
    hist_idx = (torch.clamp(ctx.hist_table, min=0)[:, :, None] * page_size
                + torch.arange(page_size, device=dev)[None, None, :]
                ).reshape(B, Lh)
    ar = torch.arange(Lh, device=dev)
    hist_pos = torch.where(ar < ctx.hist_len, ar, -1)[None].expand(B, Lh)
    mask_h = A.make_mask(ctx.positions, hist_pos, causal=cfg.causal,
                         window=cfg.sliding_window)
    mask_s = A.make_mask(ctx.positions, ctx.positions, causal=cfg.causal,
                         window=cfg.sliding_window)
    return hist_idx, torch.cat([mask_h, mask_s], dim=-1)


def _attn_streamed_layer(cfg, blk, x, ctx: PrefillCtx, kv_l, pool_k, pool_v,
                         ffn, hist_idx, mask):
    """One attention layer of a streamed prefill segment: the segment's
    K/V go into the pool (in place), its queries attend over the
    history gathered from the pool plus the segment itself, with the
    plain masked attention (the reference runs no kernel here)."""
    B, Ts = x.shape[:2]
    scale = cfg.head_dim ** -0.5
    h = rms_norm(blk["ln1"], x, cfg.norm_eps)
    q, k, v = A._project_qkv(blk["attn"], h, cfg, ctx.pos)
    pool_k[kv_l, ctx.pages, ctx.slots] = k.to(pool_k.dtype)
    pool_v[kv_l, ctx.pages, ctx.slots] = v.to(pool_v.dtype)
    K, hd = k.shape[2], k.shape[3]
    hk = pool_k[kv_l].reshape(-1, K, hd)[hist_idx]      # (B, Lh, K, hd)
    hv = pool_v[kv_l].reshape(-1, K, hd)[hist_idx]
    kk = torch.cat([hk.to(k.dtype), k], dim=1)
    vv = torch.cat([hv.to(v.dtype), v], dim=1)
    y = A.masked_attention(q, kk, vv, mask, scale=scale)
    x = x + matmul(y.reshape(B, Ts, -1), blk["attn"]["wo"])
    h = rms_norm(blk["ln2"], x, cfg.norm_eps)
    return x + ffn(blk, h)


class LayerRuntime:
    """One homogeneous layer group's serving behaviour.

    ``n_kv_layers`` is the group's footprint in the paged KV pool's
    layer axis (0 for recurrent groups); ``state_specs()`` declares its
    state-pool tensors as ``name -> (n_layers, per_page_shape, dtype)``.
    """

    kind = ""
    n_kv_layers = 0

    def __init__(self, model, gi: int, count: int, dense: bool = False):
        self.model = model
        self.cfg = model.cfg
        self.gi = gi
        self.count = count
        self.dense = dense          # prefill="dense": the masked oracle

    def state_specs(self) -> Dict[str, tuple]:
        return {}

    # -- recurrent-state plumbing (the stateful runtimes) --------------
    _names: tuple = ()

    def _read(self, state, l: int, rows) -> dict:
        """Layer ``l``'s state of ``rows``: {name: (B, ...)}."""
        return {n: state[f"{self.gi}:{n}"][l, rows] for n in self._names}

    def _write(self, state, l: int, rows, new: dict) -> None:
        for n in self._names:
            a = state[f"{self.gi}:{n}"]
            a[l, rows] = new[n].to(a.dtype)


class AttentionRuntime(LayerRuntime):
    """Dense GQA layers over the paged pool, addressed at
    ``kv_offset .. kv_offset+count`` in the pool's layer axis."""

    kind = "attn"

    def __init__(self, model, gi: int, count: int, kv_offset: int,
                 dense: bool = False):
        super().__init__(model, gi, count, dense)
        self.kv_offset = kv_offset
        self.n_kv_layers = count

    def _ffn(self, blk, h):
        return mlp_apply(blk["mlp"], h, self.cfg.act)

    def decode_step(self, params, x, ctx: DecodeCtx, pool_k, pool_v, state):
        gp = params["groups"][self.gi]
        for l in range(self.count):
            x = _attn_decode_layer(self.cfg, layer_slice(gp, l), x, ctx,
                                   self.kv_offset + l, pool_k, pool_v,
                                   self._ffn)
        return x

    def prefill_into_pool(self, params, x, ctx: PrefillCtx, pool_k, pool_v,
                          state):
        gp = params["groups"][self.gi]
        for l in range(self.count):
            x = _attn_prefill_layer(self.cfg, layer_slice(gp, l), x, ctx,
                                    self.kv_offset + l, pool_k, pool_v,
                                    self._ffn, self.dense)
        return x

    def prefill_streamed(self, params, x, ctx: PrefillCtx, pool_k, pool_v,
                         state):
        hist_idx, mask = _streamed_hist(self.cfg, ctx, pool_k.shape[2])
        gp = params["groups"][self.gi]
        for l in range(self.count):
            x = _attn_streamed_layer(self.cfg, layer_slice(gp, l), x, ctx,
                                     self.kv_offset + l, pool_k, pool_v,
                                     self._ffn, hist_idx, mask)
        return x


class MoERuntime(AttentionRuntime):
    """MoE layers (mixtral, deepseek-moe): the attention and KV of
    :class:`AttentionRuntime`, the sort-dispatch MoE FFN.  Routing is per
    token, so one lock-step decode serves every live branch."""

    kind = "moe"

    def _ffn(self, blk, h):
        return self.model.ffn(blk, h)[0]


def _state_proto(cfg, flavor: str) -> dict:
    if flavor == "mamba":
        return M.init_mamba_state(cfg, 1, device="meta")
    return R.init_rwkv_state(cfg, 1, device="meta")


class RecurrentRuntime(LayerRuntime):
    """mamba2 / rwkv6 layer groups: no KV pages; per-sequence constant
    state in the state pool.  Decode runs the models' one-token step,
    prefill the masked chunked scan, so right-padded buckets produce the
    exact post-prompt state."""

    def __init__(self, model, gi: int, count: int, flavor: str):
        super().__init__(model, gi, count)
        if flavor not in ("mamba", "wkv"):
            raise ValueError(flavor)
        self.flavor = flavor
        self.kind = flavor
        self._proto = _state_proto(self.cfg, flavor)
        self._names = tuple(sorted(self._proto))

    def state_specs(self):
        return {f"{self.gi}:{n}": (self.count, tuple(v.shape[1:]), v.dtype)
                for n, v in self._proto.items()}

    def decode_step(self, params, x, ctx: DecodeCtx, pool_k, pool_v, state):
        model = self.model
        step = model.mamba_layer_decode if self.flavor == "mamba" \
            else model.wkv_layer_decode
        gp = params["groups"][self.gi]
        rows = ctx.state_rows
        for l in range(self.count):
            x, new = step(layer_slice(gp, l), x, self._read(state, l, rows))
            self._write(state, l, rows, new)
        return x

    def prefill_into_pool(self, params, x, ctx: PrefillCtx, pool_k, pool_v,
                          state):
        model = self.model
        full = model.mamba_layer_full if self.flavor == "mamba" \
            else model.wkv_layer_full
        gp = params["groups"][self.gi]
        rows = ctx.state_rows
        for l in range(self.count):
            x, new = full(layer_slice(gp, l), x, self._read(state, l, rows),
                          lengths=ctx.lengths)
            self._write(state, l, rows, new)
        return x

    # a streamed segment reads the running state from the pool and
    # writes it back — the same as a one-shot bucket (a zeroed fresh
    # page makes segment 0 the empty-history state)
    prefill_streamed = prefill_into_pool


class HybridRuntime(LayerRuntime):
    """Zamba2 super-layers: ``attn_every`` mamba mixers, then the shared
    attention+MLP block served through the paged pool — KV pool layer
    ``kv_offset + l`` holds super-layer ``l``'s shared-attention KV, and
    state layer ``l * attn_every + j`` its j-th mamba mixer's state."""

    kind = "hybrid"

    def __init__(self, model, gi: int, count: int, kv_offset: int,
                 dense: bool = False):
        super().__init__(model, gi, count, dense)
        self.kv_offset = kv_offset
        self.n_kv_layers = count
        self.k_inner = self.cfg.attn_every
        self._proto = _state_proto(self.cfg, "mamba")
        self._names = tuple(sorted(self._proto))

    def state_specs(self):
        L = self.count * self.k_inner
        return {f"{self.gi}:{n}": (L, tuple(v.shape[1:]), v.dtype)
                for n, v in self._proto.items()}

    def _run(self, params, x, state, rows, mamba, attn):
        """Per super-layer: the inner mamba layers (``mamba(blk, x,
        state) -> (x, new)``), then the shared block (``attn(blk, x,
        kv_layer) -> x``)."""
        gp = params["groups"][self.gi]     # leaves (count, k_inner, ...)
        shared = params["shared_attn"]
        for l in range(self.count):
            blk = layer_slice(gp, l)
            for j in range(self.k_inner):
                sl = l * self.k_inner + j
                x, new = mamba(layer_slice(blk, j), x,
                               self._read(state, sl, rows))
                self._write(state, sl, rows, new)
            x = attn(shared, x, self.kv_offset + l)
        return x

    def _mlp(self, blk, h):
        return mlp_apply(blk["mlp"], h, self.cfg.act)

    def decode_step(self, params, x, ctx: DecodeCtx, pool_k, pool_v, state):
        return self._run(
            params, x, state, ctx.state_rows, self.model.mamba_layer_decode,
            lambda b, x, kv_l: _attn_decode_layer(
                self.cfg, b, x, ctx, kv_l, pool_k, pool_v, self._mlp))

    def prefill_into_pool(self, params, x, ctx: PrefillCtx, pool_k, pool_v,
                          state):
        return self._run(
            params, x, state, ctx.state_rows,
            lambda b, x, st: self.model.mamba_layer_full(
                b, x, st, lengths=ctx.lengths),
            lambda b, x, kv_l: _attn_prefill_layer(
                self.cfg, b, x, ctx, kv_l, pool_k, pool_v, self._mlp,
                self.dense))

    def prefill_streamed(self, params, x, ctx: PrefillCtx, pool_k, pool_v,
                         state):
        hist_idx, mask = _streamed_hist(self.cfg, ctx, pool_k.shape[2])
        return self._run(
            params, x, state, ctx.state_rows,
            lambda b, x, st: self.model.mamba_layer_full(
                b, x, st, lengths=ctx.lengths),
            lambda b, x, kv_l: _attn_streamed_layer(
                self.cfg, b, x, ctx, kv_l, pool_k, pool_v, self._mlp,
                hist_idx, mask))


def build_runtimes(model, dense: bool = False) -> list:
    """One runtime per ``cfg.layer_plan()`` group, with KV pool layer
    offsets assigned in plan order; ``dense`` prefills with the plain
    masked attention (``EngineConfig.prefill="dense"``)."""
    cfg = model.cfg
    runtimes: List[LayerRuntime] = []
    kv_offset = 0
    for gi, (kind, count) in enumerate(cfg.layer_plan()):
        if kind == "attn":
            cls = MoERuntime if cfg.arch_type == "moe" else AttentionRuntime
            rt = cls(model, gi, count, kv_offset, dense)
        elif kind in ("wkv", "mamba"):
            rt = RecurrentRuntime(model, gi, count, flavor=kind)
        elif kind == "hybrid_super":
            rt = HybridRuntime(model, gi, count, kv_offset, dense)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        kv_offset += rt.n_kv_layers
        runtimes.append(rt)
    return runtimes


def total_kv_layers(runtimes) -> int:
    return sum(rt.n_kv_layers for rt in runtimes)


def collect_state_specs(runtimes) -> Dict[str, tuple]:
    """Every runtime's state-pool tensors, ``name -> (n_layers,
    per_page_shape, dtype)``."""
    specs: Dict[str, tuple] = {}
    for rt in runtimes:
        specs.update(rt.state_specs())
    return specs
