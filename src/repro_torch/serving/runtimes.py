"""Per-layer-group runtimes: the engine <-> model-family contract (port
of ``repro.serving.runtimes``, dense plan).

The engine threads the residual stream through a stack of runtimes, one
per ``cfg.layer_plan()`` group.  This slice ports the dense GQA runtime
(:class:`AttentionRuntime`): the per-layer math of the reference engine
body, op by op, with the pool writes in place and the attention through
the kernel seam (``kernels/ops.py``).  MoE, recurrent and hybrid
runtimes are later slices; ``build_runtimes`` refuses them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..kernels import ops
from ..models import attention as A
from ..models.layers import (apply_rope, matmul, mlp_apply, rms_norm,
                             rope_angles)
from ..models.model import layer_slice


@dataclass
class DecodeCtx:
    """One lock-step decode iteration's per-row operands."""
    lengths: torch.Tensor   # (B,) context length == new token's position
    pages: torch.Tensor     # (B,) physical write page (dump for inactive)
    slots: torch.Tensor     # (B,) in-page write slot
    attend: Callable        # attend(kv_layer, q (B,H,hd), pool_k, pool_v)


@dataclass
class PrefillCtx:
    """A right-padded prefill bucket."""
    positions: torch.Tensor   # (B,T), -1 at padded slots
    pages: torch.Tensor       # (B,T) write pages (dump at padding)
    slots: torch.Tensor       # (B,T) write slots
    lengths: torch.Tensor     # (B,) valid tokens per row


def _attn_decode_layer(cfg, blk, x, ctx: DecodeCtx, kv_l, pool_k, pool_v,
                       ffn):
    """One attention layer of a lock-step decode: project/rope the new
    token, write its K/V at the reserved pool slot (in place), attend
    via ``ctx.attend``."""
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
    ang = rope_angles(ctx.lengths[:, None], hd, cfg.rope_theta)
    q = apply_rope(q, ang)
    k = apply_rope(k, ang)
    pool_k[kv_l, ctx.pages, ctx.slots] = k[:, 0].to(pool_k.dtype)
    pool_v[kv_l, ctx.pages, ctx.slots] = v[:, 0].to(pool_v.dtype)
    y = ctx.attend(kv_l, q[:, 0].contiguous(), pool_k, pool_v)
    x = x + matmul(y.reshape(B, 1, -1), ap["wo"])
    h = rms_norm(blk["ln2"], x, cfg.norm_eps)
    return x + ffn(blk, h)


def _attn_prefill_layer(cfg, blk, x, ctx: PrefillCtx, kv_l, pool_k, pool_v,
                        ffn):
    """One attention layer of a one-shot prefill bucket: K/V go straight
    into the pool pages, attention runs the flash-prefill kernel seam."""
    B, T = x.shape[:2]
    scale = cfg.head_dim ** -0.5
    h = rms_norm(blk["ln1"], x, cfg.norm_eps)
    q, k, v = A._project_qkv(blk["attn"], h, cfg, ctx.positions)
    pool_k[kv_l, ctx.pages, ctx.slots] = k.to(pool_k.dtype)
    pool_v[kv_l, ctx.pages, ctx.slots] = v.to(pool_v.dtype)
    y = ops.flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                          scale=scale, causal=cfg.causal,
                          window=cfg.sliding_window)
    x = x + matmul(y.reshape(B, T, -1), blk["attn"]["wo"])
    h = rms_norm(blk["ln2"], x, cfg.norm_eps)
    return x + ffn(blk, h)


class AttentionRuntime:
    """Dense GQA layers over the paged pool, addressed at
    ``kv_offset .. kv_offset+count`` in the pool's layer axis."""

    kind = "attn"

    def __init__(self, model, gi: int, count: int, kv_offset: int):
        self.model = model
        self.cfg = model.cfg
        self.gi = gi
        self.count = count
        self.kv_offset = kv_offset
        self.n_kv_layers = count

    def _ffn(self, blk, h):
        return mlp_apply(blk["mlp"], h, self.cfg.act)

    def decode_step(self, params, x, ctx: DecodeCtx, pool_k, pool_v):
        gp = params["groups"][self.gi]
        for l in range(self.count):
            x = _attn_decode_layer(self.cfg, layer_slice(gp, l), x, ctx,
                                   self.kv_offset + l, pool_k, pool_v,
                                   self._ffn)
        return x

    def prefill_into_pool(self, params, x, ctx: PrefillCtx, pool_k, pool_v):
        gp = params["groups"][self.gi]
        for l in range(self.count):
            x = _attn_prefill_layer(self.cfg, layer_slice(gp, l), x, ctx,
                                    self.kv_offset + l, pool_k, pool_v,
                                    self._ffn)
        return x


def build_runtimes(model) -> list:
    """One runtime per ``cfg.layer_plan()`` group, with KV pool layer
    offsets assigned in plan order."""
    cfg = model.cfg
    runtimes: list[Any] = []
    kv_offset = 0
    for gi, (kind, count) in enumerate(cfg.layer_plan()):
        if kind != "attn" or cfg.arch_type == "moe":
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} ({cfg.arch_type}) is "
                f"served by a later slice of the port")
        rt = AttentionRuntime(model, gi, count, kv_offset)
        kv_offset += rt.n_kv_layers
        runtimes.append(rt)
    return runtimes


def total_kv_layers(runtimes) -> int:
    return sum(rt.n_kv_layers for rt in runtimes)
