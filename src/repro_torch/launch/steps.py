"""Step builders and input specs for every (architecture x input shape)
(port of ``repro.launch.steps``).

``input_specs`` / ``cache_specs`` / ``params_specs`` give the shape and
dtype of each input as a ``Spec``, without allocating: the cache through
``init_cache`` on the ``meta`` device, the params through ``LM.init``
under ``FakeTensorMode`` (mixtral-8x7b's 46.7e9 params could not be
allocated), the reference's ``jax.eval_shape``.  ``materialize`` turns
specs into real tensors, at whatever (cut) batch the specs were made
for.  The step builders return functions that run one step eagerly on
the device the params live on.

Shape kinds:
  train_4k     — full train step: fwd + bwd + AdamW update.
  prefill_32k  — forward + KV/state cache materialization.
  decode_*     — serve step: ONE new token against a seq_len cache.

Skip policy, as in the reference:
  * encoder archs (hubert) skip decode shapes;
  * long_500k runs only for sub-quadratic archs (SSM/hybrid recurrent
    or native-SWA) — pure full-attention archs skip it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs import InputShape, ModelConfig
from ..models.model import LM, compute_dtype_of, tree_leaves, tree_map
from ..training.optimizer import AdamWConfig, adamw_update, global_norm


# ---------------------------------------------------------------------------
# Combo policy
# ---------------------------------------------------------------------------

def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.kind == "decode":
        if not cfg.supports_decode:
            return "encoder-only arch has no decode step"
        if shape.seq_len > 65536 and not cfg.supports_long_context:
            return "full-attention arch: long_500k requires sub-quadratic"
    return None


def is_long(shape: InputShape) -> bool:
    return shape.kind == "decode" and shape.seq_len > 65536


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Spec:
    """Shape and dtype of one input, and how ``materialize`` fills it:
    ``normal`` (standard normal), ``zeros``, ``ones``, ``empty`` (-1, an
    empty cache slot), ``tokens`` (ints in [0, high)) or ``positions``
    (0, 1, ... along the last axis)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    fill: str = "zeros"
    high: int = 0


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Spec]:
    """Specs of the step's batch inputs."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f = compute_dtype_of(cfg)

    def tokens(*shp):
        return Spec(shp, i32, "tokens", cfg.vocab_size)

    def embeds(n):
        return Spec((B, n, cfg.frontend_dim), f, "normal")

    targets = {"labels": tokens(B, S),
               "loss_mask": Spec((B, S), torch.float32, "ones")}
    if shape.kind in ("train", "prefill"):
        extra = targets if shape.kind == "train" else {}
        if cfg.arch_type == "encoder":      # audio: frames in, units out
            return {"embeds": embeds(S), **extra}
        if cfg.arch_type == "vlm":          # image prefix + text
            s_img = S // 8
            return {"embeds": embeds(s_img), "tokens": tokens(B, S - s_img),
                    "positions": Spec((3, B, S), i32, "positions"), **extra}
        return {"tokens": tokens(B, S), **extra}
    # decode: one token per sequence
    return {"tokens": tokens(B, 1)}


def _cache_spec(tree, key=None):
    if isinstance(tree, dict):
        return {k: _cache_spec(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cache_spec(v) for v in tree]
    return Spec(tuple(tree.shape), tree.dtype,
                "empty" if key == "pos" else "zeros")


def cache_specs(model: LM, shape: InputShape):
    """Specs of the decode-time cache (``init_cache`` at the shape's
    batch and length; empty slots hold position -1)."""
    return _cache_spec(model.init_cache(shape.global_batch, shape.seq_len,
                                        device="meta"))


def params_specs(model: LM, *, serve: bool, quant_moe: bool = False):
    """Specs of ``model.init``'s params; ``serve`` casts the fp32 masters
    to the compute dtype.  ``quant_moe`` (serve only): expert banks as
    int8 ``{"q", "s"}`` with per-out-channel scales, as ``quantize_bank``
    makes them, the stacked layer axis kept."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = model.init(torch.Generator())
        ps = tree_map(lambda t: Spec(tuple(t.shape), t.dtype, "normal"),
                      fake)
    if not serve:
        return ps
    cdt = model.compute_dtype
    ps = tree_map(lambda s: Spec(s.shape, cdt, s.fill)
                  if s.dtype.is_floating_point else s, ps)
    if quant_moe and model.cfg.arch_type == "moe":
        for g in ps["groups"]:
            if "moe" not in g:
                continue
            for name in ("w_up", "w_gate", "w_down"):
                shp = g["moe"][name].shape
                scale = (shp[0],) + (1,) * (len(shp) - 2) + (shp[-1],)
                g["moe"][name] = {"q": Spec(shp, torch.int8),
                                  "s": Spec(scale, torch.float32, "ones")}
    return ps


def materialize(specs, device, generator: torch.Generator):
    """Real tensors for a tree of ``Spec``s on ``device`` (the generator
    lives there too)."""
    dev = torch.device(device)

    def make(s: Spec) -> torch.Tensor:
        if s.fill == "normal":
            return torch.randn(s.shape, generator=generator,
                               device=dev).to(s.dtype)
        if s.fill == "tokens":
            return torch.randint(0, s.high, s.shape, generator=generator,
                                 device=dev, dtype=s.dtype)
        if s.fill == "positions":
            return torch.arange(s.shape[-1], dtype=s.dtype, device=dev
                                ).expand(s.shape).contiguous()
        value = {"zeros": 0, "ones": 1, "empty": -1}[s.fill]
        return torch.full(s.shape, value, dtype=s.dtype, device=dev)

    return tree_map(make, specs)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def build_model_for(cfg: ModelConfig, shape: InputShape, **kw) -> LM:
    return LM(cfg, long_mode=is_long(shape), **kw)


def build_train_step(model: LM, opt_cfg: Optional[AdamWConfig] = None,
                     on_step: Optional[Callable] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss's gradients, then the port's AdamW update, which
    writes the new params and moments into the tensors given (see
    ``training.optimizer``).  ``on_step(loss, gnorm)``, where given,
    sees the loss and the global grad norm AdamW clipped with, as
    tensors, once the update is enqueued."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, batch)
        # a leaf the loss never reads gets a zero gradient, as in jax
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        grads = tree_map(lambda _: next(grads), params)
        gnorm = global_norm(grads)
        params, opt_state = adamw_update(opt_cfg, params, grads, opt_state,
                                         gnorm=gnorm)
        loss = loss.detach()
        if on_step is not None:
            on_step(loss, gnorm)
        return params, opt_state, loss

    return train_step


def build_prefill_step(model: LM, cache_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        if model.cfg.arch_type == "encoder":
            logits, _ = model.forward(params, batch)
            return logits, None
        return model.prefill(params, batch, cache_len)

    return prefill_step


def build_decode_step(model: LM):
    @torch.no_grad()
    def decode_step(params, batch, cache):
        return model.decode_step(params, batch["tokens"], cache)

    return decode_step

