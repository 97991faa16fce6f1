"""AdamW + cosine schedule over the port's param trees (port of
``repro.training.optimizer``).

State mirrors params: ``{"m", "v"}`` fp32 trees plus an int32 ``step``.
The arithmetic is float32 tensors in the reference's order: the global
clip scale, bias corrections from the incremented step, and decoupled
weight decay added to the Adam direction before ``lr`` multiplies it.

Unlike the reference's pure update, ``adamw_update`` writes the new
params, ``m`` and ``v`` into the tensors it is given (and returns them):
at full width the three new trees would add 12 bytes per parameter to
the step's peak memory.  Callers that need the old values pass copies.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from ..models.model import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    warmup_steps: int = 50
    total_steps: int = 1000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Warmup + cosine decay to min_lr_frac * lr, in float32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    # the cosine rounded once from float64: float32 cosines (jnp's,
    # torch's) are sometimes an ulp off, which (1 + cos) amplifies near
    # the end of the schedule
    c = torch.cos((math.pi * prog).double()).float()
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr \
        * 0.5 * (1.0 + c)
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    leaf = tree_leaves(params)[0]
    return {"m": zeros,
            "v": tree_map(torch.zeros_like, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, *,
                 gnorm=None) -> Tuple[Any, dict]:
    """One AdamW step, written into ``params`` and ``state`` in place;
    returns ``(params, state)``.  ``gnorm`` is ``global_norm(grads)``
    where the caller has it already."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - cfg.beta1 ** step.float()
    b2c = 1.0 - cfg.beta2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * scale
        m.copy_(cfg.beta1 * m + (1 - cfg.beta1) * g)
        v.copy_(cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g))
        mh = m / b1c
        vh = v / b2c
        p32 = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state
