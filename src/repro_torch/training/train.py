"""Single-device training loops for the LM and the PRM (port of
``repro.training.train``).

Every family trains: gradients come from autograd through the model's
plain full-sequence pass (``models/attention.py:attn_full``, the SSD and
WKV chunk scans, the MoE's gather-only dispatch and combine): the
reference trains through plain jnp too, so no kernel lies on this path.  Batches are
drawn exactly as the reference draws them (``np.random.default_rng(0)``,
one ``make_batch(rng)`` per step), so both packages see the same data.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.model import tree_leaves, tree_map
from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm


@dataclass
class TrainConfig:
    steps: int = 300
    batch: int = 32
    log_every: int = 50
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def prm_loss_fn(model, params, batch) -> torch.Tensor:
    """BCE between per-position reward and prefix-correctness labels."""
    r = model.reward(params, {"tokens": batch["tokens"]})
    y = batch["labels"]
    m = batch["loss_mask"]
    eps = 1e-6
    bce = -(y * torch.log(r + eps) + (1 - y) * torch.log(1 - r + eps))
    return torch.sum(bce * m) / torch.clamp(torch.sum(m), min=1.0)


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


StepHook = Callable[[int, torch.Tensor, torch.Tensor], None]


def _fit(model, params, make_batch, loss_fn, tcfg: TrainConfig,
         log_prefix: str, on_step: Optional[StepHook] = None
         ) -> Tuple[dict, list]:
    """``on_step(i, loss, gnorm)``, where given, sees each step's loss
    and the global grad norm AdamW clipped with, as tensors on the
    params' device, right after the update was enqueued."""
    # leaf copies that record autograd; the caller's tree is untouched
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      params)
    leaves = tree_leaves(params)
    dev = leaves[0].device
    opt_state = adamw_init(params)
    opt_cfg = dataclasses.replace(tcfg.opt, total_steps=tcfg.steps)

    rng = np.random.default_rng(0)
    history = []
    t0 = time.time()
    for i in range(tcfg.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in make_batch(rng).items()}
        loss = loss_fn(model, params, batch)
        # a leaf the loss never reads (the PRM's unused LM head) gets a
        # zero gradient, as jax.grad gives it
        grads = _unflatten(params, torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))
        gnorm = global_norm(grads)
        adamw_update(opt_cfg, params, grads, opt_state, gnorm=gnorm)
        loss = loss.detach()
        del grads
        if on_step is not None:
            on_step(i, loss, gnorm)
        if i % tcfg.log_every == 0 or i == tcfg.steps - 1:
            l = float(loss)
            history.append(l)
            print(f"[{log_prefix}] step {i:4d} loss {l:.4f} "
                  f"({time.time() - t0:.1f}s)")
    return tree_map(lambda p: p.detach(), params), history


def train_lm(model, params, task, tcfg: TrainConfig,
             on_step: Optional[StepHook] = None):
    """Next-token CE on teacher-forced solutions."""
    def loss_fn(m, p, b):
        return m.loss(p, b)

    return _fit(model, params, lambda rng: task.lm_batch(rng, tcfg.batch),
                loss_fn, tcfg, "lm", on_step)


def train_prm(model, params, task, tcfg: TrainConfig,
              on_step: Optional[StepHook] = None):
    """BCE prefix-correctness on mixed correct/corrupted trajectories."""
    return _fit(model, params, lambda rng: task.prm_batch(rng, tcfg.batch),
                prm_loss_fn, tcfg, "prm", on_step)
