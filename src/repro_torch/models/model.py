"""Language model, dense and encoder families (port of
``repro.models.model``).

``LM(cfg)`` is functional like the reference: params are a nested dict
of tensors in the reference layout, so the bridge from reference params
is a plain copy.

  * ``init(generator)``            — parameter init (fp32 master params)
  * ``forward(params, batch)``     — full-sequence logits
  * ``hidden(params, batch)``      — final-layer normed hidden states
  * ``reward(params, batch)``      — PRM scalar head (with_value_head)
  * ``embed_inputs`` / ``logits``  — the pieces the paged engine composes

dtype flow follows the reference op by op: master params are fp32,
``forward``/``hidden``/``reward`` cast them to the compute type
``cfg.dtype`` first, and ``embed_inputs``/``logits`` cast the embedding
to the compute type where they read it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..device import resolve_device
from . import attention as A
from .layers import dense_init, embed_init, matmul, mlp_apply, mlp_init, \
    rms_norm

Params = Dict[str, Any]


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def layer_slice(group: Params, l: int) -> Params:
    """Layer ``l``'s params out of a stacked (L, ...) group."""
    return tree_map(lambda a: a[l], group)


def _stack_init(fn: Callable[[], Params], n: int) -> Params:
    """Stack n param trees along a new leading axis."""
    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return torch.stack(ts)

    return stack([fn() for _ in range(n)])


def compute_dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class LM:
    def __init__(self, cfg, *, with_value_head: bool = False,
                 device=None):
        if cfg.arch_type not in ("dense", "encoder"):
            raise NotImplementedError(
                f"{cfg.name} ({cfg.arch_type}): the port serves dense and "
                f"encoder models so far; other families are a later slice")
        self.cfg = cfg
        self.with_value_head = with_value_head
        self.device = resolve_device(device)
        # fp32 products on the card run in full fp32, as the reference
        # computes them: TF32 keeps ~3 decimal digits and would break the
        # fp32 parity the port is held to.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.plan = cfg.layer_plan()
        self.compute_dtype = compute_dtype_of(cfg)

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

        def attn_block():
            return {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                    "attn": A.attn_init(generator, cfg, dt),
                    "ln2": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                    "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff,
                                    cfg.act, dt)}

        p["groups"] = [_stack_init(attn_block, count)
                       for _, count in self.plan]
        p["ln_f"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
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
        """Returns (x (B,S,d), positions (B,S))."""
        tokens = batch["tokens"]
        x = p["embed"].to(self.compute_dtype)[tokens]
        B, S = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
        return x, positions

    def logits(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(p["ln_f"], x, self.cfg.norm_eps)
        head = p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]
        return matmul(x, head.to(self.compute_dtype))

    # ------------------------------------------------------------------
    # Full-sequence pass
    # ------------------------------------------------------------------
    def _attn_layer_full(self, blk: Params, x, positions):
        cfg = self.cfg
        h = rms_norm(blk["ln1"], x, cfg.norm_eps)
        x = x + A.attn_full(blk["attn"], h, cfg, positions)
        h = rms_norm(blk["ln2"], x, cfg.norm_eps)
        return x + mlp_apply(blk["mlp"], h, cfg.act)

    def _run_full(self, p: Params, x, positions):
        for gi, (_, count) in enumerate(self.plan):
            gp = p["groups"][gi]
            for l in range(count):
                x = self._attn_layer_full(layer_slice(gp, l), x, positions)
        return x

    # ------------------------------------------------------------------
    # Public
    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, p: Params, batch: Dict[str, Any]):
        """Full-sequence logits (B,S,V) and the (zero) MoE aux loss."""
        p = self.cast_params(p)
        x, positions = self.embed_inputs(p, batch)
        x = self._run_full(p, x, positions)
        return self.logits(p, x), 0.0

    @torch.no_grad()
    def hidden(self, p: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """Final-layer hidden states (B, S, d) — embedder API."""
        p = self.cast_params(p)
        x, positions = self.embed_inputs(p, batch)
        x = self._run_full(p, x, positions)
        return rms_norm(p["ln_f"], x, self.cfg.norm_eps)

    @torch.no_grad()
    def reward(self, p: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """PRM: per-position scalar scores (B, S), float32."""
        if not self.with_value_head:
            raise ValueError("reward needs a model built with_value_head")
        p = self.cast_params(p)
        x, positions = self.embed_inputs(p, batch)
        x = self._run_full(p, x, positions)
        x = rms_norm(p["ln_f"], x, self.cfg.norm_eps)
        v = matmul(x, p["value_head"].to(x.dtype))[..., 0]
        return torch.sigmoid(v.float())


def build_model(cfg, *, with_value_head: bool = False,
                device: Optional[object] = None) -> LM:
    return LM(cfg, with_value_head=with_value_head, device=device)
