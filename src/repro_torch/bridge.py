"""Reference params -> port params, and back.

``params_from_jax`` takes the reference ``LM.init`` pytree with every
leaf already a numpy array (the caller converts, e.g. with
``jax.tree.map(np.asarray, params)``, so this module never imports jax)
and copies it into tensors on ``device``.  The port keeps the reference
layout (``x @ w`` with ``w`` shaped ``(d_in, d_out)``, per-group layer
stacks under ``groups[gi]``), so the bridge is a plain copy: nested
family groups (``mamba``, ``time_mix``/``channel_mix``, ``moe``),
``(count, attn_every, ...)`` hybrid stacks, Zamba2's ``shared_attn``
block and int8 ``{"q", "s"}`` expert banks keep their structure and
dtypes.
``params_to_numpy`` is its inverse, for any port tree (trained params,
AdamW state).

``cache_from_numpy`` / ``cache_to_numpy`` carry the contiguous decode
cache (``LM.prefill`` / ``init_cache`` / ``decode_step``) across: every
plan's per-group tree (attention ``{"k","v","pos"}``, int8 ``{"q","s"}``
K/V leaves, rwkv ``{"S","x_prev"}``, mamba ``{"h","conv"}``, hybrid
``{"mamba","attn"}``) and ``next_pos``, leaves stacked over layers as in
the reference, so a decode of one package continues a prefill of the
other.  bfloat16 leaves cross as float32 numpy arrays (numpy has no
bfloat16 without an extension) and come back as bfloat16.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .models.model import tree_map

_KEYS = ("embed", "frontend_proj", "groups", "shared_attn", "ln_f",
         "value_head", "lm_head")


def params_from_jax(np_params: Dict[str, Any], cfg, device=None
                    ) -> Dict[str, Any]:
    """Copy a reference params tree (numpy leaves) onto ``device``.

    Covers the dense, VLM, encoder, MoE, SSM and hybrid families: ``embed``,
    ``groups[gi]`` (layer stacks), ``ln_f``, and when present
    ``shared_attn`` (hybrid), ``value_head`` (PRM), ``lm_head`` (untied
    embeddings) and ``frontend_proj`` (the VLM and audio frontends).
    """
    dev = resolve_device(device)
    extra = set(np_params) - set(_KEYS)
    if extra:
        raise ValueError(f"params of {cfg.name} carry unknown keys "
                         f"{sorted(extra)}")
    if ("frontend_proj" in np_params) != bool(cfg.frontend_dim):
        raise ValueError(f"{cfg.name}: frontend_proj presence disagrees "
                         f"with frontend_dim={cfg.frontend_dim}")
    if ("shared_attn" in np_params) != (cfg.arch_type == "hybrid"):
        raise ValueError(f"{cfg.name}: shared_attn presence disagrees with "
                         f"arch_type={cfg.arch_type}")
    n_groups = len(np_params.get("groups", ()))
    if n_groups != len(cfg.layer_plan()):
        raise ValueError(f"{cfg.name}: {n_groups} layer groups, the plan "
                         f"has {len(cfg.layer_plan())}")
    if np_params["embed"].shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed has shape {np_params['embed'].shape}, "
                         f"{cfg.name} needs {(cfg.vocab_size, cfg.d_model)}")
    if ("lm_head" in np_params) == bool(cfg.tie_embeddings):
        raise ValueError(f"{cfg.name}: lm_head presence disagrees with "
                         f"tie_embeddings={cfg.tie_embeddings}")
    return tree_map(lambda a: torch.tensor(np.array(a), device=dev),
                    dict(np_params))


def params_to_numpy(tree: Any) -> Any:
    """A port tree (nested dicts/lists of tensors) as the same tree of
    numpy arrays in the reference layout, on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # an extension dtype (ml_dtypes)
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(np.array(a), device=device)


def _check_cache(cache, model) -> None:
    groups = cache.get("groups")
    if set(cache) != {"groups", "next_pos"} or groups is None \
            or len(groups) != len(model.plan):
        raise ValueError(f"a cache of {model.cfg.name} holds 'groups' "
                         f"({len(model.plan)} of them) and 'next_pos'")


def cache_from_numpy(np_cache: Dict[str, Any], model, device=None
                     ) -> Dict[str, Any]:
    """A reference cache tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, cache)``) as the port's cache of
    ``model`` on ``device`` (default the model's)."""
    _check_cache(np_cache, model)
    dev = model.device if device is None else resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), dict(np_cache))


def cache_to_numpy(cache: Dict[str, Any], model) -> Dict[str, Any]:
    """A port cache as the same tree of numpy arrays on the host (the
    reference's layout); bfloat16 leaves as float32."""
    _check_cache(cache, model)

    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(host, cache)
