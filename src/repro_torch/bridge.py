"""Reference params -> port params.

``params_from_jax`` takes the reference ``LM.init`` pytree with every
leaf already a numpy array (the caller converts, e.g. with
``jax.tree.map(np.asarray, params)``, so this module never imports jax)
and copies it into tensors on ``device``.  The port keeps the reference
layout (``x @ w`` with ``w`` shaped ``(d_in, d_out)``, per-group layer
stacks under ``groups[gi]``), so the bridge is a plain copy.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .models.model import tree_map

_KEYS = ("embed", "groups", "ln_f", "value_head", "lm_head")


def params_from_jax(np_params: Dict[str, Any], cfg, device=None
                    ) -> Dict[str, Any]:
    """Copy a reference params tree (numpy leaves) onto ``device``.

    Covers the dense and encoder families: ``embed``, ``groups[gi]``
    (layer stacks), ``ln_f``, and when present ``value_head`` (PRM) and
    ``lm_head`` (untied embeddings).
    """
    dev = resolve_device(device)
    extra = set(np_params) - set(_KEYS)
    if extra:
        raise NotImplementedError(
            f"params of {cfg.name} carry {sorted(extra)}: families beyond "
            f"dense/encoder are a later slice")
    if np_params["embed"].shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed has shape {np_params['embed'].shape}, "
                         f"{cfg.name} needs {(cfg.vocab_size, cfg.d_model)}")
    if ("lm_head" in np_params) == bool(cfg.tie_embeddings):
        raise ValueError(f"{cfg.name}: lm_head presence disagrees with "
                         f"tie_embeddings={cfg.tie_embeddings}")
    return tree_map(lambda a: torch.tensor(np.array(a), device=dev),
                    dict(np_params))
