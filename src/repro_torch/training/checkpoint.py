"""Flat-npz checkpointing for param/optimizer trees (port of
``repro.training.checkpoint``, same file format).

Paths are '/'-joined tree keys; arrays are stored verbatim.  No pickle:
loads are safe on untrusted files.  A file written here loads into the
reference and the other way round, bitwise, as long as the trees have
the same structure.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def load(path: str, like: Any, device: Optional[Any] = None) -> Any:
    """Restore into the structure of ``like``: each tensor on ``device``,
    or where its counterpart in ``like`` lies, in that one's dtype.
    Raises if a shape differs."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            vals = [build(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            return type(tree)(vals) if isinstance(tree, tuple) else vals
        arr = data[prefix[:-1]]
        if arr.shape != tuple(tree.shape):
            raise ValueError(f"{prefix[:-1]}: checkpoint shape {arr.shape}, "
                             f"expected {tuple(tree.shape)}")
        return torch.as_tensor(arr, dtype=tree.dtype,
                               device=tree.device if device is None
                               else device)

    with data:
        return build(like)
