"""REBASE balanced sampling weights (Wu et al., 2024) — Eq. (1) and (3).

Given PRM rewards R_i for the candidate leaves and a total continuation
budget N, REBASE allocates

    W_i = ceil( N * softmax(R / T_R)_i )

continuations to leaf i — more to promising leaves, but never zero unless
the softmax mass vanishes.  ETS uses W_i both as the value of retaining
leaf i in the ILP (Eq. 2/4) and, re-normalized over the retained set S
(Eq. 3), as the next step's continuation counts.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def softmax(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


def _allocate(p: np.ndarray, n_total: int, exact: bool) -> np.ndarray:
    """Integer allocation of n_total by proportions p.

    exact=False is the paper's literal Eq. (1) ceil (sum may exceed N);
    exact=True is largest-remainder rounding summing to exactly N, matching
    the open-source REBASE implementation's fixed per-step width.
    """
    if not exact:
        return np.ceil(n_total * p).astype(np.int64)
    raw = n_total * p
    base = np.floor(raw).astype(np.int64)
    rem = n_total - int(base.sum())
    if rem > 0:
        order = np.argsort(raw - base)[::-1][:rem]
        base[order] += 1
    return base


def rebase_weights(rewards: Sequence[float], n_total: int,
                   temperature: float = 0.2,
                   exact: bool = True) -> np.ndarray:
    """Eq. (1): W_i = ceil(N * exp(R_i/T) / sum_k exp(R_k/T))."""
    if len(rewards) == 0:
        return np.zeros((0,), dtype=np.int64)
    p = softmax(np.asarray(rewards, dtype=np.float64) / temperature)
    return _allocate(p, n_total, exact)


def rebase_reweight(rewards: Sequence[float], selected: Sequence[int],
                    n_total: int, temperature: float = 0.2,
                    exact: bool = True) -> np.ndarray:
    """Eq. (3): re-apply REBASE over the retained set only.

    Returns an array aligned with ``selected`` (continuations per retained
    leaf).
    """
    if len(selected) == 0:
        return np.zeros((0,), dtype=np.int64)
    r = np.asarray([rewards[i] for i in selected], dtype=np.float64)
    p = softmax(r / temperature)
    return _allocate(p, n_total, exact)
