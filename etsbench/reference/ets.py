"""ETS's retention step, frozen: REBASE weights, semantic clustering and
the selection ILP (the paper's Eqs. 1-4), as the serving stack
configures them (MILP through SciPy's HiGHS, average-linkage clustering
on cosine distance).

Given a step's candidates (their root paths), their rewards and their
last-step embeddings, ``select`` returns the retained candidates and the
continuations each gets next.  The benchmark feeds it the served
search's own rewards and embeddings and compares its answer with the
set the search kept.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _softmax(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    e = np.exp(x - x.max())
    return e / e.sum()


def _allocate(p: np.ndarray, n_total: int) -> np.ndarray:
    """Largest-remainder rounding of ``n_total * p`` to a sum of n_total."""
    raw = n_total * p
    base = np.floor(raw).astype(np.int64)
    rem = n_total - int(base.sum())
    if rem > 0:
        base[np.argsort(raw - base)[::-1][:rem]] += 1
    return base


def rebase(rewards: Sequence[float], n_total: int, temp: float) -> np.ndarray:
    return _allocate(_softmax(np.asarray(rewards, np.float64) / temp),
                     n_total)


def clusters(embs: np.ndarray, threshold: float) -> np.ndarray:
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform
    x = np.asarray(embs, dtype=np.float64)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    dm = 1.0 - np.clip(x @ x.T, -1.0, 1.0)
    z = linkage(squareform(dm, checks=False), method="average")
    return fcluster(z, t=threshold, criterion="distance").astype(np.int64)


def ilp(values: np.ndarray, paths: Sequence[Sequence[int]],
        labels, lambda_b: float, lambda_d: float) -> List[int]:
    """max sum_i W_i s_i / sum W - lambda_b |V_S| / |V_A| + lambda_d
    |C_S| / |C_A| over binary s (leaves), n (nodes), y (clusters), with
    n_v >= s_i on i's path, y_c <= sum_{i in c} s_i, sum s >= 1."""
    from scipy import sparse
    from scipy.optimize import Bounds, LinearConstraint, milp
    L = len(values)
    nodes = sorted({v for p in paths for v in p}, key=str)
    nidx = {v: j for j, v in enumerate(nodes)}
    V = len(nodes)
    if labels is not None:
        uniq = sorted(set(np.asarray(labels).tolist()))
        cl = np.array([uniq.index(c) for c in np.asarray(labels).tolist()])
        C = len(uniq)
    else:
        cl, C = None, 0
    W = np.asarray(values, np.float64)
    c = np.zeros(L + V + C)
    c[:L] = -W / max(W.sum(), 1e-12)
    c[L:L + V] = lambda_b / max(float(V), 1e-12)
    if C:
        c[L + V:] = -lambda_d / C
    rows, cols, vals, lb, ub = [], [], [], [], []
    r = 0
    for i, path in enumerate(paths):
        for v in path:
            rows += [r, r]
            cols += [i, L + nidx[v]]
            vals += [1.0, -1.0]
            lb.append(-np.inf)
            ub.append(0.0)
            r += 1
    for cc in range(C):
        rows.append(r)
        cols.append(L + V + cc)
        vals.append(1.0)
        for i in np.nonzero(cl == cc)[0]:
            rows.append(r)
            cols.append(int(i))
            vals.append(-1.0)
        lb.append(-np.inf)
        ub.append(0.0)
        r += 1
    for i in range(L):
        rows.append(r)
        cols.append(i)
        vals.append(1.0)
    lb.append(1.0)
    ub.append(np.inf)
    r += 1
    A = sparse.csr_matrix((vals, (rows, cols)), shape=(r, L + V + C))
    res = milp(c, constraints=LinearConstraint(A, lb, ub),
               integrality=np.ones(L + V + C), bounds=Bounds(0.0, 1.0))
    if res.x is None:
        raise RuntimeError(f"the selection ILP has no solution: "
                           f"{res.message}")
    x = np.round(res.x).astype(int)
    return [i for i in range(L) if x[i] == 1]


def select(paths: Sequence[Sequence[int]], rewards: Sequence[float],
           embs, n_total: int, *, lambda_b: float = 1.0,
           lambda_d: float = 1.0, temperature: float = 0.2,
           threshold: float = 0.3) -> Tuple[List[int], List[int]]:
    """One ETS step: (retained candidate indices, continuations each)."""
    W = rebase(rewards, n_total, temperature)
    labels = None
    if lambda_d > 0 and embs is not None and len(rewards) > 1:
        labels = clusters(embs, threshold)
    sel = ilp(W, paths, labels, lambda_b,
              lambda_d if labels is not None else 0.0)
    r = np.asarray([rewards[i] for i in sel], np.float64)
    counts = _allocate(_softmax(r / temperature), n_total)
    return sel, [int(n) for n in counts]
