"""ILP for the ETS pruning objective (paper Eq. 2 / Eq. 4).

Variables (all binary):
  s_i  — leaf/candidate i retained
  n_v  — tree node v retained (1 iff any retained leaf's path uses v)
  y_c  — semantic cluster c covered (1 iff any retained leaf is in c)

maximize   sum_i (W_i / sum W) s_i
         - lambda_b * sum_v w_v n_v / W_V        (KV budget term)
         + lambda_d * sum_c y_c / |C|            (coverage term)
s.t.       n_v >= s_i          for every leaf i whose path contains v
           y_c <= sum_{i in c} s_i
           sum_i s_i >= 1

The paper solves this with PuLP + CBC; we use scipy.optimize.milp (HiGHS),
which is the maintained off-the-shelf MILP stack in the scientific-python
world.  ``greedy_select`` is a host-side fallback with the same objective
(used when HiGHS is unavailable and as the low-latency beyond-paper path).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class SelectionProblem:
    """One pruning decision.

    leaf_values : (L,) retention value per candidate (REBASE W_i).
    leaf_paths  : per leaf, the node ids on its root path (any hashable ids).
    node_weights: optional per-node KV weight (default 1.0 per node, as in
                  the paper's |V_S|; pass token counts for the
                  token-weighted beyond-paper variant).
    clusters    : optional (L,) cluster label per leaf.
    """
    leaf_values: np.ndarray
    leaf_paths: List[Sequence]
    node_weights: Optional[Dict] = None
    clusters: Optional[np.ndarray] = None
    lambda_b: float = 1.0
    lambda_d: float = 1.0

    def normalize(self):
        """Index nodes/clusters; returns internal matrices."""
        L = len(self.leaf_values)
        node_ids = sorted({v for path in self.leaf_paths for v in path},
                          key=str)
        nidx = {v: j for j, v in enumerate(node_ids)}
        V = len(node_ids)
        w = np.ones(V)
        if self.node_weights:
            w = np.array([float(self.node_weights.get(v, 1.0))
                          for v in node_ids])
        membership = [[nidx[v] for v in path] for path in self.leaf_paths]
        if self.clusters is not None:
            labels = np.asarray(self.clusters)
            uniq = sorted(set(labels.tolist()))
            cidx = {c: j for j, c in enumerate(uniq)}
            cl = np.array([cidx[c] for c in labels])
            C = len(uniq)
        else:
            cl, C = None, 0
        return L, V, w, membership, cl, C


@dataclass
class SelectionResult:
    selected: List[int]            # indices of retained leaves
    objective: float
    n_nodes_kept: int
    n_clusters_covered: int
    solver: str
    status: str = "ok"


# ---------------------------------------------------------------------------
# Exact ILP via scipy/HiGHS
# ---------------------------------------------------------------------------

def milp_select(prob: SelectionProblem) -> SelectionResult:
    from scipy import sparse
    from scipy.optimize import Bounds, LinearConstraint, milp

    L, V, w, membership, cl, C = prob.normalize()
    if L == 0:
        return SelectionResult([], 0.0, 0, 0, "milp", "empty")
    W = np.asarray(prob.leaf_values, dtype=np.float64)
    Wsum = max(W.sum(), 1e-12)
    wsum = max(w.sum(), 1e-12)

    nvar = L + V + C
    c = np.zeros(nvar)
    c[:L] = -(W / Wsum)                          # maximize -> minimize -c
    c[L:L + V] = prob.lambda_b * w / wsum
    if C:
        c[L + V:] = -prob.lambda_d / C

    rows, cols, vals = [], [], []
    lb, ub = [], []
    r = 0
    # n_v >= s_i  <=>  s_i - n_v <= 0
    for i, path in enumerate(membership):
        for j in path:
            rows += [r, r]
            cols += [i, L + j]
            vals += [1.0, -1.0]
            lb.append(-np.inf)
            ub.append(0.0)
            r += 1
    # y_c <= sum_{i in c} s_i  <=>  y_c - sum s_i <= 0
    if C:
        for cc in range(C):
            members = np.nonzero(cl == cc)[0]
            rows.append(r)
            cols.append(L + V + cc)
            vals.append(1.0)
            for i in members:
                rows.append(r)
                cols.append(int(i))
                vals.append(-1.0)
            lb.append(-np.inf)
            ub.append(0.0)
            r += 1
    # sum s_i >= 1
    for i in range(L):
        rows.append(r)
        cols.append(i)
        vals.append(1.0)
    lb.append(1.0)
    ub.append(np.inf)
    r += 1

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(r, nvar))
    res = milp(c, constraints=LinearConstraint(A, lb, ub),
               integrality=np.ones(nvar),
               bounds=Bounds(0.0, 1.0))
    if res.x is None:
        return greedy_select(prob)
    x = np.round(res.x).astype(int)
    sel = [i for i in range(L) if x[i] == 1]
    kept_nodes = int(x[L:L + V].sum())
    covered = int(x[L + V:].sum()) if C else 0
    return SelectionResult(sel, float(-res.fun), kept_nodes, covered,
                           "milp(HiGHS)", res.message)


# ---------------------------------------------------------------------------
# Greedy fallback (also the low-host-latency beyond-paper selector)
# ---------------------------------------------------------------------------

def greedy_select(prob: SelectionProblem) -> SelectionResult:
    L, V, w, membership, cl, C = prob.normalize()
    if L == 0:
        return SelectionResult([], 0.0, 0, 0, "greedy", "empty")
    W = np.asarray(prob.leaf_values, dtype=np.float64)
    Wsum = max(W.sum(), 1e-12)
    wsum = max(w.sum(), 1e-12)

    kept_nodes: set = set()
    covered: set = set()
    selected: List[int] = []
    remaining = set(range(L))
    obj = 0.0

    def gain(i: int) -> float:
        g = W[i] / Wsum
        new_nodes = [j for j in membership[i] if j not in kept_nodes]
        g -= prob.lambda_b * sum(w[j] for j in new_nodes) / wsum
        if C and cl[i] not in covered:
            g += prob.lambda_d / C
        return g

    while remaining:
        best = max(remaining, key=gain)
        gb = gain(best)
        if selected and gb <= 0:
            break
        selected.append(best)
        obj += gb
        kept_nodes.update(membership[best])
        if C:
            covered.add(cl[best])
        remaining.discard(best)
    return SelectionResult(sorted(selected), obj, len(kept_nodes),
                           len(covered), "greedy")


def solve(prob: SelectionProblem, method: str = "milp") -> SelectionResult:
    if method == "milp":
        try:
            return milp_select(prob)
        except ImportError:
            return greedy_select(prob)
    if method == "greedy":
        return greedy_select(prob)
    raise ValueError(method)
