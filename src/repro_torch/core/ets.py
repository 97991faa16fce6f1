"""ETS — Efficient Tree Search (the paper's §4 algorithm, one search step).

At every expansion step of the search the controller has a set of
candidate leaves (freshly sampled continuations, already scored by the
PRM).  ETS decides which to keep and how many continuations each keeper
receives next:

  1. REBASE weights  W_i = ceil(N softmax(R/T_R))          (Eq. 1)
  2. cluster candidates by last-step semantic embedding     (§4.2)
  3. solve the ILP  max  Σ_S W/ΣW − λ_b|V_S|/|V_A| + λ_d|C_S|/|C_A|
     s.t. |S| ≥ 1                                           (Eq. 4)
  4. re-apply REBASE over the retained set for next counts  (Eq. 3)

``lambda_d = 0`` with no clustering is the ETS-KV ablation (Table 3);
``lambda_b = lambda_d = 0`` degenerates to plain REBASE.

``mcts_step`` (below) is a sibling one-step retention policy — the
Adaptive Parallel MCTS baseline from PAPERS.md — sharing the REBASE
allocation machinery so the controller's ``mcts`` method plugs into the
same batched step protocol as ETS.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import tracing
from .clustering import cluster_embeddings
from .ilp import SelectionProblem, SelectionResult, solve
from .rebase import rebase_reweight, rebase_weights
from .tree import SearchTree


@dataclass
class ETSConfig:
    lambda_b: float = 1.0          # KV budget term strength
    lambda_d: float = 1.0          # coverage term strength (0 = ETS-KV)
    rebase_temperature: float = 0.2
    cluster_threshold: float = 0.3
    use_clustering: bool = True
    solver: str = "milp"           # "milp" | "greedy"
    token_weighted_nodes: bool = False  # beyond-paper: weight V_S by tokens


@dataclass
class ETSStep:
    """Outcome of one ETS pruning decision."""
    selected: List[int]            # indices into the candidate list
    counts: np.ndarray             # continuations per retained candidate
    weights_all: np.ndarray        # Eq. 1 weights over all candidates
    n_clusters: int
    solver_result: SelectionResult


@tracing.span("select")
def ets_prune(tree: SearchTree, candidates: Sequence[int],
              rewards: Sequence[float], n_total: int, cfg: ETSConfig,
              embeddings: Optional[np.ndarray] = None) -> ETSStep:
    """One ETS step over candidate leaf node-ids in `tree`.

    n_total: continuation budget N for the next expansion.
    embeddings: (L, D) last-step embeddings (required if use_clustering).
    """
    if tracing.on:
        root = tree.node(0).payload
        if isinstance(root, dict) and "ns" in root:
            tracing.annotate(ns=root["ns"])
    L = len(candidates)
    W = rebase_weights(rewards, n_total, cfg.rebase_temperature)

    clusters = None
    n_clusters = 0
    if cfg.use_clustering and cfg.lambda_d > 0 and embeddings is not None \
            and L > 1:
        clusters = cluster_embeddings(np.asarray(embeddings),
                                      cfg.cluster_threshold)
        n_clusters = len(set(clusters.tolist()))

    node_weights = None
    if cfg.token_weighted_nodes:
        paths = [tree.path(c) for c in candidates]
        node_weights = {v: tree.node(v).n_tokens
                        for path in paths for v in path}

    prob = SelectionProblem(
        leaf_values=np.asarray(W, dtype=np.float64),
        leaf_paths=[tree.path(c) for c in candidates],
        node_weights=node_weights,
        clusters=clusters,
        lambda_b=cfg.lambda_b,
        lambda_d=cfg.lambda_d if clusters is not None else 0.0,
    )
    res = solve(prob, cfg.solver)
    counts = rebase_reweight(rewards, res.selected, n_total,
                             cfg.rebase_temperature)
    return ETSStep(selected=res.selected, counts=counts, weights_all=W,
                   n_clusters=n_clusters, solver_result=res)


def mcts_step(rewards: Sequence[float], visits: Sequence[int],
              total_visits: int, n_total: int, *, c_uct: float = 1.4,
              gap: float = 0.35, temperature: float = 0.2
              ) -> Tuple[List[int], np.ndarray]:
    """One Adaptive Parallel MCTS retention step (PAPERS.md baseline).

    Each candidate arm gets the UCT score

        U_i = R_i + c_uct * sqrt(ln(total_visits) / visits_i)

    and every arm within ``gap`` of the best stays parallel-expanded:
    a flat UCT profile keeps many arms in flight while a peaked one
    narrows to few — the "adaptive parallelism" of the baseline —
    capped at ``n_total`` arms.  The continuation budget is then split
    over the kept arms by the REBASE softmax over their UCT scores
    (largest-remainder rounding, so the counts sum exactly to
    ``n_total``).  Deterministic given rewards and visit counts: ties
    break toward the lower candidate index, so the serial and batched
    drivers agree bit-for-bit.

    Returns ``(selected indices, counts)`` aligned like ``ets_prune``.
    """
    L = len(rewards)
    assert L and L == len(visits), (L, len(visits))
    ln_t = math.log(max(total_visits, 2))
    uct = np.asarray(rewards, dtype=np.float64) + c_uct * np.sqrt(
        ln_t / np.maximum(np.asarray(visits, dtype=np.float64), 1.0))
    best = float(uct.max())
    keep = sorted((i for i in range(L) if uct[i] >= best - gap),
                  key=lambda i: (-uct[i], i))
    keep = keep[:max(min(n_total, L), 1)]
    counts = rebase_reweight(uct.tolist(), keep, n_total, temperature)
    return keep, counts
