"""ETS core — host-side search, copied from ``repro.core``.

Public API:
  SearchTree                         — tree bookkeeping + KV accounting
  rebase_weights / rebase_reweight   — Eq. (1) / Eq. (3)
  ETSConfig, ets_prune               — Eq. (2)/(4) ILP pruning step
  SearchConfig, run_search           — unified beam/DVTS/REBASE/ETS/MCTS loop
  SearchState                        — the loop as a resumable step machine
  SweepScheduler, run_search_many    — continuous cross-problem batching
  AdaptiveConfig, BudgetController   — difficulty-adaptive width + budget
  mcts_step                          — Adaptive Parallel MCTS step policy
  EngineReplica, ReplicaSweep        — N replicas, one admission queue
  Request, poisson_requests, load_trace, SLOTracker,
  ServingConfig, ServingLoop         — online serving with SLO tracking
  ReplicaServingLoop                 — one arrival stream over N replicas
  SyntheticTaskConfig, SyntheticProblem, evaluate_method — oracle task
  SyntheticSweep                     — multi-problem synthetic backend
  HardwareModel, simulate_search_cost — memory-op cost model (Fig. 2)
"""
from .clustering import cluster_embeddings  # noqa: F401
from .controllers import (AdaptiveConfig, Backend,  # noqa: F401
                          BudgetController, SearchConfig, SearchResult,
                          SearchState, SweepScheduler, run_search,
                          run_search_many, weighted_majority)
from .costsim import HardwareModel, simulate_search_cost  # noqa: F401
from .ets import ETSConfig, ETSStep, ets_prune, mcts_step  # noqa: F401
from .ilp import (SelectionProblem, SelectionResult, greedy_select,  # noqa: F401
                  milp_select, solve)
from .rebase import rebase_reweight, rebase_weights  # noqa: F401
from .replica import EngineReplica, ReplicaSweep  # noqa: F401
from .serving import (ReplicaServingLoop, Request,  # noqa: F401
                      ServingConfig, ServingLoop, SLOTracker, load_trace,
                      poisson_requests)
from .synthetic import (SyntheticProblem, SyntheticSweep,  # noqa: F401
                        SyntheticTaskConfig, evaluate_method)
from .tree import Node, SearchTree  # noqa: F401
