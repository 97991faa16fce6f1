"""Horizontal sweep scaling: N engine replicas behind ONE admission queue
(copied from ``repro.core.replica``).

Each :class:`EngineReplica` wraps one backend (its own engine, KV pool,
allocator, spill buffer) plus a private :class:`SweepScheduler` that
drives the problems routed to it — so reservations, the
``WorkingSetEstimator``, demotion, and namespace refill all stay
per-replica with zero cross-replica coordination.  The
:class:`ReplicaSweep` on top holds the single global admission queue and
routes each queued problem to the least-loaded replica (pluggable via
``router``) the moment that replica has room.

Bit-identity contract: a problem's result depends only on its own RNG
namespace, which the backend seeds from the backend seed alone
(``serving/search_backend.py``) — identically on every replica.  Which
replica a problem lands on, and when, is therefore invisible to its
sampled streams, so a multi-replica sweep reproduces serial
single-replica runs per problem exactly (property-tested over random
routers in ``tests/test_torch_replica.py``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

from .controllers import (AdaptiveConfig, SearchConfig, SearchResult,
                          SweepScheduler)


class EngineReplica:
    """One backend + its private sweep scheduler.

    ``max_live`` bounds how many problems this replica holds at once
    (live + parked); its reservation ledger and estimator are its own —
    replicas never share pool pages, so nothing global needs locking.
    """

    def __init__(self, rid: int, backend, scfg: SearchConfig, *,
                 max_live: int,
                 spill: str = "namespace",
                 adaptive: Optional[AdaptiveConfig] = None):
        self.rid = rid
        self.backend = backend
        self.sched = SweepScheduler(backend, scfg, prompts=[],
                                    max_live=max_live, spill=spill,
                                    adaptive=adaptive)

    @property
    def load(self) -> int:
        """Problems this replica is responsible for right now
        (live + parked + routed-but-unadmitted)."""
        s = self.sched
        return len(s.live) + len(s.parked) + len(s._queue)

    @property
    def has_room(self) -> bool:
        return self.load < self.sched.max_live


# router(eligible_rids, loads) -> chosen rid; eligible is non-empty and
# sorted, loads is indexed by rid.  The default picks the least-loaded
# (ties toward the lowest rid).
Router = Callable[[List[int], List[int]], int]


def _least_loaded(eligible: List[int], loads: List[int]) -> int:
    return min(eligible, key=lambda r: (loads[r], r))


class ReplicaSweep:
    """Drive N per-replica sweeps from one admission queue.

    Problems enter a single FIFO queue in prompt order; each global
    step first drains the queue head-first into replicas with room
    (``router`` picks among the eligible ones — default least-loaded),
    then steps EVERY replica's scheduler once.  All replicas step every
    round even when one returns "no work": short-circuiting on the
    first busy replica would stall the others' retirements and stretch
    the makespan.

    ``max_live`` is per replica (None: an even split of the problem
    count, at least 1).  Results merge by global problem index, so the
    output order matches the input prompts regardless of routing.
    """

    def __init__(self, backends: Sequence[Any], scfg: SearchConfig,
                 prompts: Sequence[Sequence[int]], *,
                 max_live: Optional[int] = None,
                 spill: str = "namespace",
                 adaptive: Optional[AdaptiveConfig] = None,
                 router: Optional[Router] = None):
        assert len(backends) >= 1, "need at least one backend"
        self._n = len(prompts)
        self._queue: List[Tuple[int, Any]] = list(enumerate(prompts))
        self.router: Router = router or _least_loaded
        if max_live is None:
            per = -(-max(self._n, 1) // len(backends))   # ceil split
        else:
            per = max_live
        self.replicas = [EngineReplica(rid, b, scfg, max_live=per,
                                       spill=spill, adaptive=adaptive)
                         for rid, b in enumerate(backends)]

    # -- routing -------------------------------------------------------
    def _route(self) -> None:
        """Move queued problems onto replicas with room, head first.

        Appending to a replica's private scheduler queue (keyed by the
        GLOBAL problem index — schedulers treat indices as opaque dict
        keys) hands the problem over completely: admission control,
        reservations, and pressure from here on are that replica's
        business.
        """
        while self._queue:
            loads = [rep.load for rep in self.replicas]
            eligible = [rep.rid for rep in self.replicas if rep.has_room]
            if not eligible:
                return
            rid = self.router(eligible, loads)
            assert rid in eligible, \
                f"router chose replica {rid} without room (eligible " \
                f"{eligible})"
            self.replicas[rid].sched._queue.append(self._queue.pop(0))

    # -- one global step -----------------------------------------------
    def step(self) -> bool:
        """Route, then advance every replica one global step.

        Returns True while any replica (or the global queue) has work."""
        self._route()
        more = [rep.sched.step() for rep in self.replicas]
        return any(more) or bool(self._queue)

    def run(self) -> List[SearchResult]:
        while self.step():
            pass
        merged = {}
        for rep in self.replicas:
            merged.update(rep.sched.results)
        assert len(merged) == self._n, (len(merged), self._n)
        return [merged[i] for i in range(self._n)]

    # -- introspection -------------------------------------------------
    @property
    def results(self) -> dict:
        merged = {}
        for rep in self.replicas:
            merged.update(rep.sched.results)
        return merged

    def total_global_steps(self) -> int:
        return sum(rep.sched.stats.global_steps for rep in self.replicas)
