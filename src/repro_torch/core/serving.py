"""Online serving loop: SLO-tracked request arrival over the sweep
(copied from ``repro.core.serving``).

The :class:`SweepScheduler` drives a *batch* workload — every problem
is present at t=0 and the sweep ends when the last one retires.  An
online server sees something else entirely: requests arrive over time
(bursty, prioritized, some with deadlines), and the metric that matters
is each request's time-to-answer (TTA), not aggregate throughput.

:class:`ServingLoop` layers that onto the same machinery:

  * **Arrival process** — requests carry an arrival time (Poisson via
    :func:`poisson_requests`, or a replayed trace via
    :func:`load_trace`) and wait in a pending set until the virtual
    clock reaches them; released requests queue in priority order.
    The clock is *virtual* and deterministic: every stage charges a
    configured cost (decode iteration, PRM score, embed, prefill), so
    a run is a pure function of (requests, seed, costs) — measurable
    in CI without wall-clock noise.
  * **Priority classes + deadlines** — admission order is
    ``(-priority, arrival, index)``; under memory pressure the victim
    is the problem with the largest *deadline slack* (deadline minus
    clock minus estimated remaining work — see ``_slack`` and
    ``repro_torch.kvcache.allocator.select_victim``), so demotion stalls the
    request that can best afford it.  Deadlines are SLOs, not aborts:
    a missed deadline is reported, never dropped.
  * **Token-level refill** (``ServingConfig.refill``) — instead of the
    sweep's lock-step barrier (every problem's step ends before any
    problem's next step starts), the loop keeps one persistent
    :class:`~repro_torch.serving.engine.DecodeStream` and seats decode rows
    into slots the moment they free up, mid-step, from whichever
    problem has demand.  A problem whose branches all stop early
    scores/prunes/retires immediately — its pages return to the pool
    and queued requests admit sooner, which is where the p99 TTA win
    over lock-step comes from.  Composition-independent sampling
    (per-row fold_in keys) makes the refill schedule invisible to
    every token stream, so a degenerate trace (all arrivals at t=0,
    no deadlines) reproduces ``run_search_many`` answers exactly.
  * **First-Finish mode** (``ServingConfig.first_finish``) — the
    latency-optimal early exit: a problem halts the moment its first
    trajectory completes, taking that trajectory's answer.

Everything here is backend-agnostic: the row-level interface
(``expand_begin`` / ``expand_finish`` / ``open_stream``) is used when
the backend provides it, and the loop degrades to whole-step
event-driven scheduling (still per-problem clocks, no barrier) when it
does not — synthetic test backends exercise the same control flow.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import tracing
from .controllers import (AdaptiveConfig, SearchConfig, SearchResult,
                          SweepScheduler, _embed_multi, _expand_multi,
                          _score_multi)

__all__ = [
    "Request", "ServingConfig", "SLOTracker", "ServingLoop",
    "ReplicaServingLoop", "poisson_requests", "load_trace",
]


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------

@dataclass
class Request:
    """One serving request: a prompt plus its arrival-time metadata."""
    prompt: Sequence[int]
    arrival: float = 0.0           # virtual-clock arrival time
    priority: int = 0              # higher admits first
    deadline: Optional[float] = None   # absolute SLO deadline (clock units)


def poisson_requests(prompts: Sequence[Sequence[int]], rate: float,
                     seed: int = 0,
                     priorities: Optional[Sequence[int]] = None,
                     deadline_slack: Optional[float] = None
                     ) -> List[Request]:
    """Poisson arrival process over ``prompts``, deterministic in ``seed``.

    Inter-arrival gaps are exponential with mean ``1/rate`` (requests
    per unit virtual time).  ``priorities`` (cycled over the prompt
    list) assigns classes; ``deadline_slack`` gives every request the
    absolute deadline ``arrival + slack``.
    """
    assert rate > 0, rate
    rng = np.random.default_rng(seed)
    t = 0.0
    out: List[Request] = []
    for i, p in enumerate(prompts):
        t += float(rng.exponential(1.0 / rate))
        prio = int(priorities[i % len(priorities)]) if priorities else 0
        dl = t + float(deadline_slack) if deadline_slack is not None else None
        out.append(Request(prompt=list(p), arrival=t, priority=prio,
                           deadline=dl))
    return out


def load_trace(path: str) -> List[Request]:
    """Load a request trace: a JSON list of objects with a ``prompt``
    token list and optional ``arrival`` / ``priority`` / ``deadline``."""
    with open(path) as f:
        data = json.load(f)
    out = []
    for d in data:
        dl = d.get("deadline")
        out.append(Request(prompt=list(d["prompt"]),
                           arrival=float(d.get("arrival", 0.0)),
                           priority=int(d.get("priority", 0)),
                           deadline=float(dl) if dl is not None else None))
    return out


# ---------------------------------------------------------------------------
# SLO accounting
# ---------------------------------------------------------------------------

@dataclass
class SLOTracker:
    """Per-request lifecycle stamps on the virtual clock."""
    arrivals: Dict[int, float] = field(default_factory=dict)
    admitted: Dict[int, float] = field(default_factory=dict)
    finished: Dict[int, float] = field(default_factory=dict)
    deadlines: Dict[int, float] = field(default_factory=dict)
    priorities: Dict[int, int] = field(default_factory=dict)

    def note_arrival(self, idx: int, t: float, priority: int = 0,
                     deadline: Optional[float] = None) -> None:
        self.arrivals[idx] = float(t)
        self.priorities[idx] = int(priority)
        if deadline is not None:
            self.deadlines[idx] = float(deadline)

    def note_admit(self, idx: int, t: float) -> None:
        self.admitted[idx] = float(t)

    def note_finish(self, idx: int, t: float) -> None:
        self.finished[idx] = float(t)

    def tta(self) -> Dict[int, float]:
        """Time-to-answer per finished request."""
        return {i: self.finished[i] - self.arrivals[i]
                for i in self.finished}

    def report(self) -> Dict[str, Any]:
        """Latency percentiles + deadline hit rate over finished
        requests (``deadline_hit_rate`` is None without deadlines)."""
        ttas = sorted(self.tta().values())
        out: Dict[str, Any] = {"n_finished": len(ttas)}
        if ttas:
            arr = np.asarray(ttas)
            out.update(
                p50_tta=float(np.percentile(arr, 50)),
                p90_tta=float(np.percentile(arr, 90)),
                p99_tta=float(np.percentile(arr, 99)),
                mean_tta=float(arr.mean()),
                max_tta=float(arr.max()),
            )
        withdl = [i for i in self.finished if i in self.deadlines]
        out["deadline_hit_rate"] = (
            sum(self.finished[i] <= self.deadlines[i] for i in withdl)
            / len(withdl)) if withdl else None
        return out


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

@dataclass
class ServingConfig:
    """Serving policy + virtual cost model.

    ``refill`` selects the scheduling mode: False runs the sweep's
    lock-step barrier (one global step per tick — the baseline the
    benchmarks compare against); True runs event-driven per-problem
    step clocks with token-level row refill when the backend exposes
    the row-level interface.  Costs are in arbitrary virtual-clock
    units; only their ratios matter for the latency comparison.
    """
    refill: bool = True
    first_finish: bool = False
    decode_iter_cost: float = 1.0   # one lock-step decode iteration
    score_cost: float = 1.0         # one PRM call
    embed_cost: float = 0.5         # one embedder call
    prefill_cost: float = 0.5       # one admitted problem's prefill
    est_step_cost: Optional[float] = None   # override for slack estimate

    @classmethod
    def from_stage_costs(cls, costs: Dict[str, Any],
                         **overrides) -> "ServingConfig":
        """Fit the virtual cost model to measured per-stage wall times.

        ``costs`` is the schema of ``experiments/bench/stage_costs.json``
        (written by the benchmark run — see
        ``benchmarks/table2_throughput.py``): seconds per stage under
        ``decode_iter_s`` / ``score_s`` / ``embed_s`` / ``prefill_s``.
        The decode iteration is the unit — every other cost becomes its
        measured ratio to it — because only cost *ratios* enter the
        virtual clock's scheduling decisions.  Missing/zero entries keep
        the dataclass defaults; ``overrides`` pass through to the
        constructor (``refill=...`` etc.).
        """
        base = float(costs.get("decode_iter_s") or 0.0)

        def ratio(key: str, default: float) -> float:
            v = float(costs.get(key) or 0.0)
            return v / base if base > 0 and v > 0 else default

        kw = dict(decode_iter_cost=1.0,
                  score_cost=ratio("score_s", cls.score_cost),
                  embed_cost=ratio("embed_s", cls.embed_cost),
                  prefill_cost=ratio("prefill_s", cls.prefill_cost))
        kw.update(overrides)
        return cls(**kw)


class ServingLoop(SweepScheduler):
    """Serve timed requests on one shared backend (see module docs).

    ``run()`` returns per-request :class:`SearchResult` in request
    order; ``slo.report()`` has the latency percentiles.  With a
    degenerate workload (all arrivals 0, no deadlines, ``refill``
    False) results are bit-identical to ``run_search_many`` on the
    same backend.
    """

    def __init__(self, backend, scfg: SearchConfig,
                 requests: Sequence[Request], *,
                 max_live: Optional[int] = None,
                 cfg: Optional[ServingConfig] = None,
                 adaptive: Optional[AdaptiveConfig] = None):
        reqs = list(requests)
        # keyed by request index (not a plain list): replica routing
        # registers late arrivals under their GLOBAL index via submit()
        self.requests: Dict[int, Request] = dict(enumerate(reqs))
        self.cfg = cfg if cfg is not None else ServingConfig()
        super().__init__(backend, scfg,
                         prompts=[r.prompt for r in reqs],
                         max_live=max_live, adaptive=adaptive)
        self.clock = 0.0
        self.slo = SLOTracker()
        self._priority = {i: r.priority for i, r in enumerate(reqs)}
        self._deadline = {i: r.deadline for i, r in enumerate(reqs)
                          if r.deadline is not None}
        for i, r in enumerate(reqs):
            self.slo.note_arrival(i, r.arrival, priority=r.priority,
                                  deadline=r.deadline)
        # arrival gating: the base class queued everything at t=0; hold
        # requests in _pending until the clock reaches their arrival
        self._pending: List[Tuple[float, int, Any]] = sorted(
            (reqs[i].arrival, i, item) for i, item in self._queue)
        self._queue = []
        # token-level refill state (row-level backends only)
        self._rowlevel = all(hasattr(backend, m) for m in (
            "expand_begin", "expand_finish", "open_stream",
            "stream_budget"))
        self._stream = None
        self._tickets: Dict[int, Any] = {}        # idx -> ExpandTicket
        self._waiting: Dict[int, Set[int]] = {}   # idx -> undecoded bids
        self._owner: Dict[int, int] = {}          # branch id -> idx
        self._jobq: List[Tuple[int, int, int]] = []   # (idx, bid, row#)
        # finish-stamp deferral (lock-step mode stamps at tick end, so
        # every problem retiring in a barrier step observes the same
        # post-charge clock — that IS the barrier cost being modeled)
        self._defer_stamps = False
        self._retired_this_tick: List[int] = []
        # slack estimate: expected cost of one remaining search step
        if self.cfg.est_step_cost is not None:
            self._est_step = float(self.cfg.est_step_cost)
        else:
            budget_fn = getattr(backend, "stream_budget", None)
            toks = int(budget_fn()) if budget_fn is not None else 8
            self._est_step = (self.cfg.decode_iter_cost * toks
                              + self.cfg.score_cost + self.cfg.embed_cost)

    # -- late registration (replica routing) ---------------------------
    def submit(self, idx: int, req: Request) -> None:
        """Register one request after construction, under a caller-chosen
        (globally unique) index.

        This is the hand-off point of :class:`ReplicaServingLoop`: the
        replica pool holds the single arrival stream and calls
        ``submit`` on whichever loop it routes each request to, so a
        loop only ever sees — and charges virtual time for — its own
        requests.  The request still waits in ``_pending`` until this
        loop's clock reaches its arrival time, exactly like a
        constructor-passed request."""
        import bisect
        assert idx not in self.requests, f"duplicate request index {idx}"
        self.requests[idx] = req
        self._priority[idx] = req.priority
        if req.deadline is not None:
            self._deadline[idx] = req.deadline
        self.slo.note_arrival(idx, req.arrival, priority=req.priority,
                              deadline=req.deadline)
        bisect.insort(self._pending, (req.arrival, idx, list(req.prompt)))
        # standalone submit-driven loops with contiguous indices can
        # still use run(); replica pools merge .results themselves
        self._n = max(self._n, idx + 1)

    # -- virtual clock -------------------------------------------------
    def _charge(self, cost: float) -> None:
        self.clock += float(cost)

    def _release_arrivals(self) -> None:
        """Move requests whose arrival time has passed into the
        admission queue, kept in (priority desc, arrival, index) order."""
        moved = False
        while self._pending and self._pending[0][0] <= self.clock:
            _, i, item = self._pending.pop(0)
            self._queue.append((i, item))
            moved = True
        if moved:
            self._queue.sort(key=lambda e: (-self._priority.get(e[0], 0),
                                            self.requests[e[0]].arrival,
                                            e[0]))

    # -- scheduler hook overrides --------------------------------------
    def _slack(self, idx: int) -> float:
        """Deadline slack: time to deadline minus estimated remaining
        work.  Infinite without a deadline — pressure then falls back
        to the base lowest-score victim policy."""
        dl = self._deadline.get(idx)
        if dl is None:
            return math.inf
        st = self.live.get(idx) or self.parked.get(idx)
        remaining = max(self.scfg.max_steps - (st.steps if st else 0), 0)
        return (dl - self.clock) - remaining * self._est_step

    def _demotable(self, idx: int) -> bool:
        """Problems with rows seated in (or queued for) the open decode
        stream hold KV their in-flight rows attend over — swapping them
        out mid-decode would corrupt the stream, so they are pinned."""
        return idx not in self._tickets

    def _admit(self) -> None:
        before = set(self.live)
        super()._admit()
        admitted = sorted(i for i in self.live if i not in before)
        for i in admitted:
            self.slo.note_admit(i, self.clock)
        if admitted:
            self._charge(self.cfg.prefill_cost * len(admitted))

    def _retire(self, idx: int) -> None:
        super()._retire(idx)
        self._retired_this_tick.append(idx)
        if not self._defer_stamps:
            self.slo.note_finish(idx, self.clock)

    # -- ticks ---------------------------------------------------------
    @tracing.span("tick")
    def tick(self) -> bool:
        """Advance the server by one scheduling quantum.  Returns True
        while any request is pending, queued, or in flight."""
        self._release_arrivals()
        if not (self.live or self.parked or self._queue):
            if not self._pending:
                return False
            # idle: jump the clock to the next arrival
            self.clock = max(self.clock, self._pending[0][0])
            self._release_arrivals()
        if self.cfg.refill:
            return self._tick_event()
        return self._tick_lockstep()

    def _tick_lockstep(self) -> bool:
        """Barrier mode: one sweep global step per tick, with stage
        costs charged and finish stamps deferred to the barrier end."""
        eng = getattr(self.backend, "engine", None)
        d0 = getattr(eng, "n_decode_steps", 0) if eng is not None else 0
        g0 = self.stats.global_steps
        self._retired_this_tick = []
        self._defer_stamps = True
        try:
            more = super().step()
        finally:
            self._defer_stamps = False
        if self.stats.global_steps > g0:
            iters = (getattr(eng, "n_decode_steps", 0) - d0) \
                if eng is not None else 0
            self._charge(iters * self.cfg.decode_iter_cost if iters
                         else self._est_step - self.cfg.score_cost
                         - self.cfg.embed_cost)
            self._charge(self.cfg.score_cost + self.cfg.embed_cost)
        for idx in self._retired_this_tick:
            self.slo.note_finish(idx, self.clock)
        return more or bool(self._pending)

    def _tick_event(self) -> bool:
        """Event mode: per-problem step clocks, no cross-problem
        barrier; token-level refill when the backend supports it."""
        self._retired_this_tick = []
        if self._mem:
            self._resume_parked()
        self._admit()
        if self._mem:
            self._update_peaks()
            self._handle_pressure()
        if self._rowlevel:
            self._pump_stream()
        else:
            self._step_one_problem()
        return bool(self.live or self.parked or self._queue
                    or self._pending)

    # -- event mode: token-level refill --------------------------------
    def _pump_stream(self) -> None:
        stream = self._stream
        if stream is None:
            stream = self._stream = self.backend.open_stream()
        # 1. every demand-phase problem posts its step's decode rows
        #    (branched + keyed now; seated as slots free up)
        for idx in sorted(self.live):
            st = self.live[idx]
            if idx in self._tickets or st.phase != "demand":
                continue
            self._adapt(idx, st)
            lc = st.demand()
            if lc is None:
                self._retire(idx)
                continue
            ticket = self.backend.expand_begin(st.tree, lc)
            if not ticket.branches:
                st.note_children([])    # empty expansion ends the search
                assert st.finished
                self._retire(idx)
                continue
            self._tickets[idx] = ticket
            self._waiting[idx] = set(ticket.branches)
            for row, bid in enumerate(ticket.branches):
                self._owner[bid] = idx
                self._jobq.append((idx, bid, row))
        # 2. refill free slots, highest priority first (row keys make
        #    seat timing invisible to the sampled streams)
        if self._jobq and stream.n_free:
            self._jobq.sort(key=lambda e: (
                -self._priority.get(e[0], 0), e[0], e[2]))
            take, self._jobq = (self._jobq[:stream.n_free],
                                self._jobq[stream.n_free:])
            keys = np.stack([self._tickets[i].row_keys[row]
                             for i, _, row in take])
            stream.add([bid for _, bid, _ in take], keys,
                       self.backend.stream_budget())
        # 3. ONE lock-step iteration over the seated rows
        if not stream.live:
            return
        finished = stream.step()
        self._charge(self.cfg.decode_iter_cost)
        done: List[int] = []
        for bid in finished:
            idx = self._owner.pop(bid)
            pend = self._waiting[idx]
            pend.discard(bid)
            if not pend:
                done.append(idx)
        # 4. problems whose step fully decoded score/prune/retire NOW —
        #    no barrier on the other problems' rows.  Every completion
        #    landing in this same tick batches into ONE padded
        #    score_multi call (and one embed_multi call), so event mode
        #    charges a scoring pass per *tick*, exactly like lock-step
        #    mode does per barrier — instead of one PRM call per
        #    problem.  score_multi is composition-independent, so the
        #    batched scores are bit-identical to per-problem calls.
        batch: List[Tuple[int, Any, List[int]]] = []
        for idx in sorted(set(done)):
            ticket = self._tickets.pop(idx)
            self._waiting.pop(idx, None)
            outs = {bid: stream.out.pop(bid) for bid in ticket.branches}
            kids = self.backend.expand_finish(ticket, outs)
            st = self.live[idx]
            to_score = st.note_children(kids)
            if st.finished:
                self._retire(idx)
                continue
            batch.append((idx, st, to_score))
        if not batch:
            return
        all_scores = _score_multi(self.backend,
                                  [(st.tree, ts) for _, st, ts in batch])
        self._charge(self.cfg.score_cost)
        embeds: List[Tuple[int, Any, List[int]]] = []
        for (idx, st, _), scores in zip(batch, all_scores):
            if self.controller is not None:
                self.controller.observe(idx, st, scores)
            to_embed = st.note_scores(scores)
            if st.finished:
                self._retire(idx)
                continue
            if self.cfg.first_finish and st.completed:
                st.halt()           # First-Finish: first answer wins
                self._retire(idx)
                continue
            if to_embed:
                embeds.append((idx, st, to_embed))
            else:
                st.complete_step(None)
        if embeds:
            all_embs = _embed_multi(self.backend,
                                    [(st.tree, te) for _, st, te in embeds])
            self._charge(self.cfg.embed_cost)
            for (_, st, _), embs in zip(embeds, all_embs):
                st.complete_step(embs)

    # -- event mode: whole-step fallback -------------------------------
    def _step_one_problem(self) -> None:
        """Advance the most urgent demand-phase problem one full step
        (backends without the row-level interface: still per-problem
        clocks and priorities, just no mid-step refill)."""
        cands = [i for i in sorted(self.live)
                 if self.live[i].phase == "demand"]
        if not cands:
            return
        idx = min(cands, key=lambda i: (self._slack(i),
                                        -self._priority.get(i, 0), i))
        st = self.live[idx]
        self._adapt(idx, st)
        lc = st.demand()
        if lc is None:
            self._retire(idx)
            return
        kids = _expand_multi(self.backend, [(st.tree, lc)])[0]
        self._charge(self.cfg.decode_iter_cost *
                     max((st.tree.node(k).n_tokens for k in kids),
                         default=1))
        self._complete_step(idx, kids)

    # -- one problem's post-decode stages ------------------------------
    def _complete_step(self, idx: int, kids: Sequence[int]) -> None:
        st = self.live[idx]
        to_score = st.note_children(kids)
        if st.finished:
            self._retire(idx)
            return
        scores = _score_multi(self.backend, [(st.tree, to_score)])[0]
        self._charge(self.cfg.score_cost)
        if self.controller is not None:
            self.controller.observe(idx, st, scores)
        to_embed = st.note_scores(scores)
        if st.finished:
            self._retire(idx)
            return
        if self.cfg.first_finish and st.completed:
            st.halt()               # First-Finish: first answer wins
            self._retire(idx)
            return
        if to_embed:
            embs = _embed_multi(self.backend, [(st.tree, to_embed)])[0]
            self._charge(self.cfg.embed_cost)
            st.complete_step(embs)
        else:
            st.complete_step(None)

    # -- drive ---------------------------------------------------------
    def run(self) -> List[SearchResult]:
        while self.tick():
            pass
        return [self.results[i] for i in range(self._n)]


# ---------------------------------------------------------------------------
# Replica pool: N serving loops behind one arrival stream
# ---------------------------------------------------------------------------

class ReplicaServingLoop:
    """Serve ONE timed arrival stream on N engine replicas.

    Each replica is a full :class:`ServingLoop` over its own backend
    (engine, pool, spill buffer, reservations) constructed empty; this
    pool holds the global arrival stream and routes each request, at
    its arrival time, to the least-loaded replica (pluggable via
    ``router`` — signature as :data:`repro_torch.core.replica.Router`).
    Routed requests are registered under their GLOBAL index via
    :meth:`ServingLoop.submit`, so namespaces, demotion, and refill
    inside each loop are untouched — a replica cannot tell it is one
    of many.

    Clock semantics: every replica runs its own virtual clock (real
    replicas run concurrently, so their virtual times overlap rather
    than add).  The drive loop keeps them loosely synchronized at
    routing points — before a request routes at arrival time ``t``,
    any replica whose clock lags ``t`` ticks first — so the load each
    routing decision sees is each replica's state *at* ``t``, making a
    run a pure function of (requests, seed, costs, router).

    Bit-identity: per-problem RNG namespaces are seeded from the
    backend seed alone, so with identically-seeded backends a request's
    answer is independent of which replica serves it — per-request
    results reproduce a serial single-replica run exactly.

    ``max_live`` is per replica (None: even split of the request
    count).  ``run()`` returns results in request order;
    :attr:`slo` merges every replica's tracker for a fleet-wide report.
    """

    def __init__(self, backends: Sequence[Any], scfg: SearchConfig,
                 requests: Sequence[Request], *,
                 max_live: Optional[int] = None,
                 cfg: Optional[ServingConfig] = None,
                 adaptive: Optional[AdaptiveConfig] = None,
                 router=None):
        from .replica import _least_loaded
        assert len(backends) >= 1, "need at least one backend"
        reqs = list(requests)
        self._n = len(reqs)
        if max_live is None:
            per = -(-max(self._n, 1) // len(backends))   # ceil split
        else:
            per = max_live
        self.loops = [ServingLoop(b, scfg, [], max_live=per, cfg=cfg,
                                  adaptive=adaptive) for b in backends]
        self.router = router or _least_loaded
        self._arrivals: List[Tuple[float, int, Request]] = sorted(
            ((r.arrival, i, r) for i, r in enumerate(reqs)),
            key=lambda e: (e[0], e[1]))
        self.routed: Dict[int, int] = {}       # idx -> replica id

    # -- load ----------------------------------------------------------
    @staticmethod
    def _load(lp: ServingLoop) -> int:
        """Requests a replica is responsible for right now."""
        return (len(lp.live) + len(lp.parked) + len(lp._queue)
                + len(lp._pending))

    def _active(self) -> List[int]:
        return [k for k, lp in enumerate(self.loops)
                if lp.live or lp.parked or lp._queue or lp._pending]

    # -- one scheduling quantum ----------------------------------------
    def step(self) -> bool:
        """Route or tick once.  Returns True while work remains.

        While arrivals are outstanding, replicas lagging the next
        arrival time catch up one tick at a time (laggard with the
        smallest clock first — a deterministic merge of the replica
        timelines); once none lag, the arrival routes.  With no
        arrivals left, every active replica ticks each quantum.
        """
        active = self._active()
        if self._arrivals:
            t = self._arrivals[0][0]
            lag = [k for k in active if self.loops[k].clock < t]
            if lag:
                k = min(lag, key=lambda k: (self.loops[k].clock, k))
                self.loops[k].tick()
                return True
            _, idx, req = self._arrivals.pop(0)
            loads = [self._load(lp) for lp in self.loops]
            eligible = list(range(len(self.loops)))
            rid = self.router(eligible, loads)
            assert rid in eligible, rid
            self.routed[idx] = rid
            self.loops[rid].submit(idx, req)
            return True
        if not active:
            return False
        for k in active:
            self.loops[k].tick()
        return True

    def run(self) -> List[SearchResult]:
        while self.step():
            pass
        merged: Dict[int, SearchResult] = {}
        for lp in self.loops:
            merged.update(lp.results)
        assert len(merged) == self._n, (len(merged), self._n)
        return [merged[i] for i in range(self._n)]

    # -- fleet-wide introspection --------------------------------------
    @property
    def results(self) -> Dict[int, SearchResult]:
        merged: Dict[int, SearchResult] = {}
        for lp in self.loops:
            merged.update(lp.results)
        return merged

    @property
    def slo(self) -> SLOTracker:
        """Union of every replica's tracker (indices are global, so the
        dicts are disjoint by construction)."""
        out = SLOTracker()
        for lp in self.loops:
            out.arrivals.update(lp.slo.arrivals)
            out.admitted.update(lp.slo.admitted)
            out.finished.update(lp.slo.finished)
            out.deadlines.update(lp.slo.deadlines)
            out.priorities.update(lp.slo.priorities)
        return out

    @property
    def clock(self) -> float:
        """Fleet makespan: the furthest replica clock (replicas run
        concurrently, so wall time is the max, not the sum)."""
        return max(lp.clock for lp in self.loops)
