"""Unified PRM-guided tree-search controllers.

One loop, six retention policies (the paper's baselines + ETS):

  * ``beam``    — keep the top-k candidates by reward, split the budget
                  evenly (Snell et al., 2024).  k fixed or sqrt(N).
  * ``dvts``    — k independent subtrees, top-1 beam within each
                  (Beeching et al., 2024).
  * ``rebase``  — keep everything, allocate by Eq. 1 (Wu et al., 2024).
  * ``ets``     — REBASE weights + ILP prune + re-weight (this paper).
  * ``ets-kv``  — ETS with lambda_d = 0 (Table 3 ablation).
  * ``mcts``    — Adaptive Parallel MCTS (PAPERS.md): UCT over visit
                  counts, arms within a gap of the best stay
                  parallel-expanded, REBASE split over the kept arms.

The controller is generation-backend-agnostic: backends expand leaves,
score them with a PRM, and embed last steps.  Backends include the
synthetic oracle task (search-dynamics experiments; core/synthetic.py) and
the real LM engine (serving/search_backend.py).

Step machine
------------
``SearchState`` is the search loop opened up at its backend-call
boundaries — a resumable state machine instead of a closed loop:

    demand() -> leaf_counts        what this problem wants expanded next
    note_children(kids) -> nodes   to be PRM-scored
    note_scores(scores) -> nodes   to be embedded (may be empty)
    complete_step(embs)            retention policy, prune, bookkeeping

``run_search`` drives one state to completion and is bit-identical to
the historical closed loop; ``SweepScheduler`` drives *many* states in
lock-step so the expensive stages batch across problems (below).

Batched step protocol
---------------------
One search step makes O(1) backend calls, not O(leaves):

  * ``expand_many(tree, leaf_counts)`` — ``leaf_counts`` is a sequence of
    ``(leaf_id, n)`` pairs; the backend expands *all* of them (the LM
    engine decodes every new branch in a single lock-step batched stream)
    and returns the new node ids **flat, grouped by leaf, in
    ``leaf_counts`` order** — each leaf's children contiguous and in
    sampling order.  The controller recovers the grouping via
    ``tree.node(kid).parent``.
  * ``score_many(tree, nodes)`` — PRM rewards for all candidates in one
    call (the LM backend pads to power-of-two buckets so its jitted
    scorer does not recompile per sequence length).
  * ``embed_many(tree, nodes)`` — stacked (L, D) last-step embeddings.

Fallback contract: the ``Backend`` protocol ships default ``*_many``
bodies that loop over the single-node methods in order, so a third-party
backend that only implements ``expand``/``score``/``embed`` keeps
working — ``run_search`` dispatches through ``getattr`` and falls back to
the same per-node loop when a backend (structural, non-subclassing)
lacks the batched methods.  The RNG-visible call order of the fallbacks
is identical to the legacy serial loop, so for a deterministic backend
``run_search(..., batched=True)`` and ``batched=False`` produce
bit-identical trees.

Cross-problem batching (the sweep protocol)
-------------------------------------------
``SweepScheduler`` interleaves many problems' search steps so the decode
batch stays full as individual searches narrow and finish.  Each global
step it gathers every live problem's ``(leaf, count)`` demand and issues
ONE ``expand_multi`` / ``score_multi`` / ``embed_multi`` call over the
union; backends without the ``*_multi`` methods fall back to a
per-problem loop of the ``*_many`` protocol (same per-problem call
order, so deterministic backends produce bit-identical per-problem
results either way).  Queued problems are admitted in batches (one
``start_many`` flash-prefill stream per admission wave) as live problems
finish and release pool pages; completed problems retire immediately —
``finish_problem`` releases their engine state — without stalling the
rest.  ``run_search_many`` routes sweeps through the scheduler by
default.

Per the paper (§5.1): the search width shrinks as trajectories complete,
and the final answer is selected by weighted majority voting with the
final PRM score as weight.

Difficulty-adaptive compute allocation
--------------------------------------
Uniform per-problem width wastes budget: easy problems solve at a
fraction of the configured width while hard ones would profit from
more (Snell et al., 2024; ROADMAP item 3).  ``AdaptiveConfig`` +
``BudgetController`` turn the sweep's early PRM scores into an online
difficulty signal and re-target each problem's effective width
(``SearchState.set_width``) at the demand boundary, under a global
generated-token budget; the scheduler re-books the problem's admission
reservation against the adapted width (``_rebook``), so the
``WorkingSetEstimator``-based reservations track what the problem will
actually use instead of the a-priori ``width x step-pages`` bound.
With ``enabled=False`` (or no ``adaptive`` config at all) every hook is
a strict no-op and the sweep stays bit-identical to ``run_search_many``
— property-tested in ``tests/test_adaptive.py``.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from typing import (Any, Dict, List, Optional, Protocol, Sequence, Tuple,
                    Union)

import numpy as np

from .ets import ETSConfig, ets_prune, mcts_step
from .rebase import rebase_weights
from .tree import SearchTree


# Canonical serial fallback loops: the ONE place that defines the
# single-node call order (the property the serial/batched bit-equivalence
# tests depend on).  Used by the Backend protocol's default *_many bodies,
# by run_search's getattr dispatch for structural backends without them,
# and by run_search's forced-serial path.

def _serial_expand(backend, tree: SearchTree,
                   leaf_counts: Sequence[Tuple[int, int]]) -> List[int]:
    out: List[int] = []
    for leaf, n in leaf_counts:
        out.extend(backend.expand(tree, leaf, n))
    return out


def _serial_score(backend, tree: SearchTree,
                  nodes: Sequence[int]) -> List[float]:
    return [backend.score(tree, nid) for nid in nodes]


def _serial_embed(backend, tree: SearchTree,
                  nodes: Sequence[int]) -> np.ndarray:
    return np.stack([backend.embed(tree, nid) for nid in nodes])


class Backend(Protocol):
    def expand(self, tree: SearchTree, leaf: int, n: int) -> List[int]:
        """Sample n continuations of `leaf`; add to tree; return node ids."""
        ...

    def score(self, tree: SearchTree, node: int) -> float:
        """PRM reward for the partial trajectory ending at `node`."""
        ...

    def embed(self, tree: SearchTree, node: int) -> np.ndarray:
        """Semantic embedding of the node's last step."""
        ...

    def answer(self, tree: SearchTree, leaf: int) -> Any:
        """Final answer of a finished trajectory."""
        ...

    # -- batched step API (default: loop over the single-node methods) ----
    def expand_many(self, tree: SearchTree,
                    leaf_counts: Sequence[Tuple[int, int]]) -> List[int]:
        """Expand every (leaf, n) pair; return new node ids flat.

        Children are grouped by leaf, contiguous, in ``leaf_counts``
        order.  Backends override this to batch the whole step (one
        decode stream); the default preserves the serial call order.
        """
        return _serial_expand(self, tree, leaf_counts)

    def score_many(self, tree: SearchTree,
                   nodes: Sequence[int]) -> List[float]:
        """PRM rewards for all `nodes`, in order."""
        return _serial_score(self, tree, nodes)

    def embed_many(self, tree: SearchTree,
                   nodes: Sequence[int]) -> np.ndarray:
        """Stacked (len(nodes), D) embeddings, in order."""
        return _serial_embed(self, tree, nodes)


@dataclass
class SearchConfig:
    method: str = "ets"       # beam | dvts | rebase | ets | ets-kv | mcts
    width: int = 16                # N — total continuation budget per step
    keep: int = 0                  # beam/dvts: trajectories kept (0=sqrt(N))
    max_steps: int = 16
    batched: bool = True           # one backend call per step stage
    mcts_c: float = 1.4            # mcts: UCT exploration constant
    mcts_gap: float = 0.35         # mcts: parallel-expansion UCT window
    ets: ETSConfig = field(default_factory=ETSConfig)

    def __post_init__(self):
        if self.method == "ets-kv":
            self.ets = dataclasses.replace(self.ets, lambda_d=0.0,
                                           use_clustering=False)

    def n_keep_for(self, width: int) -> int:
        """Trajectories kept at the given *effective* width.  The
        ``keep=0`` default derives sqrt from the width actually in
        force — the budget controller adapts widths per problem
        mid-search, and beam/dvts must stay well-defined under the
        adapted width, not the static config."""
        return self.keep if self.keep else max(int(math.sqrt(width)), 1)

    @property
    def n_keep(self) -> int:
        return self.n_keep_for(self.width)


@dataclass
class SearchResult:
    answer: Any
    completed: List[Tuple[Any, float]]      # (answer, final reward)
    tree: SearchTree
    kv_summary: Dict[str, float]
    steps: int


def _majority_tie_key(ans: Any) -> Tuple[str, str]:
    """Total order over answer values for tie-breaking."""
    return (type(ans).__name__, repr(ans))


def weighted_majority(pairs: Sequence[Tuple[Any, float]]) -> Any:
    """Answer with the largest summed reward weight.

    Order-independent end to end: per-answer weights are reduced with
    ``math.fsum`` (exactly rounded, so the total is a function of the
    weight *multiset*, not the accumulation order), and among the
    answers with the maximal total the smallest by ``(type name,
    repr)`` sort key wins — never the accumulator's insertion order.
    Permuting ``pairs`` therefore cannot change the result.  The
    tie-break is additionally deterministic across runs for value-typed
    answers (str/int/tuple — everything the tasks here produce);
    objects whose ``repr`` embeds their identity sort by that identity.
    """
    if not pairs:
        return None
    groups: Dict[Any, List[float]] = defaultdict(list)
    for ans, w in pairs:
        groups[ans].append(max(w, 0.0))
    acc = {ans: math.fsum(ws) for ans, ws in groups.items()}
    top = max(acc.values())
    return min((a for a, w in acc.items() if w == top),
               key=_majority_tie_key)


# ---------------------------------------------------------------------------
# Batched dispatch: use the backend's *_many when present, else loop the
# single-node methods (same order, so deterministic backends agree).
# ---------------------------------------------------------------------------

def _expand_many(backend, tree: SearchTree,
                 leaf_counts: Sequence[Tuple[int, int]]) -> List[int]:
    fn = getattr(backend, "expand_many", None)
    if fn is not None:
        return fn(tree, leaf_counts)
    return _serial_expand(backend, tree, leaf_counts)


def _score_many(backend, tree: SearchTree,
                nodes: Sequence[int]) -> List[float]:
    fn = getattr(backend, "score_many", None)
    if fn is not None:
        return list(fn(tree, nodes))
    return _serial_score(backend, tree, nodes)


def _embed_many(backend, tree: SearchTree,
                nodes: Sequence[int]) -> np.ndarray:
    fn = getattr(backend, "embed_many", None)
    if fn is not None:
        return np.asarray(fn(tree, nodes))
    return _serial_embed(backend, tree, nodes)


# ---------------------------------------------------------------------------
# Cross-problem dispatch: one call covering many problems' stages when
# the backend supports it (the LM backend batches the union into one
# decode / PRM / embedder stream), else a per-problem loop of the
# single-problem protocol — per-problem call order is identical, so
# deterministic backends are bit-identical either way.
# ---------------------------------------------------------------------------

def _expand_multi(backend, reqs: Sequence[Tuple[SearchTree,
                                                Sequence[Tuple[int, int]]]]
                  ) -> List[List[int]]:
    fn = getattr(backend, "expand_multi", None)
    if fn is not None:
        return [list(kids) for kids in fn(reqs)]
    return [_expand_many(backend, tree, lc) for tree, lc in reqs]


def _score_multi(backend, reqs: Sequence[Tuple[SearchTree, Sequence[int]]]
                 ) -> List[List[float]]:
    fn = getattr(backend, "score_multi", None)
    if fn is not None:
        return [list(s) for s in fn(reqs)]
    return [_score_many(backend, tree, nodes) for tree, nodes in reqs]


def _embed_multi(backend, reqs: Sequence[Tuple[SearchTree, Sequence[int]]]
                 ) -> List[np.ndarray]:
    fn = getattr(backend, "embed_multi", None)
    if fn is not None:
        return [np.asarray(e) for e in fn(reqs)]
    return [_embed_many(backend, tree, nodes) for tree, nodes in reqs]


def _tree_ns(tree: SearchTree):
    """Problem namespace of a tree (None for backends without one)."""
    pl = tree.node(0).payload
    return pl.get("ns") if isinstance(pl, dict) else None


def _release_problem(backend, tree: SearchTree,
                     stats: Optional["SweepStats"] = None) -> None:
    """Retire one problem's backend state through ``finish_problem``.

    The single place the hook is looked up (``run_search``'s retirement,
    the sweep scheduler's ``_retire``, and the admission rollback all
    route here).  A backend that holds pool pages (``capacity()`` not
    None) but exposes no — or a misspelled — ``finish_problem`` silently
    leaks its namespace pages until the pool runs dry, so the miss is
    counted on the sweep stats (``finish_hook_missing``) and warned
    about; backends without page accounting (synthetic oracles, engine
    doubles) legitimately have nothing to release and stay silent.
    After the hook runs, the problem's per-ns page accounting must read
    zero — asserted whenever the backend can report it.
    """
    fin = getattr(backend, "finish_problem", None)
    cap_fn = getattr(backend, "capacity", None)
    holds_pages = cap_fn is not None and cap_fn() is not None
    if fin is None:
        if stats is not None:
            stats.finish_hook_missing += 1
        if holds_pages:
            warnings.warn(
                "backend holds pool pages but defines no finish_problem "
                "hook; its namespace pages leak until the pool drains",
                RuntimeWarning, stacklevel=3)
        return
    fin(tree)
    if holds_pages and hasattr(backend, "problem_pages") \
            and hasattr(backend, "problem_swapped_pages"):
        held = backend.problem_pages(tree)
        swapped = backend.problem_swapped_pages(tree)
        assert held == 0 and swapped == 0, (
            "finish_problem left pages behind", held, swapped)


# ---------------------------------------------------------------------------
# The step machine
# ---------------------------------------------------------------------------

class SearchState:
    """One problem's search as a resumable step machine.

    The historical ``run_search`` loop, split at the backend-call
    boundaries so an external driver decides *when* (and batched with
    *whom*) each expensive stage runs:

        st = SearchState(backend, scfg, tree)
        while (lc := st.demand()) is not None:
            kids = backend.expand_many(st.tree, lc)
            to_score = st.note_children(kids)
            if st.finished: break
            to_embed = st.note_scores(backend.score_many(st.tree, to_score))
            if st.finished: break
            st.complete_step(backend.embed_many(st.tree, to_embed)
                             if to_embed else None)
        result = st.result()

    Driven to completion solo (``run_search``) the visible behavior —
    backend call order, tree contents, RNG consumption, recorded
    traces — is bit-identical to the closed loop this replaced; the
    ``SweepScheduler`` interleaves many states' phases without touching
    any per-problem logic.

    Phases cycle ``demand -> children -> scores [-> embeds] -> demand``;
    ``finished`` flips once the search is over and ``result()`` builds
    the ``SearchResult`` (merging the backend's per-problem
    ``io_summary`` when it has one).
    """

    def __init__(self, backend: Backend, scfg: SearchConfig,
                 tree: Optional[SearchTree] = None):
        self.backend = backend
        self.scfg = scfg
        self.tree = tree if tree is not None else SearchTree()
        # effective width: starts at the configured width; the budget
        # controller may re-target it mid-search (set_width)
        self.width = scfg.width
        self.N = self.width
        self.completed: List[Tuple[Any, float]] = []
        self.steps = 0
        # leaf id -> continuation count (step 0 expands the root)
        self.live: Dict[int, int] = {0: self.N}
        # subtree id for DVTS (assigned at the first expansion)
        self.subtree_of: Dict[int, int] = {}
        # node id -> visit count (mcts backprop; root included)
        self.visits: Dict[int, int] = {}
        self.finished = False
        self.phase = "demand"
        self._leaf_counts: List[Tuple[int, int]] = []
        self._candidates: List[int] = []
        self._open: List[int] = []
        self._rewards: List[float] = []

    @property
    def n_keep(self) -> int:
        """Beam/dvts keep count at this problem's *current* effective
        width (``keep=0`` derives sqrt(width) from the adapted width,
        not the static config)."""
        return self.scfg.n_keep_for(self.width)

    def set_width(self, width: int) -> None:
        """Adapt this problem's effective width (the budget
        controller's entry point).  Valid only at the demand boundary,
        where no stage output is in flight.

        The remaining budget becomes ``width - len(completed)`` and the
        pending continuation counts are rescaled to it with
        largest-remainder rounding (ties toward the lower leaf id), so
        the next step's demand matches the adapted width while the
        relative allocation the retention policy chose is preserved.
        A no-op when the width is unchanged — with adaptation disabled
        the state is bit-identical to one that never saw this method.
        """
        assert self.phase == "demand", self.phase
        width = max(int(width), 1)
        if width == self.width:
            return
        self.width = width
        self.N = max(width - len(self.completed), 0)
        total = sum(self.live.values())
        if self.N <= 0 or total <= 0:
            return
        quota = {leaf: n * self.N / total for leaf, n in self.live.items()}
        alloc = {leaf: int(q) for leaf, q in quota.items()}
        order = sorted(quota, key=lambda lf: (alloc[lf] - quota[lf], lf))
        short = self.N - sum(alloc.values())
        for i in range(short):
            alloc[order[i % len(order)]] += 1
        self.live = {leaf: n for leaf, n in alloc.items() if n > 0}

    @property
    def exhausted(self) -> bool:
        """True when the next ``demand()`` will end the search (no step
        budget, no width, or no live leaves left).  Lets a scheduler
        retire the problem instead of, say, paying swap traffic for
        pages that retirement frees outright."""
        return self.finished or not (self.steps < self.scfg.max_steps
                                     and self.N > 0 and self.live)

    # -- phases --------------------------------------------------------
    def demand(self) -> Optional[List[Tuple[int, int]]]:
        """Continuation demand for the next step, or None when done."""
        if self.finished:
            return None
        assert self.phase == "demand", self.phase
        if self.exhausted:
            self._finish()
            return None
        self.steps += 1
        self._leaf_counts = [(leaf, n) for leaf, n in self.live.items()
                             if n > 0]
        self.phase = "children"
        return self._leaf_counts

    def note_children(self, candidates: Sequence[int]) -> List[int]:
        """Record the expansion's children; returns the nodes to score.

        An empty expansion ends the search (no step is recorded — the
        legacy loop's ``break``).
        """
        assert self.phase == "children", self.phase
        candidates = list(candidates)
        if not candidates:
            self._finish()
            return []
        tree, scfg = self.tree, self.scfg
        # decode-boundary trace: this step's branch set, 1:1 with the
        # engine's per-decode KV trace (the fig2 count-level validation)
        tree.record_decode(candidates)
        # subtree bookkeeping (children arrive grouped by parent leaf)
        kids_of: Dict[int, List[int]] = defaultdict(list)
        for kid in candidates:
            kids_of[tree.node(kid).parent].append(kid)
        for leaf, _ in self._leaf_counts:
            kids = kids_of.get(leaf, [])
            if leaf == 0 and scfg.method == "dvts":
                k = self.n_keep
                for j, kid in enumerate(kids):
                    self.subtree_of[kid] = j % k
            else:
                for kid in kids:
                    self.subtree_of[kid] = self.subtree_of.get(leaf, 0)
        self._candidates = candidates
        self.phase = "scores"
        return candidates

    def note_scores(self, scores: Sequence[float]) -> List[int]:
        """Record PRM rewards; returns the nodes to embed (possibly
        empty — then call ``complete_step(None)`` unless ``finished``)."""
        assert self.phase == "scores", self.phase
        tree, scfg = self.tree, self.scfg
        candidates = self._candidates
        for nid, r in zip(candidates, scores):
            tree.node(nid).reward = float(r)
        # split off finished trajectories (width shrinks, as in REBASE)
        finished = [c for c in candidates if tree.node(c).finished]
        for f in finished:
            self.completed.append((self.backend.answer(tree, f),
                                   tree.node(f).reward))
        self.N = max(self.width - len(self.completed), 0)
        open_c = [c for c in candidates if not tree.node(c).finished]
        if not open_c or self.N == 0:
            tree.record_step(list(candidates))
            hook = getattr(self.backend, "on_step", None)
            if hook:
                hook(tree, [])
            self._finish()
            return []
        self._open = open_c
        self._rewards = [tree.node(c).reward for c in open_c]
        need_embs = (scfg.method in ("ets", "ets-kv")
                     and scfg.ets.use_clustering and scfg.ets.lambda_d > 0)
        self.phase = "embeds"
        return list(open_c) if need_embs else []

    def complete_step(self, embs: Optional[np.ndarray] = None) -> None:
        """Apply the retention policy and close the step."""
        assert self.phase == "embeds", self.phase
        tree, scfg = self.tree, self.scfg
        open_c, rewards = self._open, self._rewards
        method, N = scfg.method, self.N
        if method == "rebase":
            counts = rebase_weights(rewards, N, scfg.ets.rebase_temperature)
            live = {c: int(w) for c, w in zip(open_c, counts)}
        elif method == "beam":
            k = min(self.n_keep, len(open_c))
            order = np.argsort(rewards)[::-1][:k]
            per = max(N // k, 1)
            live = {open_c[int(i)]: per for i in order}
        elif method == "dvts":
            best_per_tree: Dict[int, int] = {}
            for ci, c in enumerate(open_c):
                st = self.subtree_of.get(c, 0)
                cur = best_per_tree.get(st)
                if cur is None or rewards[ci] > tree.node(cur).reward:
                    best_per_tree[st] = c
            keepers = list(best_per_tree.values())
            per = max(N // max(len(keepers), 1), 1)
            live = {c: per for c in keepers}
        elif method in ("ets", "ets-kv"):
            step = ets_prune(tree, open_c, rewards, N, scfg.ets, embs)
            live = {open_c[i]: int(n)
                    for i, n in zip(step.selected, step.counts)}
        elif method == "mcts":
            # Adaptive Parallel MCTS: back-propagate a visit along each
            # open candidate's root path, then let the UCT profile
            # decide how many arms stay parallel-expanded this step
            for c in open_c:
                nid = c
                while nid >= 0:          # root's parent is -1
                    self.visits[nid] = self.visits.get(nid, 0) + 1
                    nid = tree.node(nid).parent
            sel, counts = mcts_step(
                rewards, [self.visits[c] for c in open_c],
                self.visits.get(0, 1), N, c_uct=scfg.mcts_c,
                gap=scfg.mcts_gap,
                temperature=scfg.ets.rebase_temperature)
            live = {open_c[i]: int(n) for i, n in zip(sel, counts)}
        else:
            raise ValueError(method)
        self.live = {c: n for c, n in live.items() if n > 0}
        tree.record_step(list(self.live.keys()))
        hook = getattr(self.backend, "on_step", None)
        if hook:
            hook(tree, list(self.live.keys()))
        self.phase = "demand"

    # -- terminal ------------------------------------------------------
    def halt(self) -> None:
        """End the search NOW (First-Finish early exit).

        Whatever ``completed`` already holds becomes the answer set;
        any stage output still pending for the current step is
        discarded (no final ``record_step``/``on_step`` for it — the
        retiring caller's ``finish_problem`` frees every page of the
        namespace outright, which is the whole point: pages return to
        the pool the moment the first trajectory completes).  The tree
        is stamped with a truncation marker so trace consumers (the
        fig2 count-level IO validation) can pair the non-truncated
        prefix of ``decode_trace`` with the engine KV trace instead of
        skipping halted problems.  Valid in any phase; idempotent once
        finished.
        """
        if not self.finished:
            self.tree.mark_truncated()
            self._finish()

    def _finish(self) -> None:
        self.finished = True
        self.phase = "done"

    def result(self) -> SearchResult:
        """Build the SearchResult (valid once ``finished``)."""
        assert self.finished, "search still in flight"
        ans = weighted_majority(self.completed)
        kv_summary = self.tree.kv_summary()
        # measured attention-IO (engine backends): pages streamed per
        # decode step and the realized sharing ratio, next to the
        # tree-level counts.  Backends with problem namespaces report
        # *this problem's* trace, not the engine-cumulative one.
        io_fn = getattr(self.backend, "io_summary", None)
        if io_fn is not None:
            ns = _tree_ns(self.tree)
            try:        # third-party io_summary may not take ns
                accepts_ns = "ns" in inspect.signature(io_fn).parameters
            except (TypeError, ValueError):
                accepts_ns = False
            extra = io_fn(ns=ns) if ns is not None and accepts_ns \
                else io_fn()
            kv_summary = {**kv_summary, **extra}
        return SearchResult(answer=ans, completed=self.completed,
                            tree=self.tree, kv_summary=kv_summary,
                            steps=self.steps)


# ---------------------------------------------------------------------------
# The unified loop (one problem, driven to completion)
# ---------------------------------------------------------------------------

def run_search(backend: Backend, scfg: SearchConfig,
               tree: Optional[SearchTree] = None) -> SearchResult:
    st = SearchState(backend, scfg, tree=tree)
    batched = scfg.batched
    while True:
        leaf_counts = st.demand()
        if leaf_counts is None:
            break
        if batched:
            kids = _expand_many(backend, st.tree, leaf_counts)
        else:
            kids = _serial_expand(backend, st.tree, leaf_counts)
        to_score = st.note_children(kids)
        if st.finished:
            break
        if batched:
            scores = _score_many(backend, st.tree, to_score)
        else:
            scores = _serial_score(backend, st.tree, to_score)
        to_embed = st.note_scores(scores)
        if st.finished:
            break
        embs = None
        if to_embed:
            if batched:
                embs = _embed_many(backend, st.tree, to_embed)
            else:
                embs = _serial_embed(backend, st.tree, to_embed)
        st.complete_step(embs)
    result = st.result()
    # solo runs retire their own problem: the final step's engine
    # sequences are released (namespaced backends no longer sweep other
    # problems' leftovers in on_step, so sequential solo use without
    # reset() must not accumulate them)
    _release_problem(backend, st.tree)
    return result


# ---------------------------------------------------------------------------
# The sweep scheduler (many problems, continuous cross-problem batching)
# ---------------------------------------------------------------------------

@dataclass
class SweepStats:
    """Scheduler-level accounting for occupancy/throughput reporting."""
    global_steps: int = 0
    admission_waves: int = 0
    deferred_admissions: int = 0
    # memory-pressure accounting (engine backends with swap support):
    # problems demoted to the host spill buffer / resumed from it, and
    # the largest page sum ever reserved by concurrently-admitted
    # problems (the admission-control invariant: never exceeds the pool)
    demotions: int = 0
    resumes: int = 0
    max_reserved_pages: int = 0
    # per global step: live problems and total branch demand they posted.
    # ``problems_per_step`` has one entry per global step;
    # ``demand_per_step`` only for steps that actually issued a decode
    # stream (a drain step whose live problems all retire or post empty
    # demand moves no tokens, so counting it would understate the batch
    # fill the decode kernel really saw).
    problems_per_step: List[int] = field(default_factory=list)
    demand_per_step: List[int] = field(default_factory=list)
    # retirements routed through a backend lacking ``finish_problem``
    # (fine for synthetic backends; a red flag for engine backends)
    finish_hook_missing: int = 0

    def mean_occupancy(self) -> float:
        """Mean branch demand per decode-issuing global step (the
        decode batch fill)."""
        if not self.demand_per_step:
            return 0.0
        return sum(self.demand_per_step) / len(self.demand_per_step)


class WorkingSetEstimator:
    """Online per-problem KV working-set estimate, in pages.

    A problem's reservation at admission is ``prompt pages + expected
    search growth``.  A priori the growth bound is ``width x worst-case
    step pages`` (every branch of a full-width step allocating its
    maximum); that is safe but pessimistic — ETS's whole point is that
    pruning keeps the retained set far smaller.  Every retired problem
    feeds its *realized* peak growth back here, and subsequent
    admissions reserve the observed mean plus a safety margin instead,
    clamped to ``[one step's pages, the a-priori bound]``.  Admission
    can therefore tighten over a sweep while demotion (the scheduler's
    pressure valve) guards the tail where a problem outgrows its
    refined estimate.
    """

    def __init__(self, margin: float = 1.25):
        self.margin = margin
        self._growths: List[int] = []

    def note(self, growth_pages: int) -> None:
        """Record one retired problem's realized peak growth (pages
        beyond its prompt)."""
        self._growths.append(max(int(growth_pages), 0))

    def growth(self, width: int, step_pages: int) -> int:
        """Expected search growth (pages beyond the prompt) for a new
        problem of the given width."""
        cap = max(width, 1) * step_pages
        if not self._growths:
            return cap
        obs = math.ceil(sum(self._growths) / len(self._growths)
                        * self.margin)
        return max(step_pages, min(cap, obs))


@dataclass
class AdaptiveConfig:
    """Difficulty-adaptive compute allocation (ROADMAP item 3).

    The mean PRM score of a problem's first ``signal_steps`` scored
    steps is its online difficulty signal — cheap (the sweep computes
    those scores anyway) and available before most of the budget is
    spent.  The budget controller then re-targets the problem's
    effective width once: easy problems (signal ``>= easy_threshold``)
    shrink to ``width * shrink_factor``, hard ones (``<=
    hard_threshold``) grow to ``width * grow_factor``, both clamped to
    ``[min_width, max_width]``; problems in the middle band keep the
    configured width.  A global generated-token budget caps the sweep:
    once ``token_budget`` tokens have been generated across all
    problems, every subsequently adapted problem winds down to
    ``min_width`` instead of its target.

    ``enabled=False`` is the uniform-width oracle: every controller
    hook is a no-op and the sweep is bit-identical to one constructed
    without an ``adaptive`` config at all (property-tested).
    """
    enabled: bool = True
    signal_steps: int = 2          # scored steps before deciding
    min_width: int = 2
    max_width: int = 0             # 0 -> 2x the configured width
    easy_threshold: float = 0.60   # mean early PRM score above: shrink
    hard_threshold: float = 0.45   # mean early PRM score below: grow
    shrink_factor: float = 0.5
    grow_factor: float = 2.0
    token_budget: int = 0          # global generated-token cap (0 = off)
    # confidence wind-down: once a problem holds a completed trajectory
    # whose final PRM reward reaches this, it is treated as solved and
    # its width drops to min_width — final-answer rewards separate far
    # better than mid-search ones, so this is the strongest (and
    # cheapest) difficulty signal of all.  <= 0 disables.
    confident_reward: float = 0.7


class BudgetController:
    """Per-problem difficulty-adaptive width under a global token budget.

    The scheduler calls ``observe`` after every scored step (feeding the
    difficulty signal and the token spend) and ``target_width`` at every
    demand boundary; a changed target is applied with
    ``SearchState.set_width`` and the problem's admission reservation is
    re-booked against the adapted width (``SweepScheduler._rebook``), so
    the same signal that sizes the search also sizes its
    :class:`WorkingSetEstimator`-based page reservation.  All decisions
    are deterministic functions of the scores the sweep computed anyway.
    """

    def __init__(self, acfg: AdaptiveConfig, scfg: SearchConfig):
        self.acfg = acfg
        self.scfg = scfg
        self._signal: Dict[int, List[float]] = {}   # idx -> early scores
        self.width_of: Dict[int, int] = {}          # idx -> decided target
        self._tokens: Dict[int, int] = {}           # idx -> generated toks

    @property
    def max_width(self) -> int:
        return self.acfg.max_width or 2 * self.scfg.width

    @property
    def spent_tokens(self) -> int:
        """Generated tokens across every observed problem so far."""
        return sum(self._tokens.values())

    def observe(self, idx: int, st: SearchState,
                scores: Sequence[float]) -> None:
        """Fold one scored step into the difficulty signal and the
        token ledger.  Token spend is measured by the backend when it
        can (``problem_gen_tokens``), else derived from the tree."""
        if not self.acfg.enabled:
            return
        sig = self._signal.setdefault(idx, [])
        if len(sig) < self.acfg.signal_steps and len(scores):
            sig.append(float(np.mean(scores)))
        fn = getattr(st.backend, "problem_gen_tokens", None)
        if fn is not None:
            self._tokens[idx] = int(fn(st.tree))
        else:
            root = st.tree.node(0).n_tokens
            self._tokens[idx] = sum(n.n_tokens
                                    for n in st.tree.nodes) - root

    def difficulty(self, idx: int) -> Optional[float]:
        """Mean early PRM score (LOW means hard), or None until
        ``signal_steps`` scored steps are in."""
        sig = self._signal.get(idx, ())
        if len(sig) < self.acfg.signal_steps:
            return None
        return float(np.mean(sig))

    def target_width(self, idx: int, st: SearchState) -> int:
        """The width this problem should run at right now."""
        if not self.acfg.enabled:
            return st.width
        a = self.acfg
        # confidence wind-down: a completed trajectory whose final
        # reward clears the bar means the problem is (almost surely)
        # solved — the remaining width would only buy redundant votes
        if a.confident_reward > 0 and any(
                r >= a.confident_reward for _, r in st.completed):
            return a.min_width
        w = self.width_of.get(idx)
        if w is None:
            d = self.difficulty(idx)
            if d is None:
                return st.width        # still gathering the signal
            base = self.scfg.width
            if d >= a.easy_threshold:
                w = max(a.min_width, int(round(base * a.shrink_factor)))
            elif d <= a.hard_threshold:
                w = min(self.max_width, int(round(base * a.grow_factor)))
            else:
                w = base
            self.width_of[idx] = w
        if a.token_budget and self.spent_tokens >= a.token_budget:
            w = min(w, a.min_width)    # budget spent: wind down
        return w

    def admission_width(self) -> int:
        """Expected width of a not-yet-signalled problem — what
        admission control should reserve growth for: the mean decided
        target so far, else the configured width."""
        if not (self.acfg.enabled and self.width_of):
            return self.scfg.width
        ws = self.width_of.values()
        return max(int(round(sum(ws) / len(ws))), 1)


class SweepScheduler:
    """Drive many searches in lock-step on one shared backend.

    Each global step:

      0. (engine backends) resumes demoted problems whose pages fit
         again, and demotes fresh victims when the live set's next step
         would overflow the KV pool (memory pressure, below);
      1. admits queued problems (one batched ``start_many`` flash-prefill
         stream per wave) while the live set has room — and, for engine
         backends, re-queues the wave when the KV pool is full, retrying
         as finished problems release pages;
      2. gathers every live problem's ``demand()`` into ONE
         ``expand_multi`` call (one lock-step decode stream over the
         union of branches);
      3. feeds the children back and issues ONE ``score_multi`` PRM call
         over every problem's candidates;
      4. embeds (ONE ``embed_multi`` call) only the problems whose
         retention policy needs it, then completes each step;
      5. retires problems the moment they finish — ``result()`` is
         captured and the backend's ``finish_problem`` releases their
         engine sequences — without stalling the remaining problems.

    Memory pressure (backends implementing the page-accounting/swap
    protocol — see ``serving/search_backend.py``): admission reserves a
    per-problem working set (prompt pages + expected search growth,
    refined online by :class:`WorkingSetEstimator` from retired
    problems' realized page traces) and only admits waves whose
    reservations fit the unreserved pool.  When the live set's next
    step would still overflow (a problem outgrew its estimate), the
    scheduler *demotes* a victim — lowest best-leaf PRM score, ties
    toward most pages held — swapping its pages out to the engine's
    host spill buffer and parking its state; parked problems swap back
    in bit-identically once retirements free room.  Demotion only
    delays *when* a problem steps, which per-problem RNG chains make
    invisible, so a pressured sweep still reproduces unpressured serial
    runs exactly.

    Per-problem behavior is bit-identical to driving each state solo:
    the scheduler only interleaves *when* stages run, never what any
    problem sees (per-problem RNG namespaces and composition-independent
    batching are the backend's side of that contract).
    """

    def __init__(self, backend, scfg: SearchConfig, *,
                 prompts: Optional[Sequence[Sequence[int]]] = None,
                 trees: Optional[Sequence[SearchTree]] = None,
                 max_live: Optional[int] = None,
                 spill: str = "namespace",
                 adaptive: Optional[AdaptiveConfig] = None):
        assert (prompts is None) != (trees is None), \
            "pass exactly one of prompts / trees"
        assert spill in ("namespace", "subtree"), spill
        self.backend = backend
        self.scfg = scfg
        # demotion granularity: "namespace" spills a victim's whole KV
        # (the historical behavior — pressured sweeps stay bit-identical
        # to unpressured ones); "subtree" spills only enough of the
        # victim's page-exclusive sequences to cover the deficit, so a
        # demotion no longer evicts the shared prefix or the rest of
        # the problem (requires a backend whose swap_out_problem takes
        # need_pages)
        self.spill = spill
        self._queue: List[Tuple[int, Any]] = []     # (index, prompt|tree)
        self._from_prompts = prompts is not None
        items = prompts if self._from_prompts else trees
        self._n = len(items)
        for i, item in enumerate(items):
            self._queue.append((i, item))
        self.max_live = max_live if max_live is not None \
            else max(self._n, 1)
        assert self.max_live >= 1, max_live
        self.live: Dict[int, SearchState] = {}
        # demoted problems: swapped out of the pool, posting no demand
        # until pressure relents and they swap back in
        self.parked: Dict[int, SearchState] = {}
        self.results: Dict[int, SearchResult] = {}
        self.stats = SweepStats()
        # memory-pressure management is on when the backend implements
        # the page-accounting/swap protocol (LMBackend with a real
        # engine); capacity() returning None (engine doubles) or a
        # trees-based sweep (no prompts to estimate) turns it off.
        self._mem = False
        if self._from_prompts:
            cap_fn = getattr(backend, "capacity", None)
            self._mem = (cap_fn is not None and cap_fn() is not None
                         and all(hasattr(backend, m) for m in (
                             "prompt_pages", "step_pages_per_branch",
                             "problem_pages", "problem_swapped_pages",
                             "swap_out_problem", "swap_in_problem")))
        self.estimator = WorkingSetEstimator()
        # difficulty-adaptive width: hooks run whenever an AdaptiveConfig
        # is passed (a disabled config exercises the same code paths as
        # a strict no-op — the bit-identity oracle); None skips them
        self.controller = BudgetController(adaptive, scfg) \
            if adaptive is not None else None
        # admission reservations live in the allocator-side ledger (the
        # single place the "reserved sum never exceeds the pool"
        # invariant is enforced); None when pressure management is off
        self._reserved = None
        if self._mem:
            from repro_torch.kvcache.allocator import ReservationLedger
            self._reserved = ReservationLedger(
                backend.capacity()["total_pages"])
        self._prompt_pages: Dict[int, int] = {}
        self._peak: Dict[int, int] = {}          # idx -> peak phys pages

    # -- admission -----------------------------------------------------
    def _start_trees(self, prompts: Sequence[Sequence[int]]
                     ) -> List[SearchTree]:
        starter = getattr(self.backend, "start_many", None)
        if starter is not None:
            # engine start_many is all-or-nothing (one new_seqs pass),
            # so a failed wave leaves no pages behind
            return list(starter(prompts))
        # per-prompt fallback is not atomic: roll back already-started
        # problems before re-raising so _admit's retry can't leak or
        # double-start them
        trees: List[SearchTree] = []
        try:
            for p in prompts:
                trees.append(self.backend.start(p))
        except BaseException:
            for t in trees:
                _release_problem(self.backend, t)
            raise
        return trees

    # -- memory pressure ----------------------------------------------
    def _held_pages(self, st: SearchState) -> int:
        """Pages a problem currently occupies (live + spilled)."""
        return (self.backend.problem_pages(st.tree)
                + self.backend.problem_swapped_pages(st.tree))

    def _committed_pages(self) -> int:
        """Pages the admitted problems are entitled to: each counts at
        its admission reservation, or its current holding when it has
        outgrown the (online-refined) estimate."""
        total = 0
        for idx, st in list(self.live.items()) + list(self.parked.items()):
            total += max(self._reserved.get(idx, 0), self._held_pages(st))
        return total

    def _step_need(self, st: SearchState) -> int:
        """Worst-case pages one problem's next step allocates."""
        per_branch = self.backend.step_pages_per_branch()
        return sum(n for n in st.live.values() if n > 0) * per_branch

    def _best_reward(self, st: SearchState) -> float:
        """Demotion priority: the problem's best live-leaf PRM score."""
        rewards = [st.tree.node(leaf).reward for leaf in st.live]
        return max(rewards) if rewards else 0.0

    def _slack(self, idx: int) -> float:
        """Deadline slack of a live problem, for victim selection.

        The base sweep has no deadlines, so every problem reports
        infinite slack and victim selection falls through to the
        historical lowest-score/most-pages policy.  ``ServingLoop``
        overrides this with ``deadline - now - estimated remaining
        work`` so pressure demotes the request that can best afford
        the stall.
        """
        return math.inf

    def _demotable(self, idx: int) -> bool:
        """Whether a live problem may be parked right now.

        The base sweep can demote anything; ``ServingLoop`` overrides
        this to pin problems with rows seated in an open decode stream
        (swapping their pages out mid-decode would corrupt the KV the
        in-flight rows are attending over).
        """
        return True

    def _update_peaks(self) -> None:
        for idx, st in self.live.items():
            held = self.backend.problem_pages(st.tree)
            if held > self._peak.get(idx, 0):
                self._peak[idx] = held

    def _park(self, idx: int, need_pages: Optional[int] = None) -> None:
        """Demote one problem: spill its pages and stop stepping it.

        Parking is invisible to the search itself — the problem simply
        posts no demand for a few global steps, and per-problem RNG
        chains make step timing irrelevant to its sampled streams — so
        the sweep stays bit-identical to unpressured serial runs.  In
        ``spill="subtree"`` mode only ``need_pages`` worth of the
        victim's page-exclusive sequences spill (the shared prefix
        stays hot); the problem still parks whole either way.
        """
        st = self.live.pop(idx)
        if self.spill == "subtree" and need_pages is not None:
            self.backend.swap_out_problem(st.tree, need_pages=need_pages)
        else:
            self.backend.swap_out_problem(st.tree)
        self.parked[idx] = st
        self.stats.demotions += 1

    def _handle_pressure(self) -> None:
        """Demote victims until the live set's next step fits the pool.

        Victim policy (``repro.kvcache.allocator.select_victim``):
        largest deadline slack first — the request that can best
        afford a stall; the base sweep reports infinite slack for
        everything, which degrades to the historical policy of lowest
        best-leaf PRM score (the trajectory the cost model values
        least), breaking ties toward the problem holding the most
        pages (frees the most room per demotion).  At least one
        problem always stays live, so the sweep makes progress and
        parked problems eventually resume.  Problems the subclass pins
        (``_demotable`` False — e.g. rows seated in an open decode
        stream) are never victims and retire-in-place only when
        exhausted AND unpinned.
        """
        from repro_torch.kvcache.allocator import VictimCandidate, select_victim
        while len(self.live) > 1:
            free = self.backend.capacity()["free_pages"]
            need = sum(self._step_need(st) for st in self.live.values())
            if need <= free:
                return
            # retire exhausted problems before picking a swap victim:
            # their pages free outright, no spill traffic needed (the
            # demand phase would retire them this same global step)
            done = [i for i in self.live
                    if self.live[i].exhausted and self._demotable(i)]
            if done:
                for i in done:
                    lc = self.live[i].demand()   # flips the state to
                    assert lc is None            # finished; never a step
                    self._retire(i)
                continue
            cands = [VictimCandidate(key=i, slack=self._slack(i),
                                     score=self._best_reward(self.live[i]),
                                     pages=self._held_pages(self.live[i]))
                     for i in self.live if self._demotable(i)]
            if not cands:
                return              # every live problem is pinned
            self._park(select_victim(cands).key,
                       need_pages=need - free)

    def _resume_parked(self) -> None:
        """Swap parked problems back in as pages free up.

        A problem resumes only when its spilled pages plus one step's
        growth fit the free pool *on top of* the live set's own step
        need — the same feasibility metric admission and the pressure
        check use, so a freshly resumed problem is never immediately
        re-parked (no swap thrash).  When nothing is live the first
        parked problem is forced back in regardless (its spill can
        always be re-seated in an otherwise-empty pool), so the sweep
        can never wedge with every problem parked.
        """
        for idx in sorted(self.parked):
            st = self.parked[idx]
            free = self.backend.capacity()["free_pages"]
            live_need = sum(self._step_need(s)
                            for s in self.live.values())
            need = (self.backend.problem_swapped_pages(st.tree)
                    + self._step_need(st) + live_need)
            if need > free and self.live:
                continue
            try:
                self.backend.swap_in_problem(st.tree)
            except RuntimeError as e:
                if type(e).__name__ != "OutOfPages":
                    raise
                if not self.live:
                    raise       # nothing in flight can free pages
                continue
            del self.parked[idx]
            self.live[idx] = st
            self.stats.resumes += 1

    # -- admission -----------------------------------------------------
    def _reserve_wave(self, wave: List[Tuple[int, Any]]
                      ) -> List[Tuple[int, int, int]]:
        """Working-set admission control: trim ``wave`` to the longest
        prefix whose reservations fit the unreserved pool.

        Each problem reserves ``prompt pages + expected search growth``
        (the estimator refines the growth term online from retired
        problems' realized page traces).  A candidate must ALSO fit the
        immediate-step budget — its prompt plus a worst-case first step
        (``width x step pages``) on top of the live set's own step
        need — the same metric the pressure check enforces, so a wave
        is never admitted just to be demoted in the same global step.
        Returns ``(idx, prompt_pages, reservation)`` per admitted
        problem; an empty list defers the wave.  When nothing is live
        or parked the first problem is admitted even if its estimate
        exceeds the pool — a genuinely oversized problem then surfaces
        the allocator error exactly as a solo run would, instead of
        deadlocking the queue.
        """
        cap = self.backend.capacity()
        avail = cap["total_pages"] - self._committed_pages()
        step_pages = self.backend.step_pages_per_branch()
        # growth term: under adaptation, reserve for the width problems
        # actually end up running at (the controller's decided-target
        # mean), not the a-priori config width
        grow_width = self.scfg.width if self.controller is None \
            else self.controller.admission_width()
        # the first 1-2 steps run at the configured width (pre-signal),
        # so the immediate-step budget keeps the a-priori bound
        first_need = max(self.scfg.width, 1) * step_pages
        budget = cap["free_pages"] - sum(self._step_need(st)
                                         for st in self.live.values())
        out: List[Tuple[int, int, int]] = []
        for idx, item in wave:
            pp = self.backend.prompt_pages(item)
            est = min(pp + self.estimator.growth(grow_width, step_pages),
                      cap["total_pages"])
            if (est > avail or pp + first_need > budget) \
                    and (out or self.live or self.parked):
                break
            out.append((idx, pp, est))
            avail -= est
            budget -= pp + first_need
        return out

    def _admit(self) -> None:
        room = self.max_live - len(self.live) - len(self.parked)
        if room <= 0 or not self._queue:
            return
        wave = self._queue[:room]
        reservations: List[Tuple[int, int, int]] = []
        if self._mem:
            reservations = self._reserve_wave(wave)
            if not reservations:
                self.stats.deferred_admissions += 1
                return             # retry after the next retirement
            wave = wave[:len(reservations)]
        if self._from_prompts:
            # engine OutOfPages (pool full): halve the wave until a
            # prefix fits — start_many is all-or-nothing, so failed
            # attempts leave no pages behind — and defer entirely when
            # not even one problem fits (retrying after retirements).
            trees, err = None, None
            while wave:
                try:
                    trees = self._start_trees([item for _, item in wave])
                    break
                except RuntimeError as e:
                    # only capacity errors are schedulable; matched by
                    # name so core stays decoupled from repro.kvcache
                    if type(e).__name__ != "OutOfPages":
                        raise
                    err = e
                    if len(wave) == 1:
                        break
                    wave = wave[:len(wave) // 2]
            if trees is None:
                if not self.live and not self.parked:
                    raise err      # nothing in flight can free pages
                self.stats.deferred_admissions += 1
                return             # retry after the next retirement
        else:
            trees = [item for _, item in wave]
        del self._queue[:len(wave)]
        self.stats.admission_waves += 1
        for (idx, _), tree in zip(wave, trees):
            self.live[idx] = SearchState(self.backend, self.scfg, tree=tree)
        # book the admitted problems' reservations (the halving loop may
        # have admitted a shorter prefix than _reserve_wave cleared)
        for idx, pp, est in reservations[:len(wave)]:
            self._reserved.book(idx, est)
            self._prompt_pages[idx] = pp
            self._peak[idx] = pp
        if self._mem:
            self.stats.max_reserved_pages = max(
                self.stats.max_reserved_pages, self._reserved.total())

    # -- retirement ----------------------------------------------------
    def _retire(self, idx: int) -> None:
        st = self.live.pop(idx)
        self.results[idx] = st.result()
        if self._mem and idx in self._peak:
            # feed the realized page trace back into admission control
            self.estimator.note(self._peak[idx]
                                - self._prompt_pages.get(idx, 0))
        if self._reserved is not None:
            self._reserved.release(idx)
        self._prompt_pages.pop(idx, None)
        self._peak.pop(idx, None)
        _release_problem(self.backend, st.tree, self.stats)

    # -- difficulty-adaptive width -------------------------------------
    def _adapt(self, idx: int, st: SearchState) -> None:
        """Apply the budget controller's target width at the demand
        boundary and re-book the admission reservation against it.
        No-op without a controller, for finished problems, or outside
        the demand phase (mid-step widths never change)."""
        ctl = self.controller
        if ctl is None or st.finished or st.phase != "demand":
            return
        w = ctl.target_width(idx, st)
        if w != st.width:
            st.set_width(w)
            self._rebook(idx, st)

    def _rebook(self, idx: int, st: SearchState) -> None:
        """Re-tie one problem's admission reservation to its adapted
        width.  A shrink releases reserved headroom immediately — but
        never below the pages the problem already holds, so nothing is
        stranded; a grow raises the reservation only as far as the
        pool's unreserved headroom allows (the demotion path guards the
        remainder, exactly as when a problem outgrows its estimate)."""
        if not self._mem or idx not in self._reserved:
            return
        step_pages = self.backend.step_pages_per_branch()
        want = self._prompt_pages.get(idx, 0) \
            + self.estimator.growth(st.width, step_pages)
        cap = self.backend.capacity()["total_pages"]
        self._reserved.rebook(idx, min(want, cap),
                              floor=min(self._held_pages(st), cap))
        self.stats.max_reserved_pages = max(
            self.stats.max_reserved_pages, self._reserved.total())

    # -- one global step -----------------------------------------------
    def step(self) -> bool:
        """Advance every live problem by one search step.

        Returns True while there is work left (live, parked or
        queued)."""
        if self._mem:
            self._resume_parked()
        self._admit()
        if self._mem:
            self._update_peaks()
            self._handle_pressure()
        # 1. demand: retire problems that have nothing left to do
        reqs: List[Tuple[SearchTree, List[Tuple[int, int]]]] = []
        states: List[Tuple[int, SearchState]] = []
        for idx in sorted(self.live):
            st = self.live[idx]
            self._adapt(idx, st)
            lc = st.demand()
            if lc is None:
                self._retire(idx)
                continue
            reqs.append((st.tree, lc))
            states.append((idx, st))
        if not reqs:
            return bool(self.live or self.parked or self._queue)
        self.stats.global_steps += 1
        self.stats.problems_per_step.append(len(reqs))
        posted = sum(n for _, lc in reqs for _, n in lc)
        # 2. ONE expansion stream over every problem's branches
        kid_groups = _expand_multi(self.backend, reqs)
        # occupancy counts only steps that issued a decode stream: a
        # drain step whose demands were all pruned/at-depth expands
        # nothing, and averaging its zero in would understate the batch
        # fill the decode kernel actually saw
        if any(kid_groups):
            self.stats.demand_per_step.append(posted)
        if self._mem:
            # sample the *post-expand* page usage: this is the step's
            # true peak (every new branch still holds its pages; the
            # retention policy only frees at complete_step), and it is
            # what the admission estimator must learn from
            self._update_peaks()
        score_reqs, score_states = [], []
        for (idx, st), kids in zip(states, kid_groups):
            to_score = st.note_children(kids)
            if st.finished:
                self._retire(idx)
                continue
            score_reqs.append((st.tree, to_score))
            score_states.append((idx, st))
        if not score_reqs:
            return bool(self.live or self.parked or self._queue)
        # 3. ONE padded PRM call over every problem's candidates
        score_groups = _score_multi(self.backend, score_reqs)
        embed_reqs, embed_states = [], []
        for (idx, st), scores in zip(score_states, score_groups):
            if self.controller is not None:
                self.controller.observe(idx, st, scores)
            to_embed = st.note_scores(scores)
            if st.finished:
                self._retire(idx)
                continue
            if to_embed:
                embed_reqs.append((st.tree, to_embed))
                embed_states.append((idx, st))
            else:
                st.complete_step(None)
        # 4. ONE embedder call for the problems that cluster
        if embed_reqs:
            for (idx, st), embs in zip(embed_states,
                                       _embed_multi(self.backend,
                                                    embed_reqs)):
                st.complete_step(embs)
        return bool(self.live or self.parked or self._queue)

    def run(self) -> List[SearchResult]:
        while self.step():
            pass
        return [self.results[i] for i in range(self._n)]


# One typed entry point serves both deployment shapes: a single backend
# or a sequence of engine replicas.  Normalization happens in ONE place
# (_as_replicas) so every route below sees the same canonical form.
BackendOrReplicas = Union[Backend, Sequence[Backend]]


def _as_replicas(backend: BackendOrReplicas) -> List[Backend]:
    """Canonicalize the backend argument to a non-empty replica list.

    A bare backend is a 1-replica deployment; a list/tuple is taken as
    engine replicas.  Anything else (nested lists, empty sequences,
    generators) is rejected here with an actionable error instead of
    failing deep inside the scheduler.
    """
    if isinstance(backend, (list, tuple)):
        reps = list(backend)
        if not reps:
            raise ValueError(
                "run_search_many: backend list is empty — pass one "
                "backend or a non-empty sequence of engine replicas")
        if any(isinstance(b, (list, tuple)) for b in reps):
            raise ValueError(
                "run_search_many: backend replicas must be a flat "
                "sequence, got a nested list")
        return reps
    return [backend]


def run_search_many(backend: BackendOrReplicas, scfg: SearchConfig,
                    prompts: Sequence[Sequence[int]], *,
                    continuous: bool = True,
                    max_live: Optional[int] = None,
                    adaptive: Optional[AdaptiveConfig] = None
                    ) -> List[SearchResult]:
    """Multi-problem sweep on one shared backend (or replica set).

    ``continuous=True`` (default) drives the whole sweep through the
    ``SweepScheduler``: problems are admitted in batched flash-prefill
    waves (``start_many``), every global step expands *all* live
    problems' leaves in one decode stream and scores all their
    candidates in one padded PRM call, and finished problems retire
    (releasing their pool pages to the admission queue) without
    stalling the rest — the decode batch stays full as searches narrow,
    instead of draining once per problem.  Per-problem results are
    bit-identical to solo ``run_search`` runs; per-problem ``kv_summary``
    comes from the backend's namespaced IO attribution.

    ``continuous=False`` keeps the legacy orchestration — one batched
    prefill for the sweep, then the searches run one problem at a time —
    as the one-at-a-time comparison baseline (benchmarks) and for
    backends that cannot interleave problems.

    Capacity: ``max_live`` bounds how many problems hold pool pages at
    once (default: all).  On engine backends admission is working-set
    aware: each problem reserves prompt pages plus an expected search
    growth (refined online from realized page traces) and a wave only
    enters when its reservations fit, so a pool too small for the whole
    sweep needs no manual chunking or ``max_live`` tuning.  If a
    problem outgrows its estimate mid-search the scheduler demotes a
    victim (pages swap out to a host spill buffer, the problem parks,
    then resumes bit-identically) instead of raising ``OutOfPages`` —
    only a single problem genuinely exceeding the pool still errors,
    exactly as a solo run would.

    ``adaptive`` (continuous sweeps only) turns on difficulty-adaptive
    width: early PRM scores re-target each problem's effective width
    under a global token budget (see :class:`AdaptiveConfig`).  With
    ``adaptive.enabled`` False the sweep is bit-identical to passing no
    config at all.

    Horizontal scaling: ``backend`` may be a list/tuple of backends
    (one engine replica each — :data:`BackendOrReplicas`).  The sweep
    then runs through :class:`repro.core.replica.ReplicaSweep` — one
    admission queue, least-loaded routing, per-replica reservations —
    and ``max_live`` becomes the per-replica bound.  Per-problem
    results stay bit-identical to the single-backend run
    (replica-invisible RNG namespaces).  A 1-element sequence unwraps
    to the plain sweep; both shapes share this one entry point and the
    same validation.
    """
    if not prompts:
        return []
    replicas = _as_replicas(backend)
    if len(replicas) > 1:
        if not continuous:
            raise ValueError(
                "run_search_many: multi-replica sweeps require "
                "continuous=True (the legacy one-problem-at-a-time "
                "orchestration has no replica router) — pass a single "
                "backend or drop continuous=False")
        raise NotImplementedError("replicas: later slice")
    backend = replicas[0]
    if continuous:
        return SweepScheduler(backend, scfg, prompts=prompts,
                              max_live=max_live, adaptive=adaptive).run()
    starter = getattr(backend, "start_many", None)
    if starter is not None:
        trees = list(starter(prompts))
    else:
        trees = [backend.start(p) for p in prompts]
    return [run_search(backend, scfg, tree=t) for t in trees]
