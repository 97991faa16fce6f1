"""Host-side page allocator: refcounts, block tables, copy-on-write.

TPU adaptation of SGLang's RadixAttention: instead of a dynamic radix tree
with pointer chasing, we keep a *static* pool of fixed-size pages and give
every live sequence a block table (list of page indices).  Tree sharing is
plain aliasing — branching a sequence copies its block table and bumps
refcounts; only the *partial* last page is copied eagerly (copy-on-write)
because both branches will append different tokens into it.

The allocator is pure host bookkeeping: it never touches device memory.
Device-side copies required by CoW are returned as (src_page, dst_page,
n_valid) descriptors for the engine to execute in one batched jit op.

Mesh contract (mesh-aware engines, ``EngineConfig.mesh``): everything
this module produces — block tables, page ids, descendant bitmaps,
``tree_metadata`` — is host/replicated by construction, and physical
page ids are *layout-oblivious* names: the pool may shard its page axis
across a device mesh (``launch.sharding.pool_spec``) without any change
here, because every consumer indexes the pool through these tables
inside jit, where GSPMD resolves the shard.  Per-replica scaling needs
no hook at all: each ``EngineReplica`` owns a whole allocator, so seq
ids, namespaces and reservations are naturally replica-local.

Pending-token invariant (the engine contract this bookkeeping serves):
a sequence created by prefill holds pages for ``tokens[:-1]`` — the
handle's ``length`` counts exactly the tokens whose KV is in the pool,
and the prompt's last token stays *pending* until the first decode step
writes its KV into the slot ``append_tokens`` reserves.  Every token's
KV is written exactly once, by whichever jitted step consumes it as
input; ``check_invariants``/tests verify the bookkeeping half, and
tests/test_prefill.py property-tests the pool contents against a dense
oracle under random prefill/branch/free interleavings.

Bucket/recompile discipline: the allocator itself is shape-oblivious,
but everything it feeds to the device is padded to power-of-two buckets
first — ``new_seqs`` allocates a whole prefill batch in one pass so the
engine can bucket the (rows, tokens) axes, and ``tree_metadata`` pads
the unique-page axis — keeping the jit-signature count of the consuming
steps O(log size) across a serving run (see serving/engine.py).

Accounting properties used by tests and the Fig. 2 reproduction:
  * ``used_pages``  — unique physical pages alive (shared counted once).
  * ``logical_pages`` — sum over sequences of their table lengths
    (what per-sequence contiguous caches would cost).

Problem namespaces: every sequence carries an ``ns`` tag (fresh per
``new_seq``/``new_seqs`` entry unless given; inherited by branches), so
many independent search problems can share one allocator — a forest of
roots — with page accounting attributable per problem
(``ns_page_stats``).  Branching never crosses namespaces, so namespaces
partition the live pages and the per-ns counters sum to the global
ones.

Swap (page demotion under memory pressure): ``swap_out_seqs`` releases
the physical pages of one whole namespace back to the free list while
the handles keep their block tables as *stale* page ids — the spill
keys the engine uses to file the evicted KV in its host-side buffer.
A swapped handle is parked: it cannot append, branch, or serve a
decode row until ``swap_in_seqs`` re-allocates fresh physical pages
(any ids — consumers index the pool *through* the block tables, and
the restored bytes are exact copies, so decode streams are unchanged),
rewrites every table, and restores the refcounts.  Namespace closure
(branching never crosses ``ns``) is what makes the whole-namespace
swap safe: no sequence outside the set can reference the released
pages.  ``self.swapped`` carries the per-ns stale-page refcounts —
the per-problem swap accounting that the engine's ``swapped_out/in``
counters reconcile against.

Subtree-grained spill: ``swap_out_seqs(..., partial=True)`` demotes
*any subset* of a namespace's sequences.  Only pages referenced
exclusively within the subset (``exclusive_pages``) are released and
staled — a page shared with a sequence outside the subset stays
physically live (the parked handle keeps its refcount on it), so
spilling a subtree of leaves moves only the KV below their fork while
the shared prefix stays hot.  A parked handle's table is therefore a
mix: entries in ``self.swapped[ns]`` are stale spill keys, the rest
are live references.  ``swap_in_seqs`` still covers every swapped
handle of the namespace and rewrites only the stale entries.  Partial
swap-outs of the same namespace merge into one stale-refcount dict;
interleaving them with appends that could recycle a stale id into the
same namespace is rejected at swap-out time.

``tree_metadata`` derives the tree-attention operands for a decode step
(unique live page list, per-page descendant bitmap over the padded
batch, per-page valid lengths) from the live block tables.  Every
mutating op bumps ``version``, and the derivation is memoized on
(version, row layout), so the per-step cost is paid once per step — the
engine's per-layer attention calls reuse the same arrays.

The per-step derivation is *incremental*: the allocator keeps a
persistent tree-metadata state (per-page referencing-row sets, the
sorted unique-page order, and a double-buffered pair of
page_list/page_mask/page_lens arrays that swap every build) and updates
only what changed since the previous step — a CoW swaps one page
in-place, appends insert their new pages at the right order position,
row retire/seat touches just that mask column's pages, and unchanged
pages' mask rows are copied across buffers in one vectorized move.  The
canonical unique-page order is first-visit order over (row, table
position); because a shared page occupies the same table position in
every referencing row, that equals sorting pages by
(min referencing row, position) — the key the incremental path
maintains.  The from-scratch ``build_tree_metadata`` rebuild stays
behind ``incremental=False`` as the memoized equivalence oracle; tests
assert bit-identical arrays between the two over full searches.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclass
class SequenceHandle:
    seq_id: int
    block_table: List[int]
    length: int                   # tokens written so far
    ns: int = 0                   # problem namespace (branch inherits)
    swapped: bool = False         # pages demoted to the host spill buffer

    def last_page_fill(self, page_size: int) -> int:
        rem = self.length % page_size
        if rem == 0 and self.length > 0:
            return page_size
        return rem


@dataclass
class CopyOp:
    src_page: int
    dst_page: int
    n_valid: int                  # token slots to copy


class OutOfPages(RuntimeError):
    pass


@dataclass
class VictimCandidate:
    """One demotion candidate for :func:`select_victim`.

    ``slack`` is deadline headroom: the candidate's deadline minus the
    current clock minus its estimated remaining cost (the serving
    loop's SLO term).  Offline sweeps and requests without deadlines
    use the default ``+inf``.
    """
    key: Any                      # caller's handle (problem index)
    slack: float = math.inf       # deadline headroom; +inf = no deadline
    score: float = 0.0            # best live-leaf PRM score
    pages: int = 0                # pages held (live + spilled)


def select_victim(candidates: Sequence[VictimCandidate]) -> VictimCandidate:
    """Slack-aware demotion policy for page pressure.

    Demote the candidate with the LARGEST slack first — the problem
    that can best afford to wait out a spill round-trip (no-deadline
    problems are infinitely patient, so they go before any
    deadline-constrained one).  Ties break toward the lowest PRM score
    (the trajectory the cost model values least), then the most pages
    held (frees the most room per demotion), then the smallest key
    (deterministic).  With every slack infinite this reduces exactly to
    the historical lowest-score / most-pages policy the offline sweep
    scheduler uses.
    """
    assert candidates, "no demotion candidates"
    return min(candidates,
               key=lambda c: (-c.slack, c.score, -c.pages, c.key))


class ReservationLedger:
    """Admission-reservation ledger for a fixed-size page pool.

    The sweep scheduler's working-set admission control books one
    reservation per admitted problem (prompt pages + expected search
    growth) and releases it at retirement.  This ledger is the single
    place the invariant "the reserved sum never exceeds the pool"
    lives: ``book`` asserts it outright, and ``rebook`` — the
    difficulty-adaptive width hook — clamps so adaptation cannot break
    it either direction:

      * a *shrink* takes effect immediately (the freed headroom is
        available to the next admission wave the same global step) but
        never drops below the ``floor`` the caller passes — the pages
        the problem actually holds — so shrinking a problem's width
        can never strand pages that are still occupied;
      * a *grow* is clamped to the pool's unreserved headroom, so a
        hard problem's raised reservation can over-commit nothing —
        the demotion path covers any genuine overflow, exactly as when
        a problem outgrows its original estimate.

    ``total_pages=None`` disables the pool invariant (callers without
    page accounting), keeping only the bookkeeping.
    """

    def __init__(self, total_pages: Optional[int] = None):
        self.total_pages = total_pages
        self._pages: Dict[Any, int] = {}

    def book(self, key: Any, pages: int) -> None:
        """Open a reservation; the key must not already hold one."""
        assert key not in self._pages, key
        pages = max(int(pages), 0)
        if self.total_pages is not None:
            assert self.total() + pages <= self.total_pages, \
                (self.total(), pages, self.total_pages)
        self._pages[key] = pages

    def rebook(self, key: Any, pages: int, floor: int = 0) -> int:
        """Re-size an open reservation (see class docstring); returns
        the value actually booked.  No-op (0) for an unknown key."""
        if key not in self._pages:
            return 0
        cur = self._pages[key]
        pages = max(int(pages), int(floor), 0)
        if pages > cur and self.total_pages is not None:
            headroom = self.total_pages - self.total()
            pages = min(pages, cur + max(headroom, 0))
        self._pages[key] = pages
        return pages

    def release(self, key: Any) -> int:
        """Close a reservation; returns the pages it held (0 if none)."""
        return self._pages.pop(key, 0)

    def get(self, key: Any, default: int = 0) -> int:
        return self._pages.get(key, default)

    def total(self) -> int:
        """Sum of all open reservations."""
        return sum(self._pages.values())

    def __contains__(self, key: Any) -> bool:
        return key in self._pages

    def __len__(self) -> int:
        return len(self._pages)


class _TreeMetaState:
    """Persistent incremental tree-metadata state (one per allocator).

    Tracks, for the last row layout ``tree_metadata`` built, each
    page's referencing rows and sort key, plus snapshots of the row
    tables (so retired rows can be unwound without the freed handles)
    and a double-buffered pair of output arrays: every build writes the
    *other* buffer, so the arrays a decode step is still consuming are
    never mutated under it (a metadata object is valid until the build
    after next).
    """
    __slots__ = ("rows", "pad_page", "min_pages", "row_tables",
                 "row_lengths", "page_rows", "key_of", "order",
                 "page_idx", "n_logical", "bufs", "cur")

    def __init__(self, pad_page: int, min_pages: int, n_rows: int):
        self.pad_page = pad_page
        self.min_pages = min_pages
        self.rows: List[Optional[int]] = [None] * n_rows
        self.row_tables: List[List[int]] = [[] for _ in range(n_rows)]
        self.row_lengths: List[int] = [0] * n_rows
        self.page_rows: Dict[int, Set[int]] = {}   # page -> row indices
        self.key_of: Dict[int, Tuple[int, int]] = {}  # page -> (min row, pos)
        self.order: List[Tuple[Tuple[int, int], int]] = []  # sorted (key, pg)
        self.page_idx: Dict[int, int] = {}         # page -> last emit index
        self.n_logical = 0
        self.bufs: List[Optional[dict]] = [None, None]  # double buffer
        self.cur = 0


class PageAllocator:
    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.refcount: List[int] = [0] * n_pages
        self.seqs: Dict[int, SequenceHandle] = {}
        self._next_seq = 0
        self._next_ns = 0
        # bumped on every mutation; keys the tree-metadata memo
        self.version = 0
        self._meta_cache: Optional[Tuple[tuple, object]] = None
        # incremental tree-metadata state + build counters (tests and
        # benchmarks assert the incremental path actually runs)
        self._inc: Optional[_TreeMetaState] = None
        self.meta_full_builds = 0
        self.meta_inc_builds = 0
        # per-ns swap accounting: ns -> {stale page id: table references}.
        # Stale ids are the physical ids the namespace held at swap-out
        # time; they key the engine's host spill buffer and may be
        # reused by other sequences while the namespace is parked.
        self.swapped: Dict[int, Dict[int, int]] = {}

    # -- stats -----------------------------------------------------------
    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self.free)

    @property
    def logical_pages(self) -> int:
        return sum(len(s.block_table) for s in self.seqs.values())

    def shared_pages(self) -> int:
        return sum(1 for rc in self.refcount if rc > 1)

    @property
    def swapped_pages(self) -> int:
        """Unique pages currently demoted to the host spill buffer."""
        return sum(len(refs) for refs in self.swapped.values())

    # -- per-problem (namespace) attribution ------------------------------
    # A namespace groups the sequences of one search problem.  Branching
    # never crosses namespaces, so namespaces partition the live pages:
    # summing these over live namespaces reproduces the global counters
    # above (the property the per-problem IO tests assert).

    def ns_page_stats(self, ns: int,
                      seq_ids: Optional[Sequence[int]] = None
                      ) -> Dict[str, int]:
        """One-pass per-problem page accounting: unique physical pages,
        logical pages (sum of the namespace's table lengths — the
        per-sequence contiguous-cache cost) and shared pages referenced
        by namespace ``ns``.  Callers that already track the
        namespace's sequence ids (the search backend does) pass them as
        ``seq_ids`` to skip the full-allocator scan — O(own sequences)
        instead of O(all sequences) per call."""
        if seq_ids is None:
            handles = [h for h in self.seqs.values() if h.ns == ns]
        else:
            handles = [self.seqs[s] for s in seq_ids if s in self.seqs]
        pages: set = set()
        logical = 0
        stale = self.swapped.get(ns, {})
        for h in handles:
            assert h.ns == ns, (h.seq_id, h.ns, ns)
            if not h.swapped:
                pages.update(h.block_table)
            else:
                # stale ids are not physical pages, but a partially
                # spilled handle's shared-prefix entries still are
                pages.update(pg for pg in h.block_table
                             if pg not in stale)
            logical += len(h.block_table)
        return {"physical_pages": len(pages),
                "logical_pages": logical,
                "shared_pages": sum(1 for pg in pages
                                    if self.refcount[pg] > 1),
                "swapped_pages": len(self.swapped.get(ns, {}))}

    # -- internals ---------------------------------------------------------
    def _alloc_page(self) -> int:
        if not self.free:
            raise OutOfPages(f"pool exhausted ({self.n_pages} pages)")
        pg = self.free.pop()
        self.refcount[pg] = 1
        return pg

    def _release_page(self, pg: int) -> None:
        self.refcount[pg] -= 1
        assert self.refcount[pg] >= 0, pg
        if self.refcount[pg] == 0:
            self.free.append(pg)

    # -- public API --------------------------------------------------------
    def new_seq(self, prompt_tokens: int = 0,
                ns: Optional[int] = None) -> SequenceHandle:
        """Create an empty sequence with room for `prompt_tokens`.

        Never produces device copies: prompt KV is written by prefill
        into freshly-allocated (unshared) pages, so unlike
        ``append_tokens`` there is no CoW to report.  ``ns`` is the
        problem namespace the sequence (and every branch forked from
        it) is attributed to; a fresh one is minted when omitted.
        """
        self.version += 1
        n_pages = -(-prompt_tokens // self.page_size) if prompt_tokens else 0
        table = [self._alloc_page() for _ in range(n_pages)]
        if ns is None:
            ns = self._next_ns
            self._next_ns += 1
        h = SequenceHandle(self._next_seq, table, prompt_tokens, ns=ns)
        self._next_seq += 1
        self.seqs[h.seq_id] = h
        return h

    def new_seqs(self, prompt_token_counts: Sequence[int],
                 ns: Optional[Sequence[int]] = None
                 ) -> List[SequenceHandle]:
        """Allocate a whole prefill batch in one pass (all-or-nothing).

        Capacity for every sequence is checked up front, so a mid-batch
        ``OutOfPages`` can never leave a half-allocated batch behind —
        the batched prefill either owns pages for all its prompts or
        touches nothing.  Each prompt starts its own problem namespace
        unless ``ns`` supplies one per prompt.
        """
        need = sum(-(-n // self.page_size) for n in prompt_token_counts)
        if need > len(self.free):
            raise OutOfPages(
                f"prefill batch needs {need} pages, {len(self.free)} free")
        if ns is None:
            ns = [None] * len(prompt_token_counts)
        assert len(ns) == len(prompt_token_counts)
        return [self.new_seq(n, ns=s)
                for n, s in zip(prompt_token_counts, ns)]

    def append_tokens(self, seq_id: int, n: int) -> List[CopyOp]:
        """Reserve slots for n new tokens; may CoW the shared last page."""
        self.version += 1
        h = self.seqs[seq_id]
        assert not h.swapped, (seq_id, "append on a swapped-out sequence")
        ops: List[CopyOp] = []
        # CoW: if the last page is shared and not full, privatize it first
        if h.block_table:
            last = h.block_table[-1]
            fill = h.last_page_fill(self.page_size)
            if self.refcount[last] > 1 and fill < self.page_size:
                new_pg = self._alloc_page()
                ops.append(CopyOp(last, new_pg, fill))
                self._release_page(last)
                h.block_table[-1] = new_pg
        space = len(h.block_table) * self.page_size - h.length
        need = n - space
        while need > 0:
            h.block_table.append(self._alloc_page())
            need -= self.page_size
        h.length += n
        return ops

    def branch(self, seq_id: int, n_branches: int = 1) -> List[SequenceHandle]:
        """Fork a sequence into n additional branches sharing its pages."""
        self.version += 1
        h = self.seqs[seq_id]
        assert not h.swapped, (seq_id, "branch on a swapped-out sequence")
        out = []
        for _ in range(n_branches):
            for pg in h.block_table:
                self.refcount[pg] += 1
            b = SequenceHandle(self._next_seq, list(h.block_table), h.length,
                               ns=h.ns)
            self._next_seq += 1
            self.seqs[b.seq_id] = b
            out.append(b)
        return out

    def free_seq(self, seq_id: int) -> None:
        self.version += 1
        h = self.seqs.pop(seq_id)
        if h.swapped:
            # trim the stale-page refs so the per-ns swap accounting
            # tracks only referenced spill pages; entries NOT in the
            # stale dict are live shared-prefix pages a partial spill
            # kept hot — release those normally.  Drop the namespace
            # entry once its last swapped handle is gone (the engine
            # then drops the spill buffer).
            refs = self.swapped.get(h.ns, {})
            for pg in h.block_table:
                if pg in refs:
                    refs[pg] -= 1
                    assert refs[pg] >= 0, (h.ns, pg)
                    if refs[pg] == 0:
                        del refs[pg]
                else:
                    self._release_page(pg)
            if not any(s.swapped and s.ns == h.ns
                       for s in self.seqs.values()):
                self.swapped.pop(h.ns, None)
            return
        for pg in h.block_table:
            self._release_page(pg)

    # -- swap (page demotion under memory pressure) ------------------------
    def exclusive_pages(self, seq_ids: Sequence[int]) -> List[int]:
        """Pages referenced *only* within ``seq_ids`` — exactly what a
        ``swap_out_seqs(..., partial=True)`` of the set would release.
        Pure query (no mutation): the engine gathers these pages' KV to
        the host *before* the swap-out frees them for reuse."""
        refs: Dict[int, int] = {}
        for s in seq_ids:
            for pg in self.seqs[s].block_table:
                refs[pg] = refs.get(pg, 0) + 1
        return sorted(pg for pg, n in refs.items()
                      if self.refcount[pg] == n)

    def swap_out_seqs(self, seq_ids: Sequence[int], *,
                      partial: bool = False) -> List[int]:
        """Demote sequences: release their exclusive physical pages.

        Default (``partial=False``): ``seq_ids`` must be *all* live
        sequences of one namespace — branching never crosses
        namespaces, so the set is closed under page sharing and every
        page is exclusive to it.  With ``partial=True`` any subset of
        one namespace may be demoted: pages shared with sequences
        outside the subset stay physically live (the parked handles
        keep their refcounts on them — the shared prefix of a spilled
        subtree stays hot), and only the subset-exclusive pages are
        released.  Either way the released entries of each handle's
        block table become stale page ids (the engine's spill keys),
        the handles are marked ``swapped``, and the stale-page
        refcounts merge into ``self.swapped[ns]``.  Returns the unique
        released page ids, sorted (the order the engine gathers them
        into the host buffer).
        """
        assert seq_ids, "empty swap set"
        handles = [self.seqs[s] for s in seq_ids]
        ns = handles[0].ns
        assert all(h.ns == ns for h in handles), "swap set spans namespaces"
        assert not any(h.swapped for h in handles), "already swapped"
        if not partial:
            assert ns not in self.swapped, (ns, "namespace already swapped")
            covered = {h.seq_id for h in handles}
            assert all(h.seq_id in covered
                       for h in self.seqs.values() if h.ns == ns), \
                "swap set must cover the whole namespace"
        self.version += 1
        refs: Dict[int, int] = {}
        for h in handles:
            for pg in h.block_table:
                refs[pg] = refs.get(pg, 0) + 1
            h.swapped = True
        prior = self.swapped.get(ns, {})
        for pg, n in list(refs.items()):
            if self.refcount[pg] == n:
                # every reference to the page is inside the set (always
                # true for whole-namespace swaps): release and stale it
                assert pg not in prior, \
                    (ns, pg, "stale id recycled across partial swaps")
                self.refcount[pg] = 0
                self.free.append(pg)
            else:
                assert partial, (pg, self.refcount[pg], n,
                                 "shared outside a whole-namespace swap")
                # shared with a live sequence outside the subset: the
                # parked handles keep their (live) references to it
                assert pg not in prior, \
                    (ns, pg, "live page collides with a stale id")
                refs.pop(pg)
        prior.update(refs)
        self.swapped[ns] = prior
        return sorted(refs)

    def swap_in_seqs(self, seq_ids: Sequence[int]) -> Dict[int, int]:
        """Restore a swapped namespace onto fresh physical pages.

        Allocates one page per live stale id (all-or-nothing — raises
        ``OutOfPages`` before touching anything when the pool lacks
        room), rewrites every handle's block table through the returned
        ``{stale id: new id}`` mapping and restores refcounts.  The
        engine scatters the host spill buffer into the new pages; the
        bytes are exact copies, so decode streams resume bit-identically
        (consumers index the pool through the block tables, never by
        raw page id).
        """
        assert seq_ids, "empty swap set"
        handles = [self.seqs[s] for s in seq_ids]
        ns = handles[0].ns
        assert all(h.ns == ns and h.swapped for h in handles), \
            "swap-in set must be one swapped namespace"
        covered = {h.seq_id for h in handles}
        assert all(h.seq_id in covered for h in self.seqs.values()
                   if h.ns == ns and h.swapped), \
            "swap-in set must cover the whole namespace"
        refs = self.swapped.get(ns, {})
        if len(refs) > len(self.free):
            raise OutOfPages(
                f"swap-in needs {len(refs)} pages, {len(self.free)} free")
        self.version += 1
        mapping = {old: self._alloc_page() for old in sorted(refs)}
        for old, new in mapping.items():
            self.refcount[new] = refs[old]
        for h in handles:
            # only stale entries remap; live shared-prefix entries a
            # partial spill kept hot keep their physical ids (and the
            # refcounts the parked handle already holds on them)
            h.block_table = [mapping.get(pg, pg) for pg in h.block_table]
            h.swapped = False
        self.swapped.pop(ns, None)
        return mapping

    # -- tree-attention metadata -------------------------------------------
    def tree_metadata(self, seq_ids_by_row: Sequence[Optional[int]], *,
                      pad_page: int = 0, min_pages: int = 8,
                      check: bool = False,
                      incremental: Optional[bool] = None):
        """Tree-attention operands for one decode step.

        ``seq_ids_by_row`` maps padded batch rows to live sequences
        (None = inactive row -> all-zero mask column).  Returns a
        ``repro.kernels.TreeMetadata``; memoized on (allocator version,
        row layout) so repeated derivation within a step is free.

        By default the arrays come from the incremental state (see the
        module docstring): only pages touched since the previous step
        are recomputed, everything else is carried across the double
        buffer.  ``incremental=False`` (implied by ``check=True``)
        forces the from-scratch ``build_tree_metadata`` derivation —
        the memoized equivalence oracle the incremental path is tested
        against.  Incremental arrays live in a ping-pong buffer pair:
        a returned metadata object stays valid until the build after
        next (one full step beyond its own), which covers every
        consumer — the engine converts to device arrays within the
        step.
        """
        if incremental is None:
            incremental = not check
        key = (self.version, tuple(seq_ids_by_row), pad_page, min_pages,
               check, bool(incremental))
        if self._meta_cache is not None and self._meta_cache[0] == key:
            return self._meta_cache[1]
        if incremental:
            meta = self._meta_incremental(list(seq_ids_by_row), pad_page,
                                          min_pages)
        else:
            meta = self._meta_full(seq_ids_by_row, pad_page, min_pages,
                                   check)
        self._meta_cache = (key, meta)
        return meta

    def _meta_full(self, seq_ids_by_row, pad_page, min_pages, check):
        """From-scratch derivation (the equivalence oracle)."""
        from .tree_meta import build_tree_metadata
        self.meta_full_builds += 1
        tables: List[List[int]] = []
        lengths: List[int] = []
        for sid in seq_ids_by_row:
            if sid is None:
                tables.append([])
                lengths.append(0)
            else:
                h = self.seqs[sid]
                tables.append(h.block_table)
                lengths.append(h.length)
        return build_tree_metadata(tables, lengths, self.page_size,
                                   pad_page=pad_page, min_pages=min_pages,
                                   check=check)

    # -- incremental derivation internals ---------------------------------
    def _meta_incremental(self, rows, pad_page, min_pages):
        st = self._inc
        if (st is None or st.pad_page != pad_page
                or st.min_pages != min_pages or len(st.rows) != len(rows)):
            # no reusable state (first build, or a different consumer
            # layout): seed it with one full scan
            self.meta_full_builds += 1
            return self._meta_reseed(rows, pad_page, min_pages)
        self.meta_inc_builds += 1
        order = st.order
        dirty: Set[int] = set()    # pages whose mask row must be rebuilt

        def remove(j, pg):
            dirty.add(pg)
            refs = st.page_rows[pg]
            refs.discard(j)
            okey = st.key_of[pg]
            i = bisect.bisect_left(order, (okey, pg))
            assert order[i] == (okey, pg), (pg, okey)
            if not refs:
                del st.page_rows[pg], st.key_of[pg]
                order.pop(i)
            elif okey[0] == j:     # j was the min row: key moves later
                order.pop(i)
                nkey = (min(refs), okey[1])
                st.key_of[pg] = nkey
                bisect.insort(order, (nkey, pg))

        def add(j, pg, pos):
            dirty.add(pg)
            refs = st.page_rows.get(pg)
            if refs is None:
                st.page_rows[pg] = {j}
                st.key_of[pg] = (j, pos)
                bisect.insort(order, ((j, pos), pg))
            else:
                refs.add(j)
                okey = st.key_of[pg]
                if j < okey[0]:    # j is the new min row: key moves up
                    i = bisect.bisect_left(order, (okey, pg))
                    assert order[i] == (okey, pg), (pg, okey)
                    order.pop(i)
                    nkey = (j, pos)
                    st.key_of[pg] = nkey
                    bisect.insort(order, (nkey, pg))

        for j, sid in enumerate(rows):
            prev = st.rows[j]
            if sid == prev:
                if sid is None:
                    continue
                h = self.seqs[sid]
                new_t, old_t = h.block_table, st.row_tables[j]
                L = len(old_t)
                if (len(new_t) == L and (L == 0 or new_t[L - 1] == old_t[-1])
                        and h.length == st.row_lengths[j]):
                    continue       # untouched row
                if L and new_t[L - 1] != old_t[-1]:
                    # last entry swapped: usually CoW (prefix unchanged),
                    # but swap-in remaps whole tables — diff the prefix
                    for pos in range(L):
                        if new_t[pos] != old_t[pos]:
                            remove(j, old_t[pos])
                            add(j, new_t[pos], pos)
                for pos in range(L, len(new_t)):
                    add(j, new_t[pos], pos)
                st.n_logical += len(new_t) - L
                st.row_tables[j] = list(new_t)
                st.row_lengths[j] = h.length
            else:
                if prev is not None:
                    for pg in st.row_tables[j]:
                        remove(j, pg)
                    st.n_logical -= len(st.row_tables[j])
                if sid is None:
                    st.row_tables[j] = []
                    st.row_lengths[j] = 0
                else:
                    h = self.seqs[sid]
                    for pos, pg in enumerate(h.block_table):
                        add(j, pg, pos)
                    st.n_logical += len(h.block_table)
                    st.row_tables[j] = list(h.block_table)
                    st.row_lengths[j] = h.length
                st.rows[j] = sid
        return self._meta_emit(st, dirty)

    def _meta_reseed(self, rows, pad_page, min_pages):
        """Rebuild the incremental state from the live tables."""
        st = _TreeMetaState(pad_page, min_pages, len(rows))
        for j, sid in enumerate(rows):
            if sid is None:
                continue
            h = self.seqs[sid]
            t = list(h.block_table)
            st.rows[j] = sid
            st.row_tables[j] = t
            st.row_lengths[j] = h.length
            st.n_logical += len(t)
            for pos, pg in enumerate(t):
                refs = st.page_rows.get(pg)
                if refs is None:
                    st.page_rows[pg] = {j}
                    # rows scan in increasing j: first visit is the min
                    st.key_of[pg] = (j, pos)
                else:
                    refs.add(j)
        st.order = sorted((k, pg) for pg, k in st.key_of.items())
        self._inc = st
        return self._meta_emit(st, None)

    def _meta_emit(self, st, dirty):
        """Write the arrays for the current state into the inactive
        buffer and swap.  ``dirty`` is the set of pages whose mask row
        must be rebuilt (None = all); clean pages' rows are copied from
        the previous buffer in one vectorized move.  ``page_lens`` is
        always recomputed — O(unique pages) of integer math — because
        any append shifts its row's tail fills."""
        from .tree_meta import TreeMetadata, _next_pow2
        B = len(st.rows)
        n_unique = len(st.order)
        N = _next_pow2(max(n_unique, 1), st.min_pages)
        nxt = 1 - st.cur
        buf = st.bufs[nxt]
        if buf is None or buf["page_mask"].shape != (N, B):
            buf = {"page_list": np.empty(N, np.int32),
                   "page_lens": np.empty(N, np.int32),
                   "page_mask": np.zeros((N, B), np.int8)}
        else:
            buf["page_mask"].fill(0)
        page_list, page_lens = buf["page_list"], buf["page_lens"]
        mask = buf["page_mask"]
        page_list.fill(st.pad_page)
        page_lens.fill(0)
        old = st.bufs[st.cur]
        can_copy = (dirty is not None and old is not None
                    and old["page_mask"].shape[1] == B)
        ps = self.page_size
        new_idx: Dict[int, int] = {}
        copy_src: List[int] = []
        copy_dst: List[int] = []
        for i, (_, pg) in enumerate(st.order):
            new_idx[pg] = i
            page_list[i] = pg
            r, pos = st.key_of[pg]
            v = st.row_lengths[r] - pos * ps
            page_lens[i] = ps if v > ps else v
            if can_copy and pg not in dirty:
                copy_src.append(st.page_idx[pg])
                copy_dst.append(i)
            else:
                mask[i, sorted(st.page_rows[pg])] = 1
        if copy_dst:
            mask[np.asarray(copy_dst)] = old["page_mask"][
                np.asarray(copy_src)]
        st.page_idx = new_idx
        st.bufs[nxt] = buf
        st.cur = nxt
        return TreeMetadata(page_list, mask, page_lens, n_unique,
                            st.n_logical)

    # -- invariants (tests) ------------------------------------------------
    def check_invariants(self) -> None:
        counts = [0] * self.n_pages
        swapped_refs: Dict[int, Dict[int, int]] = {}
        for s in self.seqs.values():
            need = -(-s.length // self.page_size) if s.length else 0
            assert len(s.block_table) >= need, (s.seq_id, s.length,
                                                len(s.block_table))
            if s.swapped:
                # stale ids: counted against the per-ns swap accounting,
                # never against live refcounts.  A partially spilled
                # handle's non-stale entries are live shared-prefix
                # references and count like any other live table entry.
                stale = self.swapped.get(s.ns, {})
                refs = swapped_refs.setdefault(s.ns, {})
                for pg in s.block_table:
                    if pg in stale:
                        refs[pg] = refs.get(pg, 0) + 1
                    else:
                        counts[pg] += 1
                continue
            for pg in s.block_table:
                counts[pg] += 1
        assert counts == self.refcount, "refcount mismatch"
        free_set = set(self.free)
        for pg, rc in enumerate(self.refcount):
            assert (rc == 0) == (pg in free_set), (pg, rc)
        # swap accounting reconciles with the swapped handles' tables
        assert swapped_refs == self.swapped, "swap accounting mismatch"
