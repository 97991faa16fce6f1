"""LM search backend (port of ``repro.serving.search_backend``).

Wires the paged engine (search LM), a PRM (LM with value head) and a
small encoder embedder into the ``core.controllers.Backend`` protocol:

  expand — branch the leaf's sequence (block-table fork, CoW) and decode
           one reasoning step per branch (until the step delimiter / EOS);
  score  — PRM reward at the trajectory's last position;
  embed  — mean-pooled encoder state of the *last step's* tokens;
  answer — task-specific extractor over the finished trajectory.

The cross-problem sweep protocol (``expand_multi`` / ``score_multi`` /
``embed_multi``) batches every problem's work into one decode stream,
one PRM call and one encoder call; the single-problem ``*_many``
methods are its one-request case.  PRM and encoder batches are
right-padded into power-of-two (rows, length) buckets with padded
positions at -1, which the attention mask excludes.

Problem namespaces: every problem keeps its own engine sequence
namespace, sampling-key chain and IO sums, so a branch's token
stream depends only on its own problem.  The chain is the reference's:
it starts at ``key(seed)``, each expand call splits it once (``chain,
step_key = fold_in(chain, 0), fold_in(chain, 1)``) and branch i decodes
from ``fold_in(step_key, i)`` (``sampler``).

``on_step`` frees the engine sequences of pruned leaves — where ETS's
ILP decisions become physical page releases — and ``finish_problem``
releases what the final step left behind.

Memory pressure: ``capacity``, ``prompt_pages``, ``swap_out_problem``
and the rest are the backend half of the sweep scheduler's admission
and demotion protocol (all in pages), so a sweep whose working set
outgrows the pool parks problems in host memory instead of failing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..core.tree import SearchTree
from ..device import resolve_device
from .engine import PagedEngine
from .sampler import fold_in, split
from .sampler import key as prng_key
from ..kvcache.pool import pow2_bucket as _bucket


@dataclass
class BackendConfig:
    step_token: int                # reasoning-step delimiter (e.g. '\n')
    eos_token: int
    max_step_tokens: int = 48
    max_depth: int = 16
    temperature: float = 1.0


@dataclass
class ExpandTicket:
    """One problem's expansion split at its decode boundary: leaves are
    branched and the step key consumed, nothing decoded yet."""
    tree: SearchTree
    plan: List[Tuple[int, List[int]]]
    branches: List[int]
    row_keys: Optional[np.ndarray]     # (len(branches), 2) uint32


def _pad_bucket(seqs: Sequence[Sequence[int]]):
    """Pad token sequences into a power-of-two (rows, length) bucket.

    Returns (toks (Bp,T), pos (Bp,T), lengths (Bp,)): tokens
    zero-padded, positions -1 at pads, padded rows given length 1.
    """
    B = len(seqs)
    lens = [len(s) for s in seqs]
    T = _bucket(max(lens))
    Bp = _bucket(B, lo=1)
    toks = np.zeros((Bp, T), np.int64)
    pos = np.full((Bp, T), -1, np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
        pos[i, :len(s)] = np.arange(len(s))
    lengths = np.ones(Bp, np.int64)
    lengths[:B] = lens
    return toks, pos, lengths


def _split_counts(flat: Sequence, counts: Sequence[int]) -> List[List]:
    """Un-flatten a per-request concatenation."""
    out, i = [], 0
    for n in counts:
        out.append(list(flat[i:i + n]))
        i += n
    return out


class LMBackend:
    def __init__(self, engine: PagedEngine, prm_model, prm_params,
                 embed_model, embed_params, bcfg: BackendConfig,
                 answer_fn: Callable[[List[int]], Optional[Any]],
                 seed: int = 0, *, device=None):
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"engine on {engine.device}, backend on "
                             f"{self.device}")
        self.engine = engine
        self.prm_model = prm_model
        self.embed_model = embed_model
        # cast once to the compute type (the reference casts inside every
        # jitted call; the cast of an already-cast tree is a no-op)
        self.prm_params = prm_model.cast_params(prm_params)
        self.embed_params = embed_model.cast_params(embed_params)
        self.bcfg = bcfg
        self.answer_fn = answer_fn
        if self.device.type == "cuda":
            # The PRM's transients at a long bucket (128 x 2048: 7 GiB
            # score tiles, 9 GiB MLP states) dwarf decode's.  In fixed
            # segments the allocator splits the cached ones under the next
            # call until a tile no longer fits; expandable segments (set
            # for the whole process) grow one mapping instead.
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:True")
        self.seed = seed
        # per-problem state, keyed by namespace: the sampling-key chain,
        # live engine sequences, the cumulative IO counters at the last
        # closed step, and the IO the closed steps streamed
        self._keys: Dict[Any, np.ndarray] = {}
        self._ns_seqs: Dict[Any, set] = {}
        self._last_io_ns: Dict[Any, Tuple[int, int]] = {}
        # ns (None: every problem) -> [unique, logical pages, steps]
        self._io: Dict[Any, List[int]] = {None: [0, 0, 0]}
        self.gen_tokens_by_problem: Dict[Any, int] = {}
        # traced: ns -> (stamp its open step began, steps closed)
        self._step_open: Dict[Any, Tuple[int, int]] = {}
        # roots prefilled ahead of their search (start_many sweeps):
        # on_step must not free them before their search branches them
        self._protected: set = set()

    def _put(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    # ------------------------------------------------------------------
    def _ns_of(self, seq_id: int):
        return self.engine.alloc.seqs[seq_id].ns

    def start(self, prompt_tokens: Sequence[int]) -> SearchTree:
        return self.start_many([prompt_tokens])[0]

    @tracing.span("prefill")
    def start_many(self, prompts: Sequence[Sequence[int]]
                   ) -> List[SearchTree]:
        """Prefill a whole problem sweep in one batched flash stream;
        each prompt opens its own problem namespace.  Traced, each
        problem's first ``step`` span opens here."""
        sids = self.engine.prefill_many(prompts)
        self._protected.update(sids)
        trees = []
        t = tracing.now() if tracing.on else None
        for p, sid in zip(prompts, sids):
            ns = self._ns_of(sid)
            self._keys[ns] = prng_key(self.seed)
            self._ns_seqs.setdefault(ns, set()).add(sid)
            if t is not None:
                self._step_open[ns] = (t, 0)
            trees.append(SearchTree(
                root_tokens=len(p),
                root_payload={"seq_id": sid, "tokens": [], "ns": ns}))
        return trees

    def _next_key(self, ns) -> np.ndarray:
        """Split the problem's chain once; returns the step key."""
        chain = self._keys.get(ns, prng_key(self.seed))
        self._keys[ns] = fold_in(chain, 0)
        return fold_in(chain, 1)

    def _add_child(self, tree: SearchTree, leaf: int, bid: int,
                   toks: List[int]) -> int:
        """Create the tree node for decoded branch `bid` of `leaf`."""
        node = tree.node(leaf)
        full = self.engine.tokens[bid]
        ans = self.answer_fn(full)
        finished = (bool(toks) and toks[-1] == self.bcfg.eos_token) \
            or ans is not None \
            or node.depth + 1 >= self.bcfg.max_depth \
            or len(full) >= self.engine.ecfg.max_seq_len - \
            self.bcfg.max_step_tokens
        return tree.add(leaf, n_tokens=len(toks), finished=finished,
                        payload={"seq_id": bid, "tokens": toks,
                                 "answer": ans})

    # -- Backend protocol --------------------------------------------------
    def expand(self, tree: SearchTree, leaf: int, n: int) -> List[int]:
        return self.expand_many(tree, [(leaf, n)])

    def expand_many(self, tree: SearchTree,
                    leaf_counts: Sequence[Tuple[int, int]]) -> List[int]:
        return self.expand_multi([(tree, leaf_counts)])[0]

    def expand_begin(self, tree: SearchTree,
                     leaf_counts: Sequence[Tuple[int, int]]
                     ) -> ExpandTicket:
        """Branch a problem's live leaves and derive its row keys,
        without decoding.  Consumes one step key iff any leaf branches."""
        ns = tree.node(0).payload["ns"]
        plan: List[Tuple[int, List[int]]] = []
        branches: List[int] = []
        for leaf, n in leaf_counts:
            node = tree.node(leaf)
            if node.depth >= self.bcfg.max_depth or n <= 0:
                continue
            bids = self.engine.branch(node.payload["seq_id"], n)
            # once branched, the root's pages live on through its
            # children's refcounts — drop the sweep protection
            self._protected.discard(node.payload["seq_id"])
            self._ns_seqs.setdefault(ns, set()).update(bids)
            plan.append((leaf, bids))
            branches.extend(bids)
        row_keys = None
        if branches:
            row_keys = split(self._next_key(ns), len(branches))
        return ExpandTicket(tree=tree, plan=plan, branches=branches,
                            row_keys=row_keys)

    def expand_finish(self, ticket: ExpandTicket,
                      outs: Dict[int, List[int]]) -> List[int]:
        """Turn a ticket's decoded streams into tree children, grouped
        by leaf in plan order."""
        kids: List[int] = []
        ns = ticket.tree.node(0).payload["ns"]
        for leaf, bids in ticket.plan:
            for bid in bids:
                self.gen_tokens_by_problem[ns] = \
                    self.gen_tokens_by_problem.get(ns, 0) + len(outs[bid])
                kids.append(self._add_child(ticket.tree, leaf, bid,
                                            outs[bid]))
        return kids

    def problem_gen_tokens(self, tree: SearchTree) -> int:
        ns = tree.node(0).payload["ns"]
        return self.gen_tokens_by_problem.get(ns, 0)

    def open_stream(self):
        return self.engine.open_stream(
            temperature=self.bcfg.temperature,
            stop_tokens=(self.bcfg.step_token, self.bcfg.eos_token))

    def stream_budget(self) -> int:
        return self.bcfg.max_step_tokens

    def expand_multi(self, reqs: Sequence[Tuple[SearchTree,
                                                Sequence[Tuple[int, int]]]]
                     ) -> List[List[int]]:
        """Branch every problem's live leaves, then decode the union of
        branches in ONE lock-step stream (chunked only past
        ``max_batch``)."""
        tickets = [self.expand_begin(tree, leaf_counts)
                   for tree, leaf_counts in reqs]
        all_branches = [b for t in tickets for b in t.branches]
        outs: Dict[int, List[int]] = {}
        if all_branches:
            row_keys = np.concatenate([t.row_keys for t in tickets
                                       if t.row_keys is not None])
            mb = self.engine.ecfg.max_batch
            for i in range(0, len(all_branches), mb):
                outs.update(self.engine.decode(
                    all_branches[i:i + mb], self.bcfg.max_step_tokens,
                    temperature=self.bcfg.temperature,
                    stop_tokens=(self.bcfg.step_token, self.bcfg.eos_token),
                    row_keys=row_keys[i:i + mb]))
        return [self.expand_finish(t, outs) for t in tickets]

    @torch.no_grad()
    def score(self, tree: SearchTree, node: int) -> float:
        sid = tree.node(node).payload["seq_id"]
        toks = self._put([self.engine.tokens[sid]])
        r = self.prm_model.reward(self.prm_params, {"tokens": toks})
        return float(r[0, -1])

    def score_many(self, tree: SearchTree,
                   nodes: Sequence[int]) -> List[float]:
        return self.score_multi([(tree, nodes)])[0]

    @tracing.span("prm")
    @torch.no_grad()
    def score_multi(self, reqs: Sequence[Tuple[SearchTree, Sequence[int]]]
                    ) -> List[List[float]]:
        """ONE padded-bucket PRM call covering every problem's
        candidates; per-row rewards are split back per request."""
        counts = [len(nodes) for _, nodes in reqs]
        seqs = [self.engine.tokens[tree.node(n).payload["seq_id"]]
                for tree, nodes in reqs for n in nodes]
        if not seqs:
            return [[] for _ in reqs]
        toks, pos, lengths = _pad_bucket(seqs)
        if tracing.on:
            tracing.annotate(rows=toks.shape[0], len=toks.shape[1])
            tracing.count("prm.slots", toks.size)
            tracing.count("prm.valid", sum(len(s) for s in seqs))
        r = self.prm_model.reward(self.prm_params,
                                  {"tokens": self._put(toks),
                                   "positions": self._put(pos)})
        idx = np.clip(lengths - 1, 0, toks.shape[1] - 1)
        r = r.cpu().numpy()[np.arange(len(seqs)), idx[:len(seqs)]]
        return _split_counts([float(x) for x in r], counts)

    @torch.no_grad()
    def embed(self, tree: SearchTree, node: int) -> np.ndarray:
        step = tree.node(node).payload["tokens"]
        if not step:
            return np.zeros(self.embed_model.cfg.d_model, np.float32)
        h = self.embed_model.hidden(self.embed_params,
                                    {"tokens": self._put([step])})
        return h[0].mean(dim=0).float().cpu().numpy()

    def embed_many(self, tree: SearchTree,
                   nodes: Sequence[int]) -> np.ndarray:
        return self.embed_multi([(tree, nodes)])[0]

    @tracing.span("embed")
    @torch.no_grad()
    def embed_multi(self, reqs: Sequence[Tuple[SearchTree, Sequence[int]]]
                    ) -> List[np.ndarray]:
        """ONE bucketed encoder call covering every problem's nodes;
        padding is masked out of the attention and of the mean pool."""
        d = self.embed_model.cfg.d_model
        counts = [len(nodes) for _, nodes in reqs]
        steps = [tree.node(n).payload["tokens"]
                 for tree, nodes in reqs for n in nodes]
        out = np.zeros((len(steps), d), np.float32)
        idx = [i for i, s in enumerate(steps) if s]
        if idx:
            toks, pos, _ = _pad_bucket([steps[i] for i in idx])
            pos_t = self._put(pos)
            h = self.embed_model.hidden(self.embed_params,
                                        {"tokens": self._put(toks),
                                         "positions": pos_t})
            mask = (pos_t >= 0).to(h.dtype)
            denom = torch.clamp(mask.sum(dim=1), min=1.0)
            h = (h * mask[:, :, None]).sum(dim=1) / denom[:, None]
            h = h.float().cpu().numpy()
            for row, i in enumerate(idx):
                out[i] = h[row]
        return np.split(out, np.cumsum(counts)[:-1])

    def answer(self, tree: SearchTree, leaf: int) -> Any:
        return tree.node(leaf).payload.get("answer")

    # -- lifecycle -----------------------------------------------------
    def on_step(self, tree: SearchTree, live: Sequence[int]) -> None:
        """Free engine sequences of pruned/finished leaves and book the
        step's attention IO.

        Only sweeps the owning problem's namespace: live leaves keep
        their sequences, pending start_many roots stay protected until
        branched, and other problems sharing the engine are untouched.
        Traced, the problem's ``step`` span closes here.
        """
        ns = tree.node(0).payload["ns"]
        keep = set(self._protected)
        for leaf in live:
            pl = tree.node(leaf).payload
            if pl and "seq_id" in pl:
                keep.add(pl["seq_id"])
        pool = self._ns_seqs.get(ns, set())
        for sid in sorted(pool - keep):
            if sid in self.engine.alloc.seqs:
                self.engine.free(sid)
            pool.discard(sid)
        # the engine's cumulative per-problem IO counters -> this step's
        # deltas (what its decode streamed for this problem)
        uniq = self.engine.unique_pages_streamed_by_ns.get(ns, 0)
        logical = self.engine.logical_pages_streamed_by_ns.get(ns, 0)
        last = self._last_io_ns.get(ns, (0, 0))
        self._last_io_ns[ns] = (uniq, logical)
        for key in (None, ns):
            io = self._io.setdefault(key, [0, 0, 0])
            io[0] += uniq - last[0]
            io[1] += logical - last[1]
            io[2] += 1
        if tracing.on:
            t = tracing.now()
            t0, k = self._step_open.get(ns, (None, 0))
            if t0 is not None:
                tracing.record("step", t0, t, ns=ns, step=k + 1)
            self._step_open[ns] = (t, k + 1)

    def io_summary(self, ns=None) -> Dict[str, float]:
        """Measured attention-IO over the closed steps: pages streamed
        per decode step and the realized sharing ratio."""
        uniq, logical, steps = self._io.get(ns, (0, 0, 0))
        steps = max(steps, 1)
        return {
            "unique_pages_streamed": uniq,
            "logical_pages_streamed": logical,
            "pages_streamed_per_step": uniq / steps,
            "io_sharing_ratio": logical / max(uniq, 1),
        }

    # -- memory pressure (the scheduler's admission/demotion protocol) --
    def _ns_stats(self, ns) -> Dict[str, int]:
        """This problem's page accounting, over its own live sequences."""
        return self.engine.alloc.ns_page_stats(
            ns, seq_ids=sorted(self._ns_seqs.get(ns, ())))

    def capacity(self) -> Dict[str, int]:
        """Pool capacity: total allocatable pages and currently free."""
        alloc = self.engine.alloc
        return {"total_pages": alloc.n_pages,
                "free_pages": len(alloc.free)}

    def prompt_pages(self, prompt_tokens: Sequence[int]) -> int:
        """Pages one prompt's prefill holds (``tokens[:-1]`` in pages,
        rounded up so the pending token's first append is covered)."""
        ps = self.engine.ecfg.page_size
        return max(-(-len(prompt_tokens) // ps), 1)

    def step_pages_per_branch(self) -> int:
        """Worst-case page growth of ONE branch over ONE search step: a
        CoW of the shared last page plus pages for the step's new
        tokens."""
        ps = self.engine.ecfg.page_size
        return 1 + -(-self.bcfg.max_step_tokens // ps)

    def problem_pages(self, tree: SearchTree) -> int:
        """Physical pages this problem holds right now."""
        ns = tree.node(0).payload["ns"]
        return self._ns_stats(ns).get("physical_pages", 0)

    def problem_swapped_pages(self, tree: SearchTree) -> int:
        """Pages this problem has parked in the host spill buffer."""
        ns = tree.node(0).payload["ns"]
        return self._ns_stats(ns).get("swapped_pages", 0)

    def swap_out_problem(self, tree: SearchTree,
                         need_pages: Optional[int] = None) -> int:
        """Demote one problem: spill its engine sequences' pages to the
        host buffer and release them (``engine.swap_out``).

        With ``need_pages`` set (subtree-grained spill), only enough
        sequences to release at least that many pages are demoted, so
        the shared prefix and the rest of the problem's KV stay in the
        pool.  The whole problem still parks.
        """
        ns = tree.node(0).payload["ns"]
        ids = sorted(self._ns_seqs.get(ns, ()))
        if need_pages is not None and ids:
            chosen = self._pick_spill_subset(ids, need_pages)
            if len(chosen) < len(ids):
                return self.engine.swap_out(chosen, partial=True)
        return self.engine.swap_out(ids)

    def _pick_spill_subset(self, ids: Sequence[int],
                           need_pages: int) -> List[int]:
        """Greedy subset for a partial demotion: repeatedly add the
        sequence that releases the most additional pages (pages whose
        every reference falls inside the chosen set), smallest seq id on
        ties, until ``need_pages`` pages free.  Deterministic given the
        allocator state."""
        alloc = self.engine.alloc
        chosen: List[int] = []
        in_set: Dict[int, int] = {}
        released = 0
        remaining = list(ids)
        while remaining and released < need_pages:
            best, best_gain = None, -1
            for s in remaining:
                gain = 0
                seen: Dict[int, int] = {}
                for pg in alloc.seqs[s].block_table:
                    seen[pg] = seen.get(pg, 0) + 1
                for pg, n in seen.items():
                    if in_set.get(pg, 0) + n == alloc.refcount[pg]:
                        gain += 1
                if gain > best_gain:
                    best, best_gain = s, gain
            chosen.append(best)
            remaining.remove(best)
            for pg in alloc.seqs[best].block_table:
                in_set[pg] = in_set.get(pg, 0) + 1
            released += best_gain
        return chosen

    def swap_in_problem(self, tree: SearchTree) -> int:
        """Restore a demoted problem's swapped sequences (exact copies:
        its decode streams resume bit-identically).  Raises
        ``OutOfPages`` and leaves the problem parked when the pool still
        lacks room."""
        ns = tree.node(0).payload["ns"]
        seqs = self.engine.alloc.seqs
        ids = [s for s in sorted(self._ns_seqs.get(ns, ()))
               if s in seqs and seqs[s].swapped]
        return self.engine.swap_in(ids)

    def finish_problem(self, tree: SearchTree) -> None:
        """Retire one problem: free whatever engine sequences its final
        step left behind and drop its per-problem key/sequence
        bookkeeping and the engine's per-ns IO counters.  Its IO sums
        are kept."""
        pl = tree.node(0).payload
        ns = pl.get("ns") if isinstance(pl, dict) else None
        if ns is None:        # not a tree this backend started
            return
        for sid in sorted(self._ns_seqs.pop(ns, set())):
            self._protected.discard(sid)
            if sid in self.engine.alloc.seqs:
                self.engine.free(sid)
        self._keys.pop(ns, None)
        self._last_io_ns.pop(ns, None)
        self._step_open.pop(ns, None)
        self.engine.unique_pages_streamed_by_ns.pop(ns, None)
        self.engine.logical_pages_streamed_by_ns.pop(ns, None)
