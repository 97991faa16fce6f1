"""Paged decode engine: step-synchronous batched decode with tree
branching (port of ``repro.serving.engine``).

  * a static paged KV pool (``kvcache.KVPool``) shared by every live
    branch, written in place;
  * ``prefill_many(prompts)`` — flash-prefill a batch of prompts in one
    lock-step stream, writing KV straight into the pool's pages;
  * ``branch(seq, n)`` — fork block tables (refcount++, CoW last page);
  * ``decode(seq_ids, …)`` — one lock-step step at a time over all live
    branches, on top of :class:`DecodeStream`;
  * free / stats — physical vs logical page accounting and the per-step
    attention-IO counters (``unique_pages_streamed`` vs
    ``logical_pages_streamed``, also split per problem namespace).

Pending-token invariant: after ``prefill(tokens)`` the pool holds KV for
``tokens[:-1]`` and the *last* token is pending — the next decode step
computes its KV (at its reserved slot) together with the next-token
logits.  Every token's KV is written exactly once, by whichever step
consumes it as input, and branching at any point forks a consistent
cache.

Prompts are right-padded into power-of-two (rows, tokens) buckets;
padded token slots carry position -1 and write to the dump page
(``n_pages - 1``), and right padding under the causal mask keeps them
out of every valid query's scores.

Two attention modes for decode (``EngineConfig.attention``):

  * ``"paged"`` — per-sequence paged attention over block tables; a page
    shared by k descendant leaves is streamed k times per step.
  * ``"tree"``  — tree attention over the step's unique live pages
    (DeFT-style): each shared prefix page is streamed once per leaf
    tile, masked by a per-page descendant bitmap.

Attention goes through ``kernels/ops.py``: on a CUDA device the
hand-written kernels run, on the CPU their plain PyTorch versions.
Decode runs in float32 and the pool is float32, as in the reference.

Not in this slice (raise ``NotImplementedError``): streamed long-prompt
prefill, swap (page demotion), recurrent-state pools, meshes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kvcache import KVPool, PageAllocator
from ..kvcache.pool import pow2_bucket
from .runtimes import DecodeCtx, PrefillCtx, build_runtimes, total_kv_layers
from .sampler import RowKey, sample_tokens_rowwise


@dataclass
class EngineConfig:
    n_pages: int = 512
    page_size: int = 16
    max_batch: int = 64
    max_seq_len: int = 512
    attention: str = "paged"       # "paged" | "tree" (see module doc)
    trace_logits: bool = False     # keep per-step logits (tests only)
    # streamed long-prompt prefill: a later slice (must stay None)
    prefill_chunk_tokens: Optional[int] = None

    def __post_init__(self):
        if self.attention not in ("paged", "tree"):
            raise ValueError(
                f"EngineConfig.attention must be 'paged' or 'tree', got "
                f"{self.attention!r}")
        if self.prefill_chunk_tokens is not None:
            if self.prefill_chunk_tokens < self.page_size:
                raise ValueError(
                    f"prefill_chunk_tokens={self.prefill_chunk_tokens} is "
                    f"smaller than page_size={self.page_size}: a streamed "
                    f"segment must cover at least one pool page")
            raise NotImplementedError("streamed prefill: later slice")


class PagedEngine:
    def __init__(self, model, params, ecfg: EngineConfig, *, device=None):
        cfg = model.cfg
        if not cfg.supports_decode:
            raise ValueError(
                f"{cfg.name} ({cfg.arch_type}) has no decode path — the "
                f"paged engine serves autoregressive models only")
        if ecfg.attention == "tree" and cfg.is_attention_free:
            raise ValueError(
                f"attention='tree' dedups shared KV pages, but {cfg.name} "
                f"is attention-free (recurrent-only) — use "
                f"attention='paged'")
        if cfg.sliding_window and ecfg.max_seq_len > cfg.sliding_window:
            raise ValueError(
                f"max_seq_len={ecfg.max_seq_len} exceeds {cfg.name}'s "
                f"sliding_window={cfg.sliding_window}: the paged decode "
                f"path keeps every page live and applies no window "
                f"masking, so windowed models must fit inside the window")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.model = model
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        # last physical page is the dump target for padded batch rows
        self.dump_page = ecfg.n_pages - 1
        self.alloc = PageAllocator(ecfg.n_pages - 1, ecfg.page_size)
        self.runtimes = build_runtimes(model)
        self.n_kv_layers = total_kv_layers(self.runtimes)
        self.pool = KVPool(self.n_kv_layers, ecfg.n_pages, ecfg.page_size,
                           cfg.n_kv_heads, cfg.head_dim, dtype=torch.float32,
                           device=self.device)
        self.scale = cfg.head_dim ** -0.5
        self.tokens: Dict[int, List[int]] = {}   # full token history
        self.max_pages_per_seq = -(-ecfg.max_seq_len // ecfg.page_size)
        # throughput accounting: decode streams opened, lock-step
        # iterations run, tokens produced; prefill streams and tokens
        self.n_decode_calls = 0
        self.n_decode_steps = 0
        self.n_decoded_tokens = 0
        self.n_prefill_calls = 0
        self.n_prefill_tokens = 0
        # per-step attention IO: pages the attention streams (unique —
        # tree mode dedups shared prefixes) vs the per-leaf total a paged
        # read pattern costs, globally and per problem namespace
        self.unique_pages_streamed = 0
        self.logical_pages_streamed = 0
        self.unique_pages_streamed_by_ns: Dict[int, int] = {}
        self.logical_pages_streamed_by_ns: Dict[int, int] = {}
        self.logits_trace: List[np.ndarray] = []   # if ecfg.trace_logits

    def _put(self, arr) -> torch.Tensor:
        """A host-built operand on the engine's device."""
        return torch.as_tensor(np.asarray(arr), device=self.device)

    # ------------------------------------------------------------------
    # Stats
    # ------------------------------------------------------------------
    def kv_stats(self) -> Dict[str, int]:
        return {
            "physical_pages": self.alloc.used_pages,
            "logical_pages": self.alloc.logical_pages,
            "shared_pages": self.alloc.shared_pages(),
            "swapped_pages": self.alloc.swapped_pages,
            "unique_pages_streamed": self.unique_pages_streamed,
            "logical_pages_streamed": self.logical_pages_streamed,
        }

    # ------------------------------------------------------------------
    # Model steps
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _prefill_step(self, tokens, positions, pages, slots, lengths):
        """One lock-step prefill over a right-padded prompt bucket.

        tokens/positions/pages/slots (B,T), positions -1 at padded
        slots; lengths (B,) valid tokens per row (0 = padding row).
        Each layer writes its K/V into the pool pages before attention.
        Returns the rows' last-token logits (zeros for padding rows).
        """
        B, T = tokens.shape
        x, _ = self.model.embed_inputs(self.params, {"tokens": tokens,
                                                     "positions": positions})
        ctx = PrefillCtx(positions=positions, pages=pages, slots=slots,
                         lengths=lengths)
        for rt in self.runtimes:
            x = rt.prefill_into_pool(self.params, x, ctx, self.pool.k,
                                     self.pool.v)
        idx = torch.clamp(lengths.long() - 1, 0, T - 1)
        logits = self.model.logits(self.params,
                                   x[torch.arange(B, device=x.device), idx])
        return torch.where((lengths > 0)[:, None], logits, 0.0)

    @torch.no_grad()
    def _decode_step(self, tokens, lengths, pages, slots, active, attend):
        """Shared body of one lock-step decode over the runtime stack.

        tokens (B,) previous tokens; lengths (B,) context length
        (position of the new token); pages/slots (B,) KV write targets.
        ``attend(kv_layer, q, pool_k, pool_v) -> (B, H, hd)`` is the only
        thing the two attention modes disagree on.
        """
        x = self.params["embed"].float()[tokens][:, None]   # (B,1,d)
        ctx = DecodeCtx(lengths=lengths, pages=pages, slots=slots,
                        attend=attend)
        for rt in self.runtimes:
            x = rt.decode_step(self.params, x, ctx, self.pool.k, self.pool.v)
        logits = self.model.logits(self.params, x[:, 0])
        return torch.where(active[:, None], logits, 0.0)

    def _paged_attend(self, block_tables, lengths):
        """Paged decode: each row attends over its own block table."""
        lens1 = (lengths + 1).to(torch.int32)

        def attend(l, q, pk, pv):
            return ops.paged_attention(q, pk[l], pv[l], block_tables, lens1,
                                       scale=self.scale)
        return attend

    def _tree_attend(self, page_list, page_mask, page_lens, n_live):
        """Tree decode: attention walks the unique live pages of the
        whole tree; a shared prefix page is streamed once per kv head.
        ``n_live`` (the host-known count of live entries, which lead the
        page list) trims the kernel's grid."""
        def attend(l, q, pk, pv):
            return ops.tree_attention(q, pk[l], pv[l], page_list, page_mask,
                                      page_lens, scale=self.scale,
                                      n_live=n_live)
        return attend

    # ------------------------------------------------------------------
    # Public host API
    # ------------------------------------------------------------------
    def prefill(self, tokens: Sequence[int]) -> int:
        """Run one prompt; returns seq_id.  See ``prefill_many``."""
        return self.prefill_many([tokens])[0]

    def prefill_many(self, prompts: Sequence[Sequence[int]],
                     ns: Optional[Sequence[int]] = None) -> List[int]:
        """Ingest a batch of prompts in one lock-step prefill stream.

        Pages for all prompts are allocated in one ``new_seqs`` pass
        (all-or-nothing), then the batch is right-padded into a
        power-of-two (rows, tokens) bucket and prefilled, each layer's
        KV written straight into the pool pages.  Batches larger than
        ``max_batch`` are chunked.  Returns seq_ids in prompt order.
        The pool holds KV for each prompt's ``tokens[:-1]``; the last
        token is pending (see the module docstring).
        """
        all_toks = [[int(t) for t in p] for p in prompts]
        if not all(all_toks):
            raise ValueError("empty prompt")
        if any(len(t) > self.ecfg.max_seq_len for t in all_toks):
            raise ValueError("prompt exceeds max_seq_len")
        ctxs = [t[:-1] for t in all_toks]
        handles = self.alloc.new_seqs([len(c) for c in ctxs], ns=ns)
        for h, t in zip(handles, all_toks):
            self.tokens[h.seq_id] = t
        mb = self.ecfg.max_batch
        for j in range(0, len(handles), mb):
            self._prefill_chunk(handles[j:j + mb], ctxs[j:j + mb])
        return [h.seq_id for h in handles]

    def _prefill_chunk(self, handles, ctxs) -> None:
        """One prefill stream over <= max_batch prompts."""
        if not any(ctxs):
            return                 # single-token prompts: nothing to write
        ps = self.ecfg.page_size
        T = pow2_bucket(max(len(c) for c in ctxs))
        Bp = pow2_bucket(len(ctxs), lo=1)
        tok = np.zeros((Bp, T), np.int32)
        pos = np.full((Bp, T), -1, np.int32)
        pages = np.full((Bp, T), self.dump_page, np.int32)
        slots = np.zeros((Bp, T), np.int32)
        lens = np.zeros(Bp, np.int32)
        n_tokens = 0
        for r, (h, ctx) in enumerate(zip(handles, ctxs)):
            n = len(ctx)
            if not n:
                continue
            tok[r, :n] = ctx
            pos[r, :n] = np.arange(n)
            pages[r, :n] = np.repeat(h.block_table, ps)[:n]
            slots[r, :n] = np.tile(np.arange(ps), len(h.block_table))[:n]
            lens[r] = n
            n_tokens += n
        self.n_prefill_calls += 1
        self.n_prefill_tokens += n_tokens
        logits = self._prefill_step(
            self._put(tok).long(), self._put(pos), self._put(pages).long(),
            self._put(slots).long(), self._put(lens))
        if self.ecfg.trace_logits:
            self.logits_trace.append(logits.cpu().numpy())

    def branch(self, seq_id: int, n: int) -> List[int]:
        handles = self.alloc.branch(seq_id, n)
        for b in handles:
            self.tokens[b.seq_id] = list(self.tokens[seq_id])
        return [b.seq_id for b in handles]

    def free(self, seq_id: int) -> None:
        self.alloc.free_seq(seq_id)
        self.tokens.pop(seq_id, None)

    def swap_out(self, seq_ids: Sequence[int], *, partial: bool = False):
        raise NotImplementedError("swap: later slice")

    def swap_in(self, seq_ids: Sequence[int]):
        raise NotImplementedError("swap: later slice")

    def reset(self) -> None:
        """Free every live sequence; keeps the pool.  Cumulative
        throughput/IO counters are kept (``reset_counters`` zeroes
        them)."""
        for sid in list(self.alloc.seqs):
            self.free(sid)
        self.logits_trace.clear()

    def reset_counters(self) -> None:
        """Zero the throughput and attention-IO counters."""
        self.n_decode_calls = 0
        self.n_decode_steps = 0
        self.n_decoded_tokens = 0
        self.n_prefill_calls = 0
        self.n_prefill_tokens = 0
        self.unique_pages_streamed = 0
        self.logical_pages_streamed = 0
        self.unique_pages_streamed_by_ns.clear()
        self.logical_pages_streamed_by_ns.clear()

    # ------------------------------------------------------------------
    def _count_streamed_pages(self, live: Sequence[int],
                              n_unique: int, n_logical: int) -> None:
        """Book one decode iteration's attention IO, globally and per
        problem namespace.  Namespaces hold disjoint pages (branching
        never crosses them), so per-ns unique counts sum to the global
        unique count in tree mode too."""
        self.unique_pages_streamed += n_unique
        self.logical_pages_streamed += n_logical
        handles = [self.alloc.seqs[i] for i in live]
        uniq_ns = self.unique_pages_streamed_by_ns
        log_ns = self.logical_pages_streamed_by_ns
        if len({h.ns for h in handles}) == 1:
            # one namespace: the global counts ARE this namespace's
            ns = handles[0].ns
            uniq_ns[ns] = uniq_ns.get(ns, 0) + n_unique
            log_ns[ns] = log_ns.get(ns, 0) + n_logical
            return
        tree_mode = self.ecfg.attention == "tree"
        pages_by_ns: Dict[int, set] = {}
        for h in handles:
            npg = len(h.block_table)
            log_ns[h.ns] = log_ns.get(h.ns, 0) + npg
            if tree_mode:
                pages_by_ns.setdefault(h.ns, set()).update(h.block_table)
            else:
                # paged reads stream every page of every row
                uniq_ns[h.ns] = uniq_ns.get(h.ns, 0) + npg
        for ns, pages in pages_by_ns.items():
            uniq_ns[ns] = uniq_ns.get(ns, 0) + len(pages)

    def open_stream(self, temperature: float = 1.0,
                    stop_tokens: Sequence[int] = ()) -> "DecodeStream":
        """Open a persistent row-refillable decode stream."""
        return DecodeStream(self, temperature=temperature,
                            stop_tokens=stop_tokens)

    def decode(self, seq_ids: Sequence[int], n_tokens: int,
               key: Optional[int] = None, temperature: float = 1.0,
               stop_tokens: Sequence[int] = (),
               row_keys: Optional[Sequence[RowKey]] = None
               ) -> Dict[int, List[int]]:
        """Decode up to n_tokens for each sequence, lock-step batched.

        Stops a sequence early when a stop token is emitted (the stop
        token is included in the returned step).  Returns new tokens per
        seq_id.  Sampling is row-keyed: callers pass ``row_keys`` (one
        key tuple per sequence) or a single int ``key`` that becomes
        ``(key, row index)`` per row.
        """
        ids = list(seq_ids)
        if len(ids) > self.ecfg.max_batch:
            raise ValueError(f"{len(ids)} sequences exceed max_batch="
                             f"{self.ecfg.max_batch}")
        if row_keys is None:
            if key is None:
                raise ValueError("pass key or row_keys")
            row_keys = [(int(key), j) for j in range(len(ids))]
        self.n_decode_calls += 1
        if n_tokens <= 0:
            return {i: [] for i in ids}
        stream = DecodeStream(self, temperature=temperature,
                              stop_tokens=stop_tokens)
        stream.add(ids, row_keys, n_tokens)
        while stream.live:
            stream.step()
        return {i: stream.out[i] for i in ids}


class DecodeStream:
    """Persistent row-refillable lock-step decode over one engine.

    Sequences occupy slots of the static ``max_batch`` row grid;
    ``step()`` runs ONE lock-step iteration over the occupied slots and
    ``add()`` may seat new sequences into free slots at any iteration
    boundary.  A row's sampled stream depends only on its own key (its
    ``add()`` key plus the count of iterations it has been live), its
    own logits and its stop history.
    """

    def __init__(self, engine: PagedEngine, *, temperature: float = 1.0,
                 stop_tokens: Sequence[int] = ()):
        self.engine = engine
        self.temperature = temperature
        self.stop = set(int(s) for s in stop_tokens)
        B = engine.ecfg.max_batch
        self._slot_seq: List[Optional[int]] = [None] * B
        self._slot_of: Dict[int, int] = {}
        self._budget: Dict[int, int] = {}
        self._key: Dict[int, RowKey] = {}
        self._iters: Dict[int, int] = {}
        self.out: Dict[int, List[int]] = {}

    @property
    def live(self) -> List[int]:
        """Sequences currently decoding, in slot order."""
        return [i for i in self._slot_seq if i is not None]

    @property
    def n_free(self) -> int:
        return sum(1 for s in self._slot_seq if s is None)

    def add(self, seq_ids: Sequence[int], row_keys: Sequence[RowKey],
            n_tokens: int) -> None:
        """Seat sequences into free slots (lowest index first), each with
        its own sampling key and a per-row budget of ``n_tokens``."""
        ids = list(seq_ids)
        if len(row_keys) != len(ids):
            raise ValueError(f"{len(row_keys)} keys for {len(ids)} rows")
        free = [j for j, s in enumerate(self._slot_seq) if s is None]
        if len(ids) > len(free):
            raise ValueError(f"{len(ids)} rows, {len(free)} free slots")
        for j, i, key in zip(free, ids, row_keys):
            if i in self._slot_of:
                raise ValueError(f"sequence {i} is already streaming")
            self._slot_seq[j] = i
            self._slot_of[i] = j
            self._budget[i] = int(n_tokens)
            self._key[i] = tuple(int(x) for x in key)
            self._iters[i] = 0
            self.out[i] = []

    def _free_slot(self, i: int) -> None:
        j = self._slot_of.pop(i)
        self._slot_seq[j] = None
        self._budget.pop(i, None)
        self._key.pop(i, None)
        self._iters.pop(i, None)

    def step(self) -> List[int]:
        """Run ONE lock-step iteration over the occupied slots.

        Returns the sequences that stopped this iteration (stop token,
        per-row budget, or max_seq_len) — their slots are free for
        ``add()`` before the next iteration.
        """
        eng = self.engine
        ecfg = eng.ecfg
        tree_mode = ecfg.attention == "tree"
        live = self.live
        if not live:
            return []
        eng.n_decode_steps += 1
        # reserve one slot per live sequence (may CoW)
        copy_ops = []
        for i in live:
            copy_ops += eng.alloc.append_tokens(i, 1)
        eng.pool.copy_pages(copy_ops)

        B = ecfg.max_batch
        T = eng.max_pages_per_seq
        tok = np.zeros(B, np.int64)
        bt = None if tree_mode else np.full((B, T), -1, np.int32)
        lens = np.zeros(B, np.int32)
        pages = np.full(B, eng.dump_page, np.int64)   # inactive -> dump
        slots = np.zeros(B, np.int64)
        act = np.zeros(B, bool)
        rows: List[Optional[int]] = [None] * B
        for j, i in enumerate(self._slot_seq):
            if i is None:
                continue
            h = eng.alloc.seqs[i]
            tok[j] = eng.tokens[i][-1]
            if not tree_mode:
                bt[j, :len(h.block_table)] = h.block_table
            pos = h.length - 1              # slot reserved for the new token
            lens[j] = pos
            pages[j] = h.block_table[pos // ecfg.page_size]
            slots[j] = pos % ecfg.page_size
            act[j] = True
            rows[j] = i

        lens_t = eng._put(lens)
        if tree_mode:
            meta = eng.alloc.tree_metadata(rows, pad_page=eng.dump_page)
            eng._count_streamed_pages(live, meta.n_unique, meta.n_logical)
            attend = eng._tree_attend(eng._put(meta.page_list),
                                      eng._put(meta.page_mask),
                                      eng._put(meta.page_lens),
                                      meta.n_unique)
        else:
            n_logical = sum(len(eng.alloc.seqs[i].block_table) for i in live)
            eng._count_streamed_pages(live, n_logical, n_logical)
            attend = eng._paged_attend(eng._put(bt), lens_t)
        logits = eng._decode_step(eng._put(tok), lens_t, eng._put(pages),
                                  eng._put(slots), eng._put(act), attend)
        if ecfg.trace_logits:
            eng.logits_trace.append(logits.cpu().numpy())
        keys = [None if i is None else self._key[i] + (self._iters[i],)
                for i in self._slot_seq]
        new = sample_tokens_rowwise(keys, logits, self.temperature)
        finished: List[int] = []
        for j, i in enumerate(self._slot_seq):
            if i is None:
                continue
            t = int(new[j])
            self._iters[i] += 1
            eng.tokens[i].append(t)
            self.out[i].append(t)
            eng.n_decoded_tokens += 1
            self._budget[i] -= 1
            if t in self.stop or len(eng.tokens[i]) >= ecfg.max_seq_len \
                    or self._budget[i] <= 0:
                finished.append(i)
        for i in finished:
            self._free_slot(i)
        return finished
