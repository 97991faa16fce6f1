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
Decode runs at the configuration's compute dtype, as prefill does: a
bfloat16 configuration's projections, FFNs and head take bf16 operands
(fp32 accumulation), where the reference decodes in float32; a float32
configuration decodes as the reference does.  The pool is float32
either way: queries are cast to it at the attention seam and the
attention's output back to the queries' dtype.

Prompts whose context is longer than ``EngineConfig.prefill_chunk_tokens``
prefill in page-streamed segments (``_prefill_streamed``): peak
activation memory is one segment, not the whole prompt.  Under memory
pressure ``swap_out`` demotes a problem's pages to a host spill buffer
(pinned memory on a card) and ``swap_in`` restores them into fresh
pages; decode then resumes bit-identically.

Recurrent families (mamba2, rwkv6, the hybrid zamba2) keep their
constant-size state in a second pool (``kvcache.StatePool``), one page
per live sequence: prefill writes the post-prompt state, decode reads
and writes it in place, ``branch`` copies the parent's page,
``free`` releases it and ``swap_out``/``swap_in`` spill and restore it
with the KV pages.  Admission is all-or-nothing across both pools.

Prefill path (``EngineConfig.prefill``): ``"flash"`` (default) runs
the flash-prefill kernel seam per layer; ``"dense"`` is the reference's
one-shot oracle, plain masked attention over the bucket
(``make_mask`` + ``masked_attention``), with K/V written to the pool the
same way.

Every engine decodes through one :class:`DecodeRunner`, over static
operand buffers.  On a card without a mesh the forward (``_decode_step``,
the embedding lookup to the masked logits) runs as one CUDA graph replay
per iteration, captured once per shape key at its first use: the host no
longer enqueues its kernels one by one.  On the CPU, on a mesh and on the
expert-parallel MoE path the same forward runs eagerly.

``EngineConfig.mesh`` (a ``DeviceMesh`` from ``launch.mesh``) places the
pool by the serve policy (``launch.sharding.pool_spec``: pages on
``model``), commits the per-row operands batch -> ``data``
(``engine_batch_spec``) and the block tables and tree metadata
replicated, each as a DTensor over the engine's local tensors; every
divisibility fallback lands in ``shard_fallbacks``.  A 1-device mesh is
the equivalence oracle: the mesh-less engine's math on the same bits.
The kernels are per device (``kernels.ops.check_mesh_compat`` refuses a
larger mesh on the card), and the plain path does not partition a
larger mesh either: that raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..kernels import ops
from ..kvcache import KVPool, PageAllocator, StatePool
from ..kvcache.allocator import OutOfPages
from ..kvcache.pool import PendingGather, PendingStateGather, pow2_bucket
from ..models import moe as MOE
from .runtimes import (DecodeCtx, PrefillCtx, build_runtimes,
                       collect_state_specs, total_kv_layers)
from .sampler import as_keys, sample_tokens_rowwise, split, split_rows
from .sampler import key as prng_key


@dataclass
class EngineConfig:
    n_pages: int = 512
    page_size: int = 16
    max_batch: int = 64
    max_seq_len: int = 512
    attention: str = "paged"       # "paged" | "tree" (see module doc)
    prefill: str = "flash"         # "flash" | "dense" (dense = oracle)
    trace_logits: bool = False     # keep per-step logits (tests only)
    # prompts longer than this many tokens prefill in page-streamed
    # segments instead of one bucket (None = always one bucket)
    prefill_chunk_tokens: Optional[int] = None
    # recurrent-state pages (mamba2/rwkv6/hybrid families): one page per
    # live sequence, the last page is the dump target.  None = n_pages.
    # A page holds every recurrent layer's state (zamba2-7b: 148.5 MiB in
    # float32), so large models set this well below n_pages.
    n_state_pages: Optional[int] = None
    # DeviceMesh of the serve layout (launch.mesh.make_host_mesh): the
    # pool's page axis on "model", per-row operands batch -> "data",
    # block tables and tree metadata replicated.  None keeps the
    # single-device engine; a 1-device mesh is the equivalence oracle.
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.attention not in ("paged", "tree"):
            raise ValueError(
                f"EngineConfig.attention must be 'paged' or 'tree', got "
                f"{self.attention!r}")
        if self.prefill not in ("flash", "dense"):
            raise ValueError(
                f"EngineConfig.prefill must be 'flash' or 'dense', got "
                f"{self.prefill!r}")
        if self.prefill_chunk_tokens is not None:
            if self.prefill == "dense":
                raise ValueError(
                    "prefill='dense' is the one-shot equivalence oracle and "
                    "cannot stream long prompts in segments — drop "
                    "prefill_chunk_tokens or use prefill='flash'")
            if self.prefill_chunk_tokens < self.page_size:
                raise ValueError(
                    f"prefill_chunk_tokens={self.prefill_chunk_tokens} is "
                    f"smaller than page_size={self.page_size}: a streamed "
                    f"segment must cover at least one pool page")
        if self.n_state_pages is not None and self.n_state_pages < 2:
            raise ValueError(
                f"n_state_pages={self.n_state_pages} must be >= 2 (one live "
                f"page plus the dump page)")


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
        self.runtimes = build_runtimes(model,
                                       dense=ecfg.prefill == "dense")
        self.n_kv_layers = total_kv_layers(self.runtimes)
        # attention-free models keep a zero-layer pool: the page axes
        # stay (block tables drive token bookkeeping), the tensors hold
        # no bytes; head dims are clamped to 1 to keep the shape valid
        self.pool = KVPool(self.n_kv_layers, ecfg.n_pages, ecfg.page_size,
                           max(cfg.n_kv_heads, 1), max(cfg.head_dim, 1),
                           dtype=torch.float32, device=self.device)
        # mesh layout (EngineConfig.mesh): every divisibility fallback
        # the serve policy takes lands in shard_fallbacks
        self.mesh = ecfg.mesh
        self.shard_fallbacks: list = []
        self._row_plc: Dict[tuple, tuple] = {}
        if self.mesh is not None:
            self._place_pool()
        self.scale = cfg.head_dim ** -0.5 if cfg.head_dim else 1.0
        # recurrent-state pool (None for attention-only stacks)
        state_specs = collect_state_specs(self.runtimes)
        self.state: Optional[StatePool] = None
        self.state_of: Dict[int, int] = {}    # seq_id -> state page
        if state_specs:
            self.state = StatePool(state_specs,
                                   ecfg.n_state_pages or ecfg.n_pages,
                                   device=self.device)
        self.tokens: Dict[int, List[int]] = {}   # full token history
        self.max_pages_per_seq = -(-ecfg.max_seq_len // ecfg.page_size)
        # throughput accounting: decode streams opened, lock-step
        # iterations run, tokens produced; prefill streams and tokens
        self.n_decode_calls = 0
        self.n_decode_steps = 0
        self.n_decoded_tokens = 0
        self.n_prefill_calls = 0
        self.n_prefill_tokens = 0
        # swap accounting (page demotion under memory pressure): pages
        # moved device->host and host->device, and the calls that moved
        # them.  Pages out minus pages dropped while parked minus pages
        # in == pages still in the spill buffer.
        self.swapped_out_pages = 0
        self.swapped_in_pages = 0
        self.n_swap_outs = 0
        self.n_swap_ins = 0
        # pages copied on write when a decode step appends to a shared
        # last page
        self.n_cow_pages = 0
        # ns -> [(stale page ids, PendingGather)]: the spill buffer a
        # demoted problem's pages wait in until swap-in.  A list because
        # a partial swap_out may spill one namespace in several waves.
        self._spill: Dict[int, List[Tuple[List[int], PendingGather]]] = {}
        # ns -> [(seq_ids, PendingStateGather)]: the state-page twin of
        # the KV spill buffer (recurrent families; empty otherwise)
        self._state_spill: Dict[
            int, List[Tuple[List[int], PendingStateGather]]] = {}
        # FIFO of not-yet-resolved gathers: at most _spill_buffers host
        # copies stay un-waited-for, so demotion overlaps decode
        self._pending_spills: List[object] = []
        self._spill_buffers = 2
        # per-step attention IO: pages the attention streams (unique —
        # tree mode dedups shared prefixes) vs the per-leaf total a paged
        # read pattern costs, globally and per problem namespace
        self.unique_pages_streamed = 0
        self.logical_pages_streamed = 0
        self.unique_pages_streamed_by_ns: Dict[int, int] = {}
        self.logical_pages_streamed_by_ns: Dict[int, int] = {}
        self.logits_trace: List[np.ndarray] = []   # if ecfg.trace_logits
        # decode iterations replayed from a captured graph, and the
        # captures (one per shape key); both stay 0 where it runs eagerly
        self.n_decode_graph_replays = 0
        self.n_decode_graph_captures = 0
        self.runner = DecodeRunner.for_engine(self.device, self.mesh)
        tracing.watch(self)

    def _put(self, arr) -> torch.Tensor:
        """A host-built operand on the engine's device."""
        return torch.as_tensor(np.asarray(arr), device=self.device)

    # ------------------------------------------------------------------
    # Mesh placement
    # ------------------------------------------------------------------
    def _place_pool(self) -> None:
        from ..launch.sharding import placements, pool_spec
        mesh = self.mesh
        ops.check_mesh_compat(mesh, use_kernel=self.device.type == "cuda")
        if mesh.size() > 1:
            raise NotImplementedError(
                f"a {mesh.size()}-device mesh on the plain path: the "
                f"engine's in-place pool writes have no DTensor partition "
                f"(ROADMAP.md, \"A PagedEngine over more than one rank\"); "
                f"use a 1-device mesh")
        if mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"engine on {self.device}")
        spec = pool_spec(mesh, tuple(self.pool.k.shape),
                         record=self.shard_fallbacks)
        self.pool_placements = placements(mesh, spec)
        self.pool_dtensors = tuple(
            self._commit(t, self.pool_placements)
            for t in (self.pool.k, self.pool.v))

    def _commit(self, t: torch.Tensor, plc):
        """``t`` as this rank's shard of a DTensor laid out by ``plc``."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, plc, run_check=False)

    def _put_rows(self, arr) -> torch.Tensor:
        """A batch-leading host operand (tokens, lengths, write pages /
        slots, active mask) committed batch -> ``data``; the placement
        is kept per shape, so a fallback is recorded once per shape.
        Without a mesh, ``_put``."""
        t = self._put(arr)
        if self.mesh is None:
            return t
        plc = self._row_plc.get(t.shape)
        if plc is None:
            from ..launch.sharding import engine_batch_spec, placements
            plc = self._row_plc[t.shape] = placements(
                self.mesh, engine_batch_spec(self.mesh, tuple(t.shape),
                                             record=self.shard_fallbacks))
        return self._commit(t, plc).to_local()

    def _put_repl(self, arr) -> torch.Tensor:
        """A host operand that indexes the whole pool (block tables, the
        tree step's page lists, bitmaps and lengths), committed
        replicated."""
        t = self._put(arr)
        if self.mesh is None:
            return t
        from torch.distributed.tensor import Replicate
        return self._commit(t, (Replicate(),) * self.mesh.ndim).to_local()

    def _state_row_ids(self, seq_ids, n_rows: int) -> np.ndarray:
        """(n_rows,) state page per row: the dump page for padding rows
        and for attention-only stacks (whose steps get an empty state
        dict, so the indices are then inert)."""
        dump = self.state.dump_page if self.state is not None else 0
        srows = np.full(n_rows, dump, np.int64)
        for r, sid in enumerate(seq_ids):
            if sid is not None and sid in self.state_of:
                srows[r] = self.state_of[sid]
        return srows

    def _state_rows(self, seq_ids, n_rows: int) -> torch.Tensor:
        """``_state_row_ids`` on the device."""
        return self._put_rows(self._state_row_ids(seq_ids, n_rows))

    def _state_in(self) -> dict:
        return self.state.arrays if self.state is not None else {}

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
    def _rope_positions(self, positions):
        """The rope positions of a text prefill: ``positions`` (B,T), or
        for M-RoPE the same positions broadcast to the three streams
        (equal streams are exactly plain RoPE; the engine serves text
        only, as the reference's does)."""
        if self.cfg.mrope_sections:
            return positions.expand(3, *positions.shape)
        return positions

    @torch.no_grad()
    def _prefill_step(self, tokens, positions, pages, slots, lengths,
                      srows):
        """One lock-step prefill over a right-padded prompt bucket.

        tokens/positions/pages/slots (B,T), positions -1 at padded
        slots; lengths (B,) valid tokens per row (0 = padding row);
        srows (B,) state page per row.  Each attention layer writes its
        K/V into the pool pages before attention; recurrent layers run
        the masked scan and write each row's post-prompt state into its
        state page.  Returns the rows' last-token logits (zeros for
        padding rows).
        """
        B, T = tokens.shape
        pos = self._rope_positions(positions)
        x, _ = self.model.embed_inputs(self.params, {"tokens": tokens,
                                                     "positions": pos})
        ctx = PrefillCtx(positions=positions, pos=pos, pages=pages,
                         slots=slots, lengths=lengths, state_rows=srows)
        for rt in self.runtimes:
            x = rt.prefill_into_pool(self.params, x, ctx, self.pool.k,
                                     self.pool.v, self._state_in())
        idx = torch.clamp(lengths.long() - 1, 0, T - 1)
        logits = self.model.logits(self.params,
                                   x[torch.arange(B, device=x.device), idx])
        return torch.where((lengths > 0)[:, None], logits, 0.0)

    @torch.no_grad()
    def _streamed_step(self, tokens, positions, pages, slots, length: int,
                       hist_table, hist_len: int, srows):
        """One segment of a page-streamed long-prompt prefill.

        tokens/positions/pages/slots (1,Ts): the segment, right padded
        (positions -1, pages -> dump page); ``length`` valid segment
        tokens; hist_table (1,Tp) the prompt's block table (pow2
        padded); ``hist_len`` tokens already in the pool.  Each layer
        writes the segment's K/V into the pool, then attends causally
        within the segment and over the history gathered through the
        block table.  Recurrent layers continue the scan from the
        state page ``srows`` (1,) and write it back.  Returns the
        segment's last-token logits (1, V).
        """
        pos = self._rope_positions(positions)
        x, _ = self.model.embed_inputs(self.params, {"tokens": tokens,
                                                     "positions": pos})
        lengths = torch.full((tokens.shape[0],), length, dtype=torch.int32,
                             device=tokens.device)
        ctx = PrefillCtx(positions=positions, pos=pos, pages=pages,
                         slots=slots, lengths=lengths, hist_table=hist_table,
                         hist_len=hist_len, state_rows=srows)
        for rt in self.runtimes:
            x = rt.prefill_streamed(self.params, x, ctx, self.pool.k,
                                    self.pool.v, self._state_in())
        return self.model.logits(self.params, x[:, length - 1])

    @torch.no_grad()
    def _decode_step(self, tokens, lengths, pages, slots, active, srows,
                     attend):
        """Shared body of one lock-step decode over the runtime stack.

        tokens (B,) previous tokens; lengths (B,) context length
        (position of the new token); pages/slots (B,) KV write targets;
        srows (B,) state pages.
        ``attend(kv_layer, q, pool_k, pool_v) -> (B, H, hd)`` is the only
        thing the two attention modes disagree on.
        """
        # the rows first, then their cast: no copy of the whole table
        x = self.params["embed"][tokens].to(self.model.compute_dtype)
        x = x[:, None]                                      # (B,1,d)
        ctx = DecodeCtx(lengths=lengths, pages=pages, slots=slots,
                        attend=attend, state_rows=srows)
        for rt in self.runtimes:
            x = rt.decode_step(self.params, x, ctx, self.pool.k, self.pool.v,
                               self._state_in())
        logits = self.model.logits(self.params, x[:, 0])
        return torch.where(active[:, None], logits, 0.0)

    def _attend(self, attn: dict, lengths):
        """The attention of one decode iteration from its device
        operands: tree mode's ``page_list``, ``page_mask``,
        ``page_lens`` and ``n_live``, paged mode's ``block_tables``."""
        if self.ecfg.attention == "tree":
            return self._tree_attend(attn["page_list"], attn["page_mask"],
                                     attn["page_lens"], attn["n_live"])
        return self._paged_attend(attn["block_tables"], lengths)

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
        ``n_live``, the count of live entries (they lead the page list),
        is a (1,) int32 tensor on the device: the kernel covers the
        page-list bucket and reads it (``ops.tree_attention``)."""
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
        # all-or-nothing across both pools: check the state pool before
        # the allocator commits KV pages, allocate state pages after
        self._check_state_room(len(ctxs))
        handles = self.alloc.new_seqs([len(c) for c in ctxs], ns=ns)
        if self.state is not None:
            for h, pg in zip(handles, self.state.alloc(len(handles))):
                self.state_of[h.seq_id] = pg       # zeroed at alloc
        for h, t in zip(handles, all_toks):
            self.tokens[h.seq_id] = t
        pct = self.ecfg.prefill_chunk_tokens
        streamed = [i for i, c in enumerate(ctxs)
                    if pct is not None and len(c) > pct]
        rest = [i for i in range(len(handles)) if i not in streamed]
        mb = self.ecfg.max_batch
        for j in range(0, len(rest), mb):
            part = rest[j:j + mb]
            self._prefill_chunk([handles[i] for i in part],
                                [ctxs[i] for i in part])
        for i in streamed:
            self._prefill_streamed(handles[i], ctxs[i])
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
        srows = self._state_rows([h.seq_id for h in handles], Bp)
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
            self._put_rows(tok).long(), self._put_rows(pos),
            self._put_rows(pages).long(),
            self._put_rows(slots).long(), self._put_rows(lens), srows)
        if self.ecfg.trace_logits:
            self.logits_trace.append(logits.float().cpu().numpy())

    def _prefill_streamed(self, h, ctx) -> None:
        """Page-streamed prefill of ONE long prompt.

        The context runs in sequential segments of at most
        ``prefill_chunk_tokens`` tokens, one engine call each: a
        segment's K/V go into the pool, then its queries attend
        causally within the segment and over the prompt's earlier
        pages, gathered through the block table.  Segment lengths and
        the history table are power-of-two bucketed, as in the
        reference.  The last segment's last-token logits match the
        one-shot path (same pending-token contract).
        """
        n = len(ctx)
        ps = self.ecfg.page_size
        pct = self.ecfg.prefill_chunk_tokens
        Tp = pow2_bucket(len(h.block_table), lo=1)
        tbl = np.zeros((1, Tp), np.int64)
        tbl[0, :len(h.block_table)] = h.block_table
        tbl_t = self._put_repl(tbl)
        srows = self._state_rows([h.seq_id], 1)
        for s0 in range(0, n, pct):
            s1 = min(s0 + pct, n)
            m = s1 - s0
            Ts = pow2_bucket(m, lo=1)
            tok = np.zeros((1, Ts), np.int64)
            pos = np.full((1, Ts), -1, np.int32)
            pages = np.full((1, Ts), self.dump_page, np.int64)
            slots = np.zeros((1, Ts), np.int64)
            idx = np.arange(s0, s1)
            tok[0, :m] = ctx[s0:s1]
            pos[0, :m] = idx
            pages[0, :m] = tbl[0, idx // ps]
            slots[0, :m] = idx % ps
            self.n_prefill_calls += 1
            self.n_prefill_tokens += m
            logits = self._streamed_step(
                self._put_rows(tok), self._put_rows(pos),
                self._put_rows(pages),
                self._put_rows(slots), m, tbl_t, s0, srows)
        if self.ecfg.trace_logits:
            self.logits_trace.append(logits.float().cpu().numpy())

    def _check_state_room(self, n: int) -> None:
        if self.state is not None and n > self.state.n_free:
            raise OutOfPages(f"state pool exhausted: need {n} pages, "
                             f"{self.state.n_free} free")

    def branch(self, seq_id: int, n: int) -> List[int]:
        self._check_state_room(n)
        handles = self.alloc.branch(seq_id, n)
        for b in handles:
            self.tokens[b.seq_id] = list(self.tokens[seq_id])
        if self.state is not None:
            # recurrent state has no prefix sharing: every branch copies
            # the parent's constant-size page at once
            pages = self.state.alloc(len(handles))
            self.state.copy_page(self.state_of[seq_id], pages)
            for b, pg in zip(handles, pages):
                self.state_of[b.seq_id] = pg
        return [b.seq_id for b in handles]

    def free(self, seq_id: int) -> None:
        h = self.alloc.seqs.get(seq_id)
        ns = h.ns if h is not None else None
        was_swapped = h.swapped if h is not None else False
        self.alloc.free_seq(seq_id)
        self.tokens.pop(seq_id, None)
        pg = self.state_of.pop(seq_id, None)
        if pg is not None:
            self.state.release([pg])
        # last swapped sequence of a parked namespace gone -> its spill
        # can never be swapped back in; drop the host copy
        if was_swapped and ns not in self.alloc.swapped:
            self._drop_spill(ns)

    # ------------------------------------------------------------------
    # Swap: page demotion to a host spill buffer (memory pressure)
    # ------------------------------------------------------------------
    def swap_out(self, seq_ids: Sequence[int], *,
                 partial: bool = False) -> int:
        """Demote sequences: spill their exclusive pages to host, free
        them.

        Default: ``seq_ids`` is every live sequence of one namespace.
        With ``partial=True`` any subset of one namespace works — only
        the subset-exclusive pages travel; shared-prefix pages stay in
        the pool (subtree-grained spill).  The pages are snapshotted
        *before* the allocator releases them (the pool is written in
        place, so the snapshot is what keeps the spill safe from the
        next prefill into those pages); the host copy is waited for
        only when the double buffer forces it or swap-in needs it.
        Returns the number of pages spilled.
        """
        ids = list(seq_ids)
        if not ids:
            return 0
        ns = self.alloc.seqs[ids[0]].ns
        if not partial and ns in self._spill:
            raise ValueError(f"namespace {ns} is already swapped out")
        pages = self.alloc.exclusive_pages(ids)
        gather = self.pool.gather_pages_async(pages)
        released = self.alloc.swap_out_seqs(ids, partial=partial)
        assert released == pages, (released, pages)
        self._spill.setdefault(ns, []).append((pages, gather))
        self._pending_spills.append(gather)
        if self.state is not None:
            # state pages are per-sequence exclusive: spill one page per
            # demoted id and free it alongside the KV pages
            spages = [self.state_of.pop(i) for i in ids]
            sgather = self.state.gather_pages_async(spages)
            self.state.release(spages)
            self._state_spill.setdefault(ns, []).append((ids, sgather))
            self._pending_spills.append(sgather)
        while len(self._pending_spills) > self._spill_buffers:
            self._pending_spills.pop(0).resolve()
        self.swapped_out_pages += len(pages)
        self.n_swap_outs += 1
        return len(pages)

    def swap_in(self, seq_ids: Sequence[int]) -> int:
        """Restore a demoted problem's pages from the spill buffer.

        Allocates fresh physical pages (all-or-nothing; raises
        ``OutOfPages`` leaving everything parked when the pool lacks
        room), writes the spilled K/V into them — waiting for any
        still-pending host copy first — and rewrites the block tables.
        Every spill segment of the namespace restores in one call.
        Restored pages are exact copies, so decode resumes
        bit-identically.  Returns the number of pages restored.
        """
        ids = list(seq_ids)
        if not ids:
            return 0
        ns = self.alloc.seqs[ids[0]].ns
        segments = self._spill.get(ns, [])
        idset = set(ids)
        # all-or-nothing across both pools: refuse before the KV restore
        # so everything stays parked
        self._check_state_room(sum(
            sum(1 for sid in seg_ids if sid in idset)
            for seg_ids, _ in self._state_spill.get(ns, [])))
        mapping = self.alloc.swap_in_seqs(ids)     # may raise OutOfPages
        restored = 0
        for pages, gather in segments:
            host_k, host_v = gather.resolve()
            # sequences freed while parked may have dropped spill pages
            rows = [i for i, pg in enumerate(pages) if pg in mapping]
            if len(rows) < len(pages):
                host_k, host_v = host_k[:, rows], host_v[:, rows]
            if rows:
                self.pool.scatter_pages([mapping[pages[i]] for i in rows],
                                        host_k, host_v)
            restored += len(rows)
        for seg_ids, sgather in self._state_spill.get(ns, []):
            host = sgather.resolve()
            rows = [j for j, sid in enumerate(seg_ids) if sid in idset]
            if len(rows) < len(seg_ids):
                host = {k: a[:, rows] for k, a in host.items()}
            if rows:
                npages = self.state.alloc(len(rows))
                self.state.scatter_pages(npages, host)
                for pg, j in zip(npages, rows):
                    self.state_of[seg_ids[j]] = pg
        self._drop_spill(ns)
        self.swapped_in_pages += restored
        self.n_swap_ins += 1
        return restored

    def _drop_spill(self, ns: Optional[int]) -> None:
        """Forget a namespace's spill segments (restored or orphaned)
        and take their gathers out of the pending FIFO."""
        for _, gather in self._spill.pop(ns, []) \
                + self._state_spill.pop(ns, []):
            if gather in self._pending_spills:
                self._pending_spills.remove(gather)

    def reset(self) -> None:
        """Free every live sequence and the spill buffer; keeps the
        pool.  Cumulative throughput/IO counters are kept
        (``reset_counters`` zeroes them)."""
        for sid in list(self.alloc.seqs):
            self.free(sid)
        self._spill.clear()
        self._state_spill.clear()
        self._pending_spills.clear()
        self.logits_trace.clear()

    def reset_counters(self) -> None:
        """Zero the throughput, swap and attention-IO counters."""
        self.n_decode_calls = 0
        self.n_decode_steps = 0
        self.n_decoded_tokens = 0
        self.n_prefill_calls = 0
        self.n_prefill_tokens = 0
        self.swapped_out_pages = 0
        self.swapped_in_pages = 0
        self.n_swap_outs = 0
        self.n_swap_ins = 0
        self.n_cow_pages = 0
        self.unique_pages_streamed = 0
        self.logical_pages_streamed = 0
        self.unique_pages_streamed_by_ns.clear()
        self.logical_pages_streamed_by_ns.clear()
        self.n_decode_graph_replays = 0
        self.n_decode_graph_captures = 0

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
               row_keys: Optional[np.ndarray] = None
               ) -> Dict[int, List[int]]:
        """Decode up to n_tokens for each sequence, lock-step batched.

        Stops a sequence early when a stop token is emitted (the stop
        token is included in the returned step).  Returns new tokens per
        seq_id.  Sampling is row-keyed (``sampler``): callers pass
        ``row_keys`` ((n, 2) uint32 threefry keys, one per sequence) or
        an int seed ``key``, and row j then starts from ``fold_in(
        key(seed), j)`` — the reference's ``split(key(seed), n)[j]``.
        """
        ids = list(seq_ids)
        if len(ids) > self.ecfg.max_batch:
            raise ValueError(f"{len(ids)} sequences exceed max_batch="
                             f"{self.ecfg.max_batch}")
        if row_keys is None:
            if key is None:
                raise ValueError("pass key or row_keys")
            row_keys = split(prng_key(key), len(ids))
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
    boundary.  Each seated row carries its own threefry key chain, split
    once per iteration it is live (next ``fold_in(k, 0)``, sample with
    ``fold_in(k, 1)``) as in the reference; a free slot carries no key
    and is never sampled.  So a row's sampled stream depends only on its
    own key, its own logits and its stop history.  A greedy stream
    (temperature <= 0) reads no key and leaves the chains as they are.
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
        self._key: Dict[int, np.ndarray] = {}
        self.out: Dict[int, List[int]] = {}
        # traced: ns -> [first row's seat stamp, rows seated and unfinished]
        self._ns_rows: Dict[int, list] = {}

    @property
    def live(self) -> List[int]:
        """Sequences currently decoding, in slot order."""
        return [i for i in self._slot_seq if i is not None]

    @property
    def n_free(self) -> int:
        return sum(1 for s in self._slot_seq if s is None)

    def add(self, seq_ids: Sequence[int], row_keys, n_tokens: int) -> None:
        """Seat sequences into free slots (lowest index first), each with
        its own sampling key (``row_keys`` (n, 2) uint32) and a per-row
        budget of ``n_tokens``."""
        ids = list(seq_ids)
        row_keys = as_keys(row_keys)
        if row_keys.shape != (len(ids), 2):
            raise ValueError(f"keys of shape {row_keys.shape} for "
                             f"{len(ids)} rows (want (n, 2))")
        free = [j for j, s in enumerate(self._slot_seq) if s is None]
        if len(ids) > len(free):
            raise ValueError(f"{len(ids)} rows, {len(free)} free slots")
        for j, i, k in zip(free, ids, row_keys):
            if i in self._slot_of:
                raise ValueError(f"sequence {i} is already streaming")
            self._slot_seq[j] = i
            self._slot_of[i] = j
            self._budget[i] = int(n_tokens)
            self._key[i] = k
            self.out[i] = []
        if tracing.on:
            t = tracing.now()
            for i in ids:
                ns = self.engine.alloc.seqs[i].ns
                self._ns_rows.setdefault(ns, [t, 0])[1] += 1

    def _rows_finished(self, seq_ids: Sequence[int]) -> None:
        """Traced: close a problem's ``step.rows`` span when its last
        seated row finishes."""
        t = tracing.now()
        for i in seq_ids:
            ns = self.engine.alloc.seqs[i].ns
            o = self._ns_rows.get(ns)
            if o is None:           # seated before tracing was on
                continue
            o[1] -= 1
            if o[1] == 0:
                del self._ns_rows[ns]
                tracing.record("step.rows", o[0], t, ns=ns)

    def _free_slot(self, i: int) -> None:
        j = self._slot_of.pop(i)
        self._slot_seq[j] = None
        self._budget.pop(i, None)
        self._key.pop(i, None)

    @tracing.span("decode")
    def step(self) -> List[int]:
        """Run ONE lock-step iteration over the occupied slots.

        Returns the sequences that stopped this iteration (stop token,
        per-row budget, or max_seq_len) — their slots are free for
        ``add()`` before the next iteration.  Traced, its phases are the
        ``decode`` span's laps, in order.
        """
        eng = self.engine
        ecfg = eng.ecfg
        tree_mode = ecfg.attention == "tree"
        live = self.live
        if not live:
            return []
        tr = tracing.on
        if tr:
            tracing.annotate(rows=len(live))
        eng.n_decode_steps += 1
        # reserve one slot per live sequence (may CoW)
        copy_ops = []
        for i in live:
            copy_ops += eng.alloc.append_tokens(i, 1)
        eng.pool.copy_pages(copy_ops)
        eng.n_cow_pages += len(copy_ops)
        if tr:
            tracing.lap("decode.alloc")

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
        if tr:
            tracing.lap("decode.rows")

        if tree_mode:
            meta = eng.alloc.tree_metadata(rows, pad_page=eng.dump_page)
            if tr:
                tracing.lap("decode.meta")
            eng._count_streamed_pages(live, meta.n_unique, meta.n_logical)
        else:
            n_logical = sum(len(eng.alloc.seqs[i].block_table) for i in live)
            eng._count_streamed_pages(live, n_logical, n_logical)
        if tr:
            tracing.lap("decode.count")
        # the row grid's operands, in _decode_step's order
        host_rows = {"tokens": tok, "lengths": lens, "pages": pages,
                     "slots": slots, "active": act,
                     "state_rows": eng._state_row_ids(rows, B)}
        if tree_mode:
            attn = {"page_list": meta.page_list,
                    "page_mask": meta.page_mask,
                    "page_lens": meta.page_lens,
                    "n_live": np.array([meta.n_unique], np.int32)}
        else:
            attn = {"block_tables": bt}
        runner = eng.runner
        key = runner.put(eng, host_rows, attn)
        if tr:
            tracing.lap("decode.put")
        logits = runner.run(eng, key)
        if tr:
            # the dtype the stream ends in (the logits keep it): the
            # compute dtype, or float32 where float32 params promote it
            tracing.annotate(graph=int(runner.graphed),
                             dtype=str(logits.dtype).removeprefix("torch."))
            tracing.lap("decode.forward")
        if ecfg.trace_logits:
            eng.logits_trace.append(logits.float().cpu().numpy())
        # tokens of the occupied rows, on the device (B tokens come back,
        # not B x V logits)
        occ = [j for j, i in enumerate(rows) if i is not None]
        if self.temperature <= 0:       # greedy: the keys are never read
            new = sample_tokens_rowwise(None, logits, 0.0)[occ]
        else:
            # advance every live row's chain once; sample with the subkey
            nxt, sub = split_rows(np.stack([self._key[rows[j]]
                                            for j in occ]))
            for j, k in zip(occ, nxt):
                self._key[rows[j]] = k
            if len(occ) < B:
                logits = logits[eng._put(np.asarray(occ, np.int64))]
            new = sample_tokens_rowwise(sub, logits, self.temperature)
        if tr:
            tracing.lap("decode.sample")
        finished: List[int] = []
        for t, j in zip(new, occ):
            i = rows[j]
            t = int(t)
            eng.tokens[i].append(t)
            self.out[i].append(t)
            eng.n_decoded_tokens += 1
            self._budget[i] -= 1
            if t in self.stop or len(eng.tokens[i]) >= ecfg.max_seq_len \
                    or self._budget[i] <= 0:
                finished.append(i)
        if tr:
            self._rows_finished(finished)
        for i in finished:
            self._free_slot(i)
        if tr:
            tracing.lap("decode.book")
        return finished


class DecodeRunner:
    """The decode forward (``PagedEngine._decode_step``) over static
    operand buffers, run eagerly or replayed from one captured graph per
    shape key.

    Rows are always the ``max_batch`` grid (inactive rows write to the
    dump page), so the key is the shapes of the attention operands: the
    page-list bucket N in tree mode (``tree_metadata`` pads it to a power
    of two, so a few keys serve a run), one key in paged mode (the block
    table is ``max_pages_per_seq`` wide).  The row grid's buffers serve
    every key, the attention operands' (tree mode's live count too) one
    key each.  A buffer is made once, from a copy of its first host array,
    through the engine's placement (``_put_rows`` / ``_put_repl``);
    ``put`` overwrites every entry, pad entries included, so nothing of
    an earlier, larger tree survives.

    ``capture(fn) -> replay`` records ``fn``, which reads only the static
    buffers, without running it; ``replay()`` runs the record and
    returns its output (rewritten by the key's next replay).  Without a
    capture, or while ``moe.MESH`` is set (the expert-parallel MoE's
    collectives), ``run`` runs the forward eagerly; otherwise it captures
    a key after the key's first, eager run (through the capture's
    ``warm`` where it has one) and replays it from then on, raising each
    kernel's ``launches`` and, traced, each count by what the captured
    forward raised (``tracing.collect``).  ``for_engine`` captures CUDA
    graphs on a card without a mesh; a test may pass a stand-in.
    """

    def __init__(self, capture=None):
        self.capture = capture
        self.rows: Dict[str, torch.Tensor] = {}
        self._keys: Dict[tuple, dict] = {}

    @classmethod
    def for_engine(cls, device, mesh) -> "DecodeRunner":
        on_card = device.type == "cuda" and mesh is None
        return cls(CudaGraphCapture(device) if on_card else None)

    @property
    def graphed(self) -> bool:
        """Whether ``run`` captures and replays the forward."""
        return self.capture is not None and MOE.MESH is None

    @staticmethod
    def _write(bufs: Dict[str, torch.Tensor], host: dict, place) -> None:
        for k, a in host.items():
            if k in bufs:
                bufs[k].copy_(torch.from_numpy(np.ascontiguousarray(a)))
            else:
                bufs[k] = place(np.array(a))

    def put(self, engine, rows: dict, attn: dict) -> tuple:
        """Write one iteration's host operands into the static buffers;
        returns the key to ``run``."""
        self._write(self.rows, rows, engine._put_rows)
        key = tuple((k, a.shape) for k, a in attn.items())
        entry = self._keys.setdefault(key, {"attn": {}, "replay": None})
        self._write(entry["attn"], attn, engine._put_repl)
        return key

    def run(self, engine, key: tuple) -> torch.Tensor:
        """The masked logits (B, V) of the operands ``put`` last wrote.
        The engine is passed, not kept, so the graphs and their memory
        pool are freed with it."""
        entry = self._keys[key]

        def forward():
            return engine._decode_step(
                *self.rows.values(),
                engine._attend(entry["attn"], self.rows["lengths"]))

        if not self.graphed:
            return forward()
        if entry["replay"] is None:
            return self._first(engine, entry, forward)
        out = entry["replay"]()
        for k, n in entry["launches"]:
            k.launches += n
        if tracing.on:
            for name, n in entry["counts"]:
                tracing.count(name, n)
        engine.n_decode_graph_replays += 1
        return out

    def _first(self, engine, entry: dict, forward) -> torch.Tensor:
        """A key's first use: its forward runs eagerly, then is
        captured (which runs nothing, so nothing is counted twice)."""
        warm = getattr(self.capture, "warm", None)
        out = forward() if warm is None else warm(forward)
        before = [k.launches for k in ops.KERNELS]
        with tracing.collect() as counts:
            entry["replay"] = self.capture(forward)
        entry["launches"] = [(k, k.launches - n)
                             for k, n in zip(ops.KERNELS, before)]
        for k, n in zip(ops.KERNELS, before):
            k.launches = n
        entry["counts"] = counts
        engine.n_decode_graph_captures += 1
        return out


class CudaGraphCapture:
    """``capture(fn) -> replay`` as a CUDA graph on ``device``: every
    graph allocates from one memory pool and is captured on one side
    stream, where ``warm`` runs a key's eager first forward; replays run
    one at a time on the engine's stream."""

    def __init__(self, device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def warm(self, fn) -> torch.Tensor:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        out.record_stream(cur)
        return out

    def __call__(self, fn):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()

        def replay():
            g.replay()
            return out
        return replay
