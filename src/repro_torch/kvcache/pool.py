"""Device-side paged KV pool (port of ``repro.kvcache.pool``).

Layout: ``k, v: (n_layers, n_pages, page_size, n_kv_heads, head_dim)``.
Unlike the reference's functional ``.at[]`` updates, writes and
copy-on-write copies here go **in place** into the pool tensors: the
engine owns the only reference, so no copy of the pool is ever needed.

Swap path (page demotion): ``gather_pages_async`` copies a set of pages
to host memory and ``scatter_pages`` writes host copies back into (any)
pool pages — the device half of the engine's swap-out / swap-in.  The
pool is written in place, so a gather first *snapshots* the pages into
fresh device tensors on the compute stream; only the snapshot is read
by the device-to-host copy, which runs on a side stream into pinned
host buffers.  A prefill that reuses the freed pages right after the
gather therefore cannot corrupt the spill.

``StatePool`` holds the recurrent families' constant-size state, one
page per live sequence, with the same in-place writes and the same
snapshot-then-side-stream swap path (``PendingStateGather``).

Also holds ``paged_attention_ref``, the plain PyTorch version of the
paged decode kernel (its CPU path and its oracle on the card).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .allocator import CopyOp, OutOfPages

NEG_INF = -1e30


def pow2_bucket(n: int, lo: int = 8) -> int:
    """Smallest power-of-two >= n (at least ``lo``) — the padding bucket.

    Host-built axes that vary across calls (prefill token/row counts,
    PRM batch/length, tree-step page counts) are padded to these buckets,
    so a run sees O(log max_size) distinct shapes.
    """
    b = lo
    while b < n:
        b *= 2
    return b


class PendingGather:
    """An in-flight page gather: device snapshot taken, host copy
    enqueued, not yet waited for.

    On a CUDA pool the snapshot's copy into pinned host buffers runs on
    a side stream between two ``events``; the snapshot tensors are
    handed to the caching allocator with ``record_stream``, so their
    memory is not reused before the copy has read them.  On the CPU the
    snapshot is the host copy and there are no events.  ``resolve``
    waits on the copy's end event only (never on the whole device) and
    is idempotent."""

    def __init__(self, host_k: torch.Tensor, host_v: torch.Tensor,
                 events: Optional[Tuple["torch.cuda.Event",
                                        "torch.cuda.Event"]] = None):
        self._host_t = (host_k, host_v)
        self._events = events           # (copy start, copy end)
        self._host: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def pending(self) -> bool:
        return self._host is None

    def resolve(self) -> Tuple[np.ndarray, np.ndarray]:
        """The gathered pages as host arrays, (L, n, S, K, hd) K and V."""
        if self._host is None:
            if self._events is not None:
                self._events[1].synchronize()
            k, v = self._host_t
            self._host = (k.numpy(), v.numpy())
        return self._host

    def copy_ms(self) -> Optional[float]:
        """Device time of the device-to-host copy, in ms, once resolved
        (None on the CPU)."""
        if self._events is None or self._host is None:
            return None
        return self._events[0].elapsed_time(self._events[1])


class KVPool:
    def __init__(self, n_layers: int, n_pages: int, page_size: int,
                 n_kv_heads: int, head_dim: int, *, dtype=torch.float32,
                 device):
        self.n_layers = n_layers
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
        self.shape = shape
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self._copy_stream = [None]   # side stream of swap-out copies

    def write_tokens(self, layer_k: torch.Tensor, layer_v: torch.Tensor,
                     pages: torch.Tensor, slots: torch.Tensor) -> None:
        """Write B new tokens across all layers, in place.

        layer_k/v: (L, B, K, hd) — per-layer K/V of the new tokens.
        pages, slots: (B,) physical page + in-page slot per token.
        """
        self.k[:, pages, slots] = layer_k.to(self.k.dtype)
        self.v[:, pages, slots] = layer_v.to(self.v.dtype)

    def copy_pages(self, ops: Sequence[CopyOp]) -> None:
        """Execute CoW copies (partial page duplication), in place."""
        if not ops:
            return
        dev = self.k.device
        src = torch.tensor([o.src_page for o in ops], device=dev)
        dst = torch.tensor([o.dst_page for o in ops], device=dev)
        # copying the whole page is safe: slots beyond n_valid are dead
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]

    # -- swap (device half of page demotion) ---------------------------
    def gather_pages(self, pages: Sequence[int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Copy the given pages to host: (L, n, S, K, hd) K and V."""
        return self.gather_pages_async(pages).resolve()

    def gather_pages_async(self, pages: Sequence[int]) -> PendingGather:
        """Snapshot the pages and start their copy to host memory
        without waiting for it.

        The snapshot (an index gather into fresh tensors) runs on the
        current stream, so the caller may release and reuse the source
        pages at once: later writes to the pool are ordered after it.
        On a CUDA pool the copy into pinned host buffers runs on a side
        stream that waits for the snapshot, overlapping whatever the
        compute stream does next.
        """
        dev = self.k.device
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=dev)
        snap_k = self.k[:, idx]
        snap_v = self.v[:, idx]
        if dev.type != "cuda":
            return PendingGather(snap_k, snap_v, None)
        host, events = _to_host_async({"k": snap_k, "v": snap_v}, dev,
                                      self._copy_stream)
        return PendingGather(host["k"], host["v"], events)

    def scatter_pages(self, pages: Sequence[int], host_k: np.ndarray,
                      host_v: np.ndarray) -> None:
        """Write host page copies back into the pool at ``pages``, in
        place, on the current stream.  host_k/v: (L, n, S, K, hd)."""
        n = len(pages)
        if n == 0:
            return
        assert host_k.shape[1] == n and host_v.shape[1] == n, \
            (host_k.shape, host_v.shape, n)
        dev = self.k.device
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=dev)
        self.k[:, idx] = torch.from_numpy(
            np.ascontiguousarray(host_k)).to(dev, self.k.dtype)
        self.v[:, idx] = torch.from_numpy(
            np.ascontiguousarray(host_v)).to(dev, self.v.dtype)

    def gather_kv(self, layer: int, block_table: Sequence[int],
                  length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Materialize a contiguous (length, K, hd) view (tests)."""
        S = self.page_size
        idx = (torch.as_tensor(np.asarray(block_table, np.int64),
                               device=self.k.device)[:, None] * S
               + torch.arange(S, device=self.k.device)[None, :]
               ).reshape(-1)[:length]
        flat_k = self.k[layer].reshape(-1, self.n_kv_heads, self.head_dim)
        flat_v = self.v[layer].reshape(-1, self.n_kv_heads, self.head_dim)
        return flat_k[idx], flat_v[idx]


def _to_host_async(snaps: dict, device, stream_holder: list):
    """Start copying device snapshots ``{name: tensor}`` into pinned host
    buffers on a side stream; returns (host tensors, events).  The side
    stream waits for the compute stream (the snapshots' producer), and
    each snapshot is handed to the caching allocator with
    ``record_stream`` so its memory outlives the copy."""
    compute = torch.cuda.current_stream(device)
    if stream_holder[0] is None:
        stream_holder[0] = torch.cuda.Stream(device)
    side = stream_holder[0]
    side.wait_stream(compute)
    host = {n: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for n, t in snaps.items()}
    events = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    with torch.cuda.stream(side):
        events[0].record(side)
        for n, t in snaps.items():
            host[n].copy_(t, non_blocking=True)
        events[1].record(side)
    for t in snaps.values():
        t.record_stream(side)
    return host, events


# ---------------------------------------------------------------------------
# Recurrent-state pages (mamba2 / rwkv6 / hybrid families)
# ---------------------------------------------------------------------------

class PendingStateGather:
    """An in-flight state-page gather (the StatePool twin of
    :class:`PendingGather`): device snapshot taken, copy into pinned
    host buffers enqueued on the side stream, not yet waited for."""

    def __init__(self, host: dict, events=None):
        self._host_t = host
        self._events = events           # (copy start, copy end)
        self._host: Optional[dict] = None

    @property
    def pending(self) -> bool:
        return self._host is None

    def resolve(self) -> dict:
        """``{name: (L, n, *per_page)}`` host arrays of the pages."""
        if self._host is None:
            if self._events is not None:
                self._events[1].synchronize()
            self._host = {n: t.numpy() for n, t in self._host_t.items()}
        return self._host

    def copy_ms(self) -> Optional[float]:
        if self._events is None or self._host is None:
            return None
        return self._events[0].elapsed_time(self._events[1])


class StatePool:
    """Constant-size recurrent state as a degenerate paged pool.

    Recurrent layers (mamba2 SSD, rwkv6 wkv) carry O(1) state per
    sequence instead of O(T) KV — exactly one page per sequence, so tree
    search's branch/prune/swap machinery works over these families with
    no new concepts: branch = copy the parent's page, prune = release,
    demote = gather to host + release, promote = alloc + scatter.

    Layout: one tensor per named state tensor, shaped ``(n_layers,
    n_pages, *per_page)``, written in place.  ``specs`` maps ``name ->
    (n_layers, per_page_shape, dtype)``; names are namespaced by the
    runtime that owns them (``"0:h"``, ``"0:conv"``, ...).

    The last page is the dump page: inactive decode rows read and write
    it, and it is never allocated.  Pages are zeroed at allocation — a
    fresh page is the empty-history state of every family, which is
    what lets a streamed prefill read its state from the pool on every
    segment, the first included.
    """

    def __init__(self, specs: dict, n_pages: int, *, device):
        if n_pages < 2:
            raise ValueError(f"a state pool needs >= 2 pages, got {n_pages}")
        self.specs = dict(specs)
        self.n_pages = n_pages
        self.dump_page = n_pages - 1
        self._free = list(range(n_pages - 1))
        self.peak_used = 0
        self.arrays = {
            name: torch.zeros((L, n_pages) + tuple(shape), dtype=dtype,
                              device=device)
            for name, (L, shape, dtype) in self.specs.items()}
        self._copy_stream = [None]   # side stream of swap-out copies

    @property
    def device(self):
        return next(iter(self.arrays.values())).device

    @property
    def page_bytes(self) -> int:
        """Bytes of one page across every state tensor."""
        return sum(a[:, 0].numel() * a.element_size()
                   for a in self.arrays.values())

    # -- page accounting -------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def alloc(self, n: int) -> list:
        """Allocate ``n`` zeroed pages (all-or-nothing)."""
        if n > len(self._free):
            raise OutOfPages(f"state pool exhausted: need {n} pages, "
                             f"{len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        self.zero(pages)
        self.peak_used = max(self.peak_used, self.used_pages)
        return pages

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 0 <= p < self.dump_page:
                raise ValueError(f"page {p} is not an allocatable page")
            self._free.append(p)

    def _idx(self, pages: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pages, np.int64),
                               device=self.device)

    # -- page ops (in place) ---------------------------------------------
    def zero(self, pages: Sequence[int]) -> None:
        if not len(pages):
            return
        idx = self._idx(pages)
        for a in self.arrays.values():
            a[:, idx] = 0

    def copy_page(self, src: int, dsts: Sequence[int]) -> None:
        """Copy-on-branch: duplicate ``src``'s state into each of ``dsts``."""
        if not len(dsts):
            return
        idx = self._idx(dsts)
        for a in self.arrays.values():
            a[:, idx] = a[:, src:src + 1]

    def gather_pages_async(self, pages: Sequence[int]) -> PendingStateGather:
        """Snapshot the pages (on the compute stream, so the caller may
        release and reuse them at once) and start their copy to pinned
        host memory on a side stream, as ``KVPool.gather_pages_async``."""
        idx = self._idx(pages)
        snaps = {n: a[:, idx] for n, a in self.arrays.items()}
        dev = self.device
        if dev.type != "cuda":
            return PendingStateGather(snaps, None)
        host, events = _to_host_async(snaps, dev, self._copy_stream)
        return PendingStateGather(host, events)

    def scatter_pages(self, pages: Sequence[int], host: dict) -> None:
        """Write host state-page copies back into the pool at ``pages``."""
        n = len(pages)
        if n == 0:
            return
        idx = self._idx(pages)
        for name, arr in host.items():
            if arr.shape[1] != n:
                raise ValueError(f"{name}: {arr.shape[1]} pages for {n} "
                                 f"targets")
            a = self.arrays[name]
            a[:, idx] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                a.device, a.dtype)


# ---------------------------------------------------------------------------
# Plain paged attention — oracle and CPU path of kernels/csrc/paged_attention
# ---------------------------------------------------------------------------

def paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                        scale: float) -> torch.Tensor:
    """Decode attention over a paged pool.

    q            : (B, H, hd)       one query token per sequence
    k_pool/v_pool: (P, S, K, hd)    single layer's pool
    block_tables : (B, T) int32     padded with -1
    lengths      : (B,) int32       context length per sequence
    Returns (B, H, hd).

    A row with no valid slots (all-(-1) table / zero length — an inactive
    batch row) returns zeros via masked normalization rather than a
    softmax over an empty set.
    """
    B, H, hd = q.shape
    P, S, K, _ = k_pool.shape
    T = block_tables.shape[1]
    G = H // K
    dev = q.device
    flat_k = k_pool.reshape(P * S, K, hd)
    flat_v = v_pool.reshape(P * S, K, hd)
    bt = block_tables.long()
    safe = torch.clamp(bt, min=0)
    idx = (safe[:, :, None] * S
           + torch.arange(S, device=dev)[None, None, :]).reshape(B, T * S)
    kk = flat_k[idx]                                    # (B, T*S, K, hd)
    vv = flat_v[idx]
    valid = (torch.arange(T * S, device=dev)[None, :]
             < lengths.long()[:, None]) \
        & (bt[:, :, None] >= 0).expand(B, T, S).reshape(B, T * S)
    qg = q.reshape(B, K, G, hd)
    scores = torch.einsum("bkgh,bckh->bkgc", qg.float(), kk.float()) * scale
    vb = valid[:, None, None]
    scores = torch.where(vb, scores, torch.tensor(NEG_INF, device=dev))
    m = scores.amax(dim=-1, keepdim=True)
    probs = torch.where(vb, torch.exp(scores - m), 0.0)
    probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgc,bckh->bkgh", probs, vv.float())
    return out.reshape(B, H, hd).to(q.dtype)
