"""Spans and counters inside the port, on the profiler's clock.

Off by default.  Off, a call site costs one test of the module flag
``on``: it takes no timestamp, keeps no record and launches no device
work.  ``enable()`` turns it on; ``reset()`` drops what was recorded and
starts the counters from zero; ``snapshot()`` returns what was recorded
since.

  * ``span(name, **attrs)`` — a context manager, also a decorator —
    records one :class:`Span` when it closes; its parent is the span
    open on the thread when it opened.  Inside an open span, ``lap(name)``
    records one phase of it as a child span, from its previous lap (or
    its start) to now, and ``annotate(**attrs)`` adds attributes to it.
    ``record(name, start_ns, end_ns, **attrs)`` keeps a span whose two
    stamps the caller took (one problem's search step opens in one tick
    and closes in another).  Where one problem owns the work, its
    namespace is ``attrs["ns"]``.
  * ``count(name, n=1)`` raises a counter.  ``n`` may be a device
    tensor: the counter is then summed on the device, and read once, by
    ``snapshot()``.  Inside ``collect()`` the counts go to its list
    instead, on or off: a captured forward's, which each of its replays
    raises again.

``snapshot()`` also reads the counters the program keeps anyway: those
of every live ``PagedEngine`` (``watch``), and each CUDA kernel's
launches, as differences from their values at ``reset()``.

Stamps are ``time.time_ns()``, the wall clock in nanoseconds.
``torch.profiler``'s kineto events carry the same clock (on torch 2.13,
CPU activity, an ``aten::mm`` event lies inside a ``time.time_ns()``
pair taken around the call; ``tests/test_torch_tracing.py`` holds this),
so the device operations that ran, or the device's idle gaps, can be
put inside the host spans open meanwhile.  A span never synchronises
the device: around a call that enqueues device work it ends when the
enqueue does.  The calls whose host code waits for the device's result
(the sampler's, the PRM's and the embedder's copies to the host) hold
that wait inside their spans.

At most ``CAP`` spans are kept; later ones are dropped and counted in
``snapshot()["dropped"]``.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
import weakref
from types import MappingProxyType
from typing import Any, Dict, List, NamedTuple, Optional

CAP = 1_000_000

on = False

now = time.time_ns

# counters read from each watched engine: (name, engine attribute)
ENGINE_COUNTERS = (
    ("decode.iters", "n_decode_steps"),
    ("decode.tokens", "n_decoded_tokens"),
    ("kv.unique_pages_streamed", "unique_pages_streamed"),
    ("kv.logical_pages_streamed", "logical_pages_streamed"),
    ("kv.cow_pages", "n_cow_pages"),
    ("kv.swap_outs", "n_swap_outs"),
    ("decode.graph_replays", "n_decode_graph_replays"),
    ("decode.graph_captures", "n_decode_graph_captures"),
)


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    attrs: Any


_NO_ATTRS = MappingProxyType({})
_spans: List[Span] = []
_counts: Dict[str, Any] = {}
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_engines: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_launch_base: Dict[str, int] = {}
_sink: Optional[list] = None


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def reset() -> None:
    """Drop every kept span and counter; engine counters and kernel
    launches count from here on.  Spans open now are kept when they
    close."""
    global _dropped
    _spans.clear()
    _counts.clear()
    _dropped = 0
    for eng in list(_engines):
        _engines[eng] = _engine_counts(eng)
    _launch_base.clear()
    _launch_base.update(_launches())


def watch(engine) -> None:
    """Read ``engine``'s counters (``ENGINE_COUNTERS``) in every
    snapshot while it lives."""
    _engines[engine] = {}


def _engine_counts(eng) -> Dict[str, int]:
    return {name: getattr(eng, attr, 0) for name, attr in ENGINE_COUNTERS}


def _launches() -> Dict[str, int]:
    from .kernels import ops
    return {k.name: k.launches for k in ops.KERNELS}


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _keep(s: Span) -> None:
    global _dropped
    if len(_spans) < CAP:
        _spans.append(s)
    else:
        _dropped += 1


def _open(name: str, attrs: dict) -> list:
    st = _stack()
    t = now()
    # [id, parent, name, start, last lap, attrs]
    s = [next(_ids), st[-1][0] if st else None, name, t, t, attrs]
    st.append(s)
    return s


def _close(s: list) -> None:
    t = now()
    _stack().pop()          # the innermost open span closes first
    _keep(Span(s[0], s[1], s[2], s[3], t, s[5]))


class span:
    """``with span(name, **attrs):`` or ``@span(name, **attrs)``; whether
    it records is decided each time it opens."""

    __slots__ = ("name", "attrs", "_s")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._s = None

    def __enter__(self):
        if on:
            self._s = _open(self.name, dict(self.attrs))
        return self

    def __exit__(self, *exc) -> bool:
        if self._s is not None:
            _close(self._s)
            self._s = None
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def traced(*a, **k):
            if not on:
                return fn(*a, **k)
            s = _open(name, dict(attrs))
            try:
                return fn(*a, **k)
            finally:
                _close(s)
        return traced


def lap(name: str) -> None:
    """Record the innermost open span's phase that ends now."""
    st = _stack()
    if not st:
        return
    s = st[-1]
    t = now()
    _keep(Span(next(_ids), s[0], name, s[4], t, _NO_ATTRS))
    s[4] = t


def annotate(**attrs) -> None:
    """Add attributes to the innermost open span."""
    st = _stack()
    if st:
        st[-1][5].update(attrs)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Keep a span stamped by the caller (no parent)."""
    if on:
        _keep(Span(next(_ids), None, name, start_ns, end_ns, attrs))


def count(name: str, n=1) -> None:
    if _sink is not None:
        _sink.append((name, n))
    elif on:
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def collect():
    """Keep the ``(name, n)`` of every ``count`` inside in the list this
    yields, and add none of them.  ``on`` reads true meanwhile, so every
    count site fires: the counts of a forward being captured into a
    graph, where a device ``n`` is the graph's own output, rewritten by
    each replay."""
    global on, _sink
    was, _sink = on, []
    on = True
    try:
        yield _sink
    finally:
        on, _sink = was, None


def snapshot() -> Dict[str, Any]:
    """The spans kept and the counters since ``reset()``; device-summed
    counters are read here, once."""
    counters = {k: int(v) for k, v in _counts.items()}
    for eng, base in list(_engines.items()):
        for name, v in _engine_counts(eng).items():
            counters[name] = counters.get(name, 0) + v - base.get(name, 0)
    for k, v in _launches().items():
        counters[f"launches/{k}"] = v - _launch_base.get(k, 0)
    return {"spans": list(_spans), "counters": counters,
            "dropped": _dropped}
