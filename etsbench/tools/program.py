"""A traced run of one cell read through the program's own tracer
(``repro_torch.tracing``): the readings the harness does not take yet.

    python3 etsbench/tools/program.py --workload <cell> --seed <n> \\
        --seconds <s> --trace 1 [--tracer 0|1]

Runs ``harness.run`` in this process.  With ``--tracer 1`` (the default)
the program's tracer is on from the start, reset when the window opens
and read when it closes; with ``--tracer 0`` it stays off, so the two
runs' ``search_tok_s`` give the tracer's cost.  Prints one JSON line:
the run's result, its end-to-end metrics (``e2e``), and under
``program`` the readings below and the device's idle time in the window
by the innermost program span open at each idle gap's midpoint
(``idle_gaps``; the harness's own breakdown stays in ``result``).
Without ``repro_torch.tracing`` (an older program) ``program`` is null.

Readings (each None where its spans or counters are missing):

  * ``decode.host_ms``: mean per ``decode`` span of its host phases
    before the forward (``decode.alloc``, ``.rows``, ``.meta``,
    ``.count``, ``.put``);
  * ``decode.idle_ms``: device idle time whose midpoint lies in a
    ``decode`` span, per ``decode`` span (a traced card only);
  * ``step.decode_share``: over the window's problem-steps, the time
    ``decode`` spans cover inside each step's ``step.rows``, over the
    steps' durations;
  * ``moe.prm_drop_share``: the PRM's capacity-dropped replicas over its
    routed ones (MoE PRMs only);
  * ``kv.cow_pages_per_step``: pages copied on write per closed
    problem-step.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

T_START = time.perf_counter()

HOST_PHASES = ("decode.alloc", "decode.rows", "decode.meta", "decode.count",
               "decode.put")
# spans stamped per problem, which overlap the loop's own
PROBLEM_SPANS = ("step", "step.rows")


def _tracing():
    import importlib
    try:
        return importlib.import_module("repro_torch.tracing")
    except ImportError:
        return None


@contextlib.contextmanager
def capture(tracer: bool = True):
    """Patch the harness for the runs inside: the program's tracer on
    (``tracer``), reset when the window opens, read when it closes.
    Yields a dict that then holds ``probe`` (the harness's ``Probe``),
    ``device`` (its ``DeviceTrace``, traced cards only) and ``snapshot``
    (None without the tracer)."""
    from etsbench import devtrace, harness
    tracing = _tracing() if tracer else None
    got: Dict = {"probe": None, "device": None, "snapshot": None}
    base_probe, base_trace = harness.Probe, devtrace.DeviceTrace

    class Probe(base_probe):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            got["probe"] = self

        @property
        def t_open(self):
            return self.__dict__["_t_open"]

        @t_open.setter
        def t_open(self, t):
            self.__dict__["_t_open"] = t
            if t is not None and tracing is not None:
                tracing.reset()

        @property
        def t_close(self):
            return self.__dict__["_t_close"]

        @t_close.setter
        def t_close(self, t):
            self.__dict__["_t_close"] = t
            if t is not None and tracing is not None:
                got["snapshot"] = tracing.snapshot()

    class DeviceTrace(base_trace):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            got["device"] = self

    was_on = tracing is not None and tracing.on
    harness.Probe, devtrace.DeviceTrace = Probe, DeviceTrace
    if tracing is not None:
        tracing.enable()
    try:
        yield got
    finally:
        harness.Probe, devtrace.DeviceTrace = base_probe, base_trace
        if tracing is not None and not was_on:
            tracing.disable()


def idle_gaps(device) -> Optional[List[Tuple[int, int]]]:
    """The card's idle gaps [(start_ns, end_ns)] in the profiled window."""
    if device is None or device.prof is None:
        return None
    from torch.autograd import DeviceType
    from etsbench.devtrace import _union
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in device.prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    return _union(ops, device.t0, device.t1)[1]


def innermost(spans: Sequence, points: Sequence[int]) -> List[str]:
    """For each time in ``points`` (ascending), the name of the innermost
    loop span open then (``host`` where none was); problem spans are
    left out, the others nest."""
    nested = sorted((s for s in spans if s.name not in PROBLEM_SPANS),
                    key=lambda s: (s.start_ns, -s.end_ns))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(nested) and nested[i].start_ns <= t:
            while stack and stack[-1].end_ns < nested[i].start_ns:
                stack.pop()
            stack.append(nested[i])
            i += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out.append(stack[-1].name if stack else "host")
    return out


def idle_by_span(snap, gaps) -> Optional[Dict[str, float]]:
    """Idle seconds by the innermost program span open at each gap's
    midpoint."""
    if snap is None or gaps is None:
        return None
    mids = [(a + b) // 2 for a, b in gaps]
    out: Dict[str, float] = {}
    for (a, b), name in zip(gaps, innermost(snap["spans"], mids)):
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out


def idle_overlap(snap, gaps) -> Optional[Dict[str, float]]:
    """Idle seconds split over the innermost program spans each gap
    overlaps (a gap that starts in one phase and ends in the next is
    shared between them)."""
    if snap is None or gaps is None:
        return None
    cuts = sorted({t for s in snap["spans"] if s.name not in PROBLEM_SPANS
                   for t in (s.start_ns, s.end_ns)})
    pieces = list(zip(cuts, cuts[1:]))
    names = innermost(snap["spans"], [(a + b) // 2 for a, b in pieces])
    out: Dict[str, float] = {}
    i = 0
    for a, b in sorted(gaps):
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        t, j = a, i
        while t < b:
            if j < len(pieces) and pieces[j][0] <= t:
                end, name = min(b, pieces[j][1]), names[j]
                j += 1
            else:
                end = min(b, pieces[j][0]) if j < len(pieces) else b
                name = "host"
            out[name] = out.get(name, 0.0) + (end - t) * 1e-9
            t = end
    return out


def phase_ms(snap) -> Optional[Dict[str, float]]:
    """Mean milliseconds per ``decode`` span of each of its phases."""
    if snap is None:
        return None
    n = len(_named(snap, "decode"))
    out: Dict[str, float] = {}
    for s in snap["spans"]:
        if s.name.startswith("decode."):
            out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns)
    return {k: v / n * 1e-6 for k, v in out.items()} if n else None


def _named(snap, name):
    return [s for s in snap["spans"] if s.name == name]


def decode_host_ms(snap) -> Optional[float]:
    if snap is None:
        return None
    dec = {s.id for s in _named(snap, "decode")}
    if not dec:
        return None
    ns = sum(s.end_ns - s.start_ns for s in snap["spans"]
             if s.name in HOST_PHASES and s.parent in dec)
    return ns / len(dec) * 1e-6


def decode_idle_ms(snap, idle) -> Optional[float]:
    if snap is None or idle is None:
        return None
    n = len(_named(snap, "decode"))
    if not n:
        return None
    s = sum(v for k, v in idle.items()
            if k == "decode" or k.startswith("decode."))
    return 1e3 * s / n


def step_decode_share(snap) -> Optional[float]:
    if snap is None:
        return None
    steps = _named(snap, "step")
    if not steps:
        return None
    dec = [(s.start_ns, s.end_ns) for s in _named(snap, "decode")]
    rows: Dict = {}
    for r in _named(snap, "step.rows"):
        rows.setdefault(r.attrs["ns"], []).append((r.start_ns, r.end_ns))
    covered = 0
    for st in steps:
        for a, b in rows.get(st.attrs["ns"], ()):
            if st.start_ns <= a and b <= st.end_ns:
                covered += sum(max(0, min(b, d1) - max(a, d0))
                               for d0, d1 in dec)
    return covered / sum(s.end_ns - s.start_ns for s in steps)


def moe_prm_drop_share(snap) -> Optional[float]:
    """The PRM's (its config's name ends in ``.prm``) drops."""
    if snap is None:
        return None
    c = snap["counters"]
    routed = sum(v for k, v in c.items()
                 if k.startswith("moe.routed/") and k.endswith(".prm"))
    dropped = sum(v for k, v in c.items()
                  if k.startswith("moe.dropped/") and k.endswith(".prm"))
    return dropped / routed if routed else None


def cow_pages_per_step(snap) -> Optional[float]:
    if snap is None:
        return None
    n = len(_named(snap, "step"))
    return snap["counters"].get("kv.cow_pages", 0) / n if n else None


def readings(snap, device=None) -> Optional[Dict]:
    if snap is None:
        return None
    gaps = idle_gaps(device)
    idle = idle_by_span(snap, gaps)
    split = idle_overlap(snap, gaps)
    names: Dict[str, int] = {}
    for s in snap["spans"]:
        names[s.name] = names.get(s.name, 0) + 1
    return {"decode.host_ms": decode_host_ms(snap),
            "decode.idle_ms": decode_idle_ms(snap, idle),
            "step.decode_share": step_decode_share(snap),
            "moe.prm_drop_share": moe_prm_drop_share(snap),
            "kv.cow_pages_per_step": cow_pages_per_step(snap),
            "idle_gaps": None if idle is None else sorted(
                ([f"idle in {k}", v] for k, v in idle.items()),
                key=lambda kv: -kv[1]),
            "idle_overlap": None if split is None else sorted(
                ([f"idle in {k}", v] for k, v in split.items()),
                key=lambda kv: -kv[1]),
            "decode.phase_ms": phase_ms(snap),
            "spans": names, "dropped": snap["dropped"],
            "counters": snap["counters"]}


def main(argv=None) -> int:
    import argparse
    # no abbreviations: ``--trace`` is the harness's, not ``--tracer``
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    a, rest = ap.parse_known_args(argv)
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "src")]
    from etsbench import harness
    e2e = {}

    def log(s):
        print(s, file=sys.stderr, flush=True)
        if s.startswith("end-to-end: "):
            e2e.update(json.loads(s[len("end-to-end: "):]))
    try:
        with capture(bool(a.tracer)) as got:
            res = harness.run(rest, root=Path(root), t_start=T_START, log=log)
    except harness.Fail as e:
        print(f"etsbench: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"tracer": a.tracer, "e2e": e2e, "result": res,
                      "program": readings(got["snapshot"], got["device"])}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
