"""The device trace of a traced run's window.

``torch.profiler`` (CUDA activity only, so the host pays no per-operator
recording) records every operation on the card: kernels, copies, sets.
Its timestamps are wall-clock nanoseconds, the clock of
``time.time_ns()``, which the benchmark's host spans are stamped with
too.  Over the window this reduces

  * ``window_s`` — the profiled window's length;
  * ``busy_s`` — the union of the card's operation intervals in it;
  * ``kernel_s`` — device seconds per operation name;
  * ``idle_by_span`` — the card's idle time, by the benchmark span open
    on the host meanwhile (``host`` when none was: the scheduler, the
    tree bookkeeping and Python between the calls).
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Sequence, Tuple


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = 0

    def start(self) -> None:
        """Start the profiler (seconds, at its first start in a process):
        before the window opens, which ``open`` marks."""
        prof = self.torch.profiler
        self.torch.cuda.synchronize()
        self.prof = prof.profile(activities=[prof.ProfilerActivity.CUDA])
        self.prof.__enter__()

    def open(self) -> None:
        self.t0 = time.time_ns()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(None, None, None)

    def summarize(self, spans: Sequence[Tuple[int, int, str]]) -> Dict:
        from torch.autograd import DeviceType
        w0, w1 = self.t0, self.t1
        dev: List[Tuple[int, int, str]] = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            d = e.duration_ns()
            if d > 0:
                dev.append((e.start_ns(), e.start_ns() + d, e.name()))
        kernel_s: Dict[str, float] = {}
        for s, t, n in dev:
            a, b = max(s, w0), min(t, w1)
            if b > a:
                kernel_s[n] = kernel_s.get(n, 0.0) + (b - a) * 1e-9
        busy, gaps = _union(dev, w0, w1)
        spans = sorted(spans)
        starts = [s for s, _, _ in spans]
        idle: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            who = spans[i][2] if i >= 0 and spans[i][1] >= mid else "host"
            idle[who] = idle.get(who, 0.0) + (b - a) * 1e-9
        return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
                "kernel_s": kernel_s, "idle_by_span": idle,
                "n_device_ops": len(dev),
                "outside_window": sum(1 for s, t, _ in dev
                                      if t < w0 or s > w1)}


def _union(intervals, w0: int, w1: int):
    """(busy ns, idle gaps [(a, b)]) of intervals clipped to [w0, w1]."""
    busy, gaps, end = 0, [], w0
    for s, t, _ in sorted(intervals):
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if s > end:
            gaps.append((end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    if w1 > end:
        gaps.append((end, w1))
    return busy, gaps
