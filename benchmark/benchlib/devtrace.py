"""Device-trace arithmetic over a ``torch.profiler`` slice of the window.

The slice profiles device activity only (CUDA).  From its kernels and
copies this module takes: the time by operation name, the busy time (the
union of their intervals, so overlapping streams count once), the slice's
length on the host clock (the card waited for at both ends), and the idle
gaps between busy intervals, each labelled with the harness span that was
open on the host at the gap's middle.  The arithmetic of
``psignn_tpu_torch.profiling.device_events`` and ``kernel_times``
(device events without user annotations, summed by name), copied.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

Span = Tuple[str, int, int]     # (label, start ns, end ns), time.time_ns()


class Slice:
    """Profile the device between ``start()`` and ``stop()``; ``spans``
    are appended by the caller while it runs."""

    def __init__(self, device: torch.device):
        self.device = device
        self.spans: List[Span] = []
        self.prof = None
        self.window_s = 0.0
        self._t0 = 0.0
        self._start_ns = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._start_ns = time.time_ns()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    def summary(self) -> "TraceSummary":
        return summarize(self.prof, self.window_s, self.spans,
                         self._start_ns)


class TraceSummary:
    def __init__(self, busy_s: float, window_s: float,
                 by_name: Dict[str, Tuple[float, int]],
                 gaps: List[Tuple[str, float]]):
        self.busy_s = busy_s
        self.window_s = window_s
        self.by_name = by_name          # {name: (seconds, count)}
        self.gaps = gaps                # [(label, seconds)], longest first

    def seconds_of(self, fragment: str) -> Tuple[float, int]:
        """(seconds, count) of the operations whose name holds
        ``fragment``."""
        s, c = 0.0, 0
        for name, (sec, cnt) in self.by_name.items():
            if fragment in name:
                s += sec
                c += cnt
        return s, c


def _trace_start_ns(prof) -> Optional[int]:
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    fn = getattr(res, "trace_start_ns", None)
    return None if fn is None else int(fn())


def summarize(prof, window_s: float, spans: List[Span],
              host_start_ns: int) -> TraceSummary:
    from torch.autograd import DeviceType
    events = [ev for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False)]
    by_name: Dict[str, Tuple[float, int]] = {}
    ivals = []
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end     # µs, relative
        sec, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (sec + (b - a) * 1e-6, cnt + 1)
        ivals.append((a, b))
    ivals.sort()
    merged: List[List[float]] = []
    for a, b in ivals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_s = sum(b - a for a, b in merged) * 1e-6
    base = _trace_start_ns(prof)
    # the profiler's clock is the host's epoch clock on the builds this
    # was written for; a base far from the host's start cannot label
    aligned = base is not None and abs(base - host_start_ns) < 10 ** 10
    gaps = []
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        label = "unaligned"
        if aligned:
            mid = base + int((b0 + a1) * 500)
            label = next((s for s, t0, t1 in spans if t0 <= mid < t1),
                         "harness")
        gaps.append((label, (a1 - b0) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(busy_s, window_s, by_name, gaps)
