"""Profiling and throughput accounting.

Port of ``psignn_tpu/profiling.py``: ``trace`` is a ``torch.profiler``
context in place of ``jax.profiler``'s, ``timed`` synchronises the card
in place of JAX's host transfer, and ``EdgeThroughput`` keeps the JAX
package's arithmetic and report keys.  ``device_events``, ``kernel_times``
and ``profiled`` read the device's kernel time out of a ``torch.profiler``
trace: the busy share ``bench`` and ``chip_smoke.py`` report.  Nothing on
the main path uses this module; it is the accounting a benchmark of the
port times with.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Dict, Optional, Tuple

import torch

_TRACE_NUMBER = itertools.count()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block (the CPU, and the card when
    there is one), written as a Chrome trace
    ``<log_dir>/trace_<pid>_<n>.json`` on exit; yields the profiler.  Does
    nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_TRACE_NUMBER)}.json"))


def _synchronize(out) -> None:
    """Wait for the card to finish every CUDA tensor in ``out`` (a tensor,
    or tuples, lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for item in out:
            _synchronize(item)
    elif isinstance(out, dict):
        for item in out.values():
            _synchronize(item)


def timed(fn, *args, reps: int = 3, warmup: int = 1):
    """(last output, best-of wall seconds) of ``fn(*args)`` over ``reps``
    calls after ``warmup``, each call waited for on the card
    (``torch.cuda.synchronize``) when its output holds CUDA tensors (the
    reference's timing, ``spec_geo.py:241-245``)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        _synchronize(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _synchronize(out)
        times.append(time.perf_counter() - t0)
    return out, min(times)


def device_events(prof) -> list:
    """The device's kernels and copies in a ``torch.profiler`` trace.  A
    ``record_function`` range (``Optimizer.step#Adam.step``) also shows on
    the device's timeline, spanning its kernels and the gaps between them;
    it is left out."""
    from torch.autograd import DeviceType
    return [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


def kernel_times(prof) -> Dict[str, Tuple[float, int]]:
    """{name: (device µs, count)} of the trace's ``device_events``.  The
    port's kernels run on one stream, so their times add up to the time
    the device was busy."""
    by_name: Dict[str, Tuple[float, int]] = {}
    for ev in device_events(prof):
        tot, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + ev.time_range.elapsed_us(), cnt + 1)
    return by_name


def profiled(run, host: bool = True):
    """(profiler, wall seconds) of one ``run()`` under ``torch.profiler``
    (the card when there is one, and with ``host`` — or without a card —
    the CPU's operators, which ``record_function`` ranges need), the card
    waited for."""
    from torch.profiler import ProfilerActivity, profile
    activities = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                  else [])
    if host or not activities:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        _synchronize(run())
        wall = time.perf_counter() - t0
    return prof, wall


class EdgeThroughput:
    """edges/s accounting for fixed-point message passing.

    Each update-function evaluation visits every (non-self-loop) edge once
    per direction; Ψ-GNN's function does 2 directions per layer
    (model.py:285-286), 3 in mixed mode."""

    def __init__(self, n_edges: int, directions: int = 2, n_layers: int = 1):
        self.edges_per_eval = n_edges * directions * n_layers

    def edges_per_s(self, n_evals: int, seconds: float) -> float:
        return self.edges_per_eval * n_evals / seconds

    def report(self, n_evals: int, seconds: float,
               baseline: Optional[float] = None) -> Dict[str, float]:
        eps = self.edges_per_s(n_evals, seconds)
        out = {"edges_per_s": eps, "wall_s": seconds, "n_evals": n_evals}
        if baseline:
            out["vs_baseline"] = eps / baseline
        return out
