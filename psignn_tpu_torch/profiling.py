"""Profiling: the program's spans, traces and device time.

Port of ``psignn_tpu/profiling.py``: ``trace`` is a ``torch.profiler``
context in place of ``jax.profiler``'s, and ``timed`` synchronises the
card in place of JAX's host transfer.  ``device_events``, ``kernel_times``
and ``profiled`` read the device's kernel time out of a ``torch.profiler``
trace: the busy share ``bench`` and ``chip_smoke.py`` report.

Spans.  The program marks its phases with ``span(name)`` (the graph
build, the entry points, the solves and their loops, the training step).
A span is recorded only while a ``torch.profiler`` session is active
(``torch.autograd.profiler._is_profiler_enabled``, which every session
sets), so whoever profiles gets the program's phases and nothing else
turns them on; otherwise a span site costs one attribute read and returns
a shared null context.  A record holds its name, its start and end in
``time.time_ns()`` (the clock a ``torch.profiler`` trace starts on, so
spans and device kernels share one time base), its parent, its root's id
and its thread.  Spans nest through a stack per thread; a span opened on
an empty stack while another thread's root span is open (the adjoint
solve, run in an autograd hook on the device's backward thread) takes
that root's id.  ``recorded()`` gives the records kept so far, at most
``CAP``; later spans are dropped and counted in ``DROPPED``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

_TRACE_NUMBER = itertools.count()

# Records kept at most (about 150 MB of them); later spans are dropped
# and counted.
CAP = 1 << 20
DROPPED = 0
_RECORDS: List["Span"] = []
_ROOT_IDS = itertools.count(1)
_NULL = contextlib.nullcontext()


class _Thread(threading.local):
    """Each thread's stack of open spans and its native id (read once: a
    system call)."""

    def __init__(self):
        self.stack: List["Span"] = []
        self.id = threading.get_native_id()


_THREAD = _Thread()
# Guards the records, the drop count and the open root against threads
# that record at once (a loader's thread beside the caller's).
_LOCK = threading.Lock()
# The open root span.  One client opens one root at a time, so a span
# on another thread's empty stack belongs to it.
_ROOT: Optional["Span"] = None


class Span:
    """One recorded phase: ``name``, ``start`` and ``end`` in
    ``time.time_ns()`` (``end`` None while open), the enclosing ``parent``
    span on the same thread (None for an outermost one), the ``root`` id
    shared by every span of one root, and the native ``thread`` id."""

    __slots__ = ("name", "start", "end", "parent", "root", "thread")

    def __init__(self, name: str):
        self.name = name
        self.end = None

    def __enter__(self) -> "Span":
        _open(self, time.time_ns())
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        _close(self)
        return False

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e-6


def _open(rec: Span, start: int) -> None:
    """Give ``rec`` its start, parent, root and thread, keep it and push
    it; past ``CAP`` it is dropped (kept nowhere, pushed nowhere)."""
    global DROPPED, _ROOT
    rec.start = start
    rec.parent = None
    thread = _THREAD
    stack = thread.stack
    with _LOCK:
        if len(_RECORDS) >= CAP:
            DROPPED += 1
            return
        if stack:
            rec.parent = stack[-1]
            rec.root = rec.parent.root
        elif _ROOT is not None:
            rec.root = _ROOT.root
        else:
            rec.root = next(_ROOT_IDS)
            _ROOT = rec
        _RECORDS.append(rec)
    rec.thread = thread.id
    stack.append(rec)


def _close(rec: Span) -> None:
    global _ROOT
    stack = _THREAD.stack
    if stack and stack[-1] is rec:
        stack.pop()
    if _ROOT is rec:
        with _LOCK:
            if _ROOT is rec:
                _ROOT = None


def span(name: str):
    """A context that records the block as the span ``name`` while a
    ``torch.profiler`` session is active, and otherwise does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return Span(name)


def closed_span(name: str, start_ns: int, end_ns: int) -> None:
    """Record ``name`` as a span the caller timed itself between two
    ``time.perf_counter_ns()`` readings (one timer for the caller's count
    and the record), nested in the span open on this thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    shift = time.time_ns() - time.perf_counter_ns()
    rec = Span(name)
    _open(rec, start_ns + shift)
    rec.end = end_ns + shift
    _close(rec)


def recorded() -> List[Span]:
    """The spans recorded so far, in the order they opened (a
    ``closed_span`` at its close)."""
    return list(_RECORDS)


def _chrome_events(records: List[Span], base_ns: int) -> List[dict]:
    """Complete ("X") Chrome-trace events of the closed ``records`` on
    the trace's time base (µs after ``base_ns``), on this process and
    each span's thread, as the profiler writes its host events."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": r.name,
             "pid": pid, "tid": r.thread,
             "ts": (r.start - base_ns) / 1e3, "dur": (r.end - r.start) / 1e3,
             "args": {"root": r.root}}
            for r in records if r.end is not None]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block (the CPU, and the card when
    there is one), written as a Chrome trace
    ``<log_dir>/trace_<pid>_<n>.json`` on exit with the program's spans
    recorded in the block among its host events; yields the profiler.
    Does nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = len(_RECORDS)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{next(_TRACE_NUMBER)}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # kineto writes µs after ``baseTimeNanoseconds``; without it, epoch µs
    doc["traceEvents"].extend(_chrome_events(
        _RECORDS[first:], int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)


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
