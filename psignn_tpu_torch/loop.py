"""Running a carried solve: the counterpart of JAX's ``lax.while_loop``.

A carried solver (``solvers.broyden`` and ``solvers.picard`` with
``loop="while"``) keeps its whole state in preallocated tensors, the
carry, a dict whose ``"done"`` entry is a 0-d bool tensor, and writes one
iteration into it with ``body(carry, static)``: in place, every entry
frozen once the solve has stopped, as JAX's ``freeze`` keeps a stopped
carry (``psignn_tpu/solvers.py:72-86``).  An iteration that runs after
the stop is then an exact no-op, so the host need not look after every
step: ``run_while`` steps the body in chunks and reads ``done`` once a
chunk.

On the CPU the chunks run eagerly (the plain version of the graph loop).
On a CUDA tensor the first chunk runs eagerly too (real progress, and the
warm-up a capture needs: the kernels are built and loaded, cuBLAS is
initialised), and every later step is a replay of a ``CUDAGraph`` of one
body iteration, captured once for each static key at first need.
``key(k)`` gives the static arguments of the step that follows ``k``
steps (Broyden: the live rank blocks), so a solve captures one graph a
key, whatever the chunk, and a chunk is cut only at the threshold: a solve
that runs to it evaluates its body exactly ``T`` times.  The graphs of one
solve share one memory pool and are freed when it returns.  A capture or
replay that fails raises; nothing falls back to another loop.

Counts.  The wrappers of the CUDA kernels count their launches in Python
(``kernels.fused_mp.LAUNCHES``, ...), which a replay does not run.  So
the counters named in ``COUNTERS`` are set back after each capture (a
capture launches nothing) and advanced by the capture's deltas at each
replay: they stay true counts of what ran on the card.

Spans (``profiling.span``, recorded under a profiler): ``loop.eager``, a
chunk stepped eagerly; ``loop.replay``, a chunk of replays, holding each
``loop.capture`` (timed by the readings that ``capture_s`` adds); and
``loop.read``, the read of ``done`` that ends a chunk.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, Hashable, List, NamedTuple, Tuple

import torch

from . import profiling
from .kernels import fused_mp

# Body iterations a chunk runs between two host reads of ``done``.
# Patchable, as the rank block is.  A read costs the card a short idle
# gap, while the first chunk, stepped eagerly, costs the host about 2 ms
# a step more than the card's: on an H100 the headline solve (531 steps)
# took 0.341 s at 4, 0.359 at 8, 0.354 at 16 and 0.386 at 32
# (``chip_smoke.py``'s while_loop phase).
CHUNK = 4

# Replay CUDA graphs on the card; False steps the same body eagerly there
# (a private switch, to hold the two against each other).
_GRAPHS = True

# (namespace, attribute) of each integer count that a replay advances by
# what its capture added.  A caller may append its own while it counts.
COUNTERS: List[Tuple[object, str]] = [
    (fused_mp, "LAUNCHES"), (fused_mp, "BWD_LAUNCHES"),
    (fused_mp, "JVP_LAUNCHES")]


class LoopStats(NamedTuple):
    steps: int          # body iterations run, frozen ones included
    host_reads: int     # reads of ``done``, one a chunk
    graphs: int         # CUDA graphs captured
    capture_s: float    # host seconds spent capturing them


@functools.cache
def _capture_stream(index: int) -> "torch.cuda.Stream":
    """The one side stream of each card that graphs are captured on (a
    capture cannot use the default stream): cuBLAS keeps a workspace for
    each stream it has run on, so one stream keeps one workspace."""
    return torch.cuda.Stream(device=index)


def _counts() -> List[int]:
    return [getattr(obj, name) for obj, name in COUNTERS]


def _advance(deltas: List[int]) -> None:
    for (obj, name), delta in zip(COUNTERS, deltas):
        setattr(obj, name, getattr(obj, name) + delta)


def _no_key(k: int) -> None:
    return None


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    deltas: List[int]


def _capture(body: Callable, carry: Dict, static, pool, stream) -> _Graph:
    """A graph of one body iteration on ``carry``, captured on ``stream``
    into ``pool``; the counters are left as they were."""
    before = _counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            body(carry, static)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass        # the capture is already broken: raise the cause
            raise
        graph.capture_end()
    deltas = [a - b for a, b in zip(_counts(), before)]
    _advance([-d for d in deltas])
    return _Graph(graph, deltas)


def run_while(body: Callable, carry: Dict, T: int, chunk: int = None,
              key: Callable[[int], Hashable] = _no_key) -> LoopStats:
    """Step ``body(carry, key(k))`` in chunks until ``carry["done"]`` or
    ``T`` steps; returns the loop's ``LoopStats``.  ``carry``'s tensors
    must keep their storage (the graphs read and write it).  ``chunk``
    defaults to ``CHUNK``."""
    chunk = CHUNK if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk {chunk}: give at least 1")
    done = carry["done"]
    graphs_on = done.device.type == "cuda" and _GRAPHS
    graphs: Dict[Hashable, _Graph] = {}
    pool = None
    k = reads = 0
    capture_ns = 0
    try:
        while k < T:
            n = min(chunk, T - k)
            if not graphs_on or k == 0:
                with profiling.span("loop.eager"):
                    for i in range(k, k + n):
                        body(carry, key(i))
            else:
                with profiling.span("loop.replay"):
                    for i in range(k, k + n):
                        static = key(i)
                        g = graphs.get(static)
                        if g is None:
                            if pool is None:
                                pool = torch.cuda.graph_pool_handle()
                            t0 = time.perf_counter_ns()
                            g = graphs[static] = _capture(
                                body, carry, static, pool,
                                _capture_stream(
                                    torch.cuda.current_device()
                                    if done.device.index is None
                                    else done.device.index))
                            t1 = time.perf_counter_ns()
                            capture_ns += t1 - t0
                            profiling.closed_span("loop.capture", t0, t1)
                        g.graph.replay()
                        _advance(g.deltas)
            k += n
            reads += 1
            with profiling.span("loop.read"):
                stop = bool(done.item())
            if stop:
                break
    finally:
        for g in graphs.values():
            g.graph.reset()
    return LoopStats(k, reads, len(graphs), capture_ns * 1e-9)
