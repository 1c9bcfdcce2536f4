"""The program's own spans, as the metric readers see them.

The program records its phases (``psignn_tpu_torch.profiling.span``)
only while a ``torch.profiler`` session runs, so in a run of a cell they
are the spans of the traced slice alone: of ``run.profiled`` (the
slice's requests) or of the steps marked ``profiled``.  Each span has
``name``, ``start`` and ``end`` in ``time.time_ns()`` and its ``parent``
span.  A program without the recorder records nothing, and each reader
then returns None, as it does where no span of its name was recorded.
"""

from __future__ import annotations

from typing import Optional


def records() -> list:
    """The closed spans the program has recorded in this process."""
    from psignn_tpu_torch import profiling
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return []
    return [r for r in recorded() if r.end is not None]


def _ms(r) -> float:
    return (r.end - r.start) * 1e-6


def _named(spans: list, name: str) -> list:
    return [r for r in spans if r.name == name]


def _inside(r, outers: set) -> bool:
    while r.parent is not None:
        r = r.parent
        if id(r) in outers:
            return True
    return False


def _less_inner_ms(outer: str, inner: str) -> Optional[float]:
    """Σ ms of the ``outer`` spans less Σ ms of the ``inner`` spans within
    them (at any depth), or None without an ``outer`` span."""
    spans = records()
    outers = _named(spans, outer)
    if not outers:
        return None
    ids = {id(r) for r in outers}
    return (sum(_ms(r) for r in outers)
            - sum(_ms(r) for r in _named(spans, inner) if _inside(r, ids)))


def _profiled_steps(run) -> list:
    return [s for s in run.steps if s.profiled]


def per_request(run, name: str, count: bool = False) -> Optional[float]:
    """Σ ms (or with ``count`` the number) of the ``name`` spans over the
    slice's requests."""
    spans = _named(records(), name)
    if not spans or not run.profiled:
        return None
    total = len(spans) if count else sum(_ms(r) for r in spans)
    return total / len(run.profiled)


def per_step(run, name: str) -> Optional[float]:
    """Σ ms of the ``name`` spans over the slice's training steps."""
    spans = _named(records(), name)
    steps = _profiled_steps(run)
    if not spans or not steps:
        return None
    return sum(_ms(r) for r in spans) / len(steps)


def host_ms_per_fw_call(run) -> Optional[float]:
    """Host ms of the forward solves (``deq.forward`` less the reads of
    ``done`` in it, ``loop.read``, where the host waits for the card) per
    evaluation of f_θ (two forward-kernel launches) of the slice's
    requests."""
    calls = sum(r.fw_launches for r in run.profiled) / 2
    host = _less_inner_ms("deq.forward", "loop.read")
    if host is None or calls <= 0:
        return None
    return host / calls


def adjoint_host_ms_per_vjp(run) -> Optional[float]:
    """Host ms of the adjoint solves (``deq.adjoint`` less the solver's
    host reads in it, ``solver.read``, where the host waits for the card)
    per VJP (two backward-kernel launches) of the slice's steps."""
    vjps = sum(s.bw_launches for s in _profiled_steps(run)) / 2
    host = _less_inner_ms("deq.adjoint", "solver.read")
    if host is None or vjps <= 0:
        return None
    return host / vjps
