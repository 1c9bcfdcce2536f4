"""``adjoint_reads_per_step.train`` on hand-built steps and planted spans:
the reads inside the adjoint solves are counted at any depth, those of
the forward solve and those outside any solve are not."""

import types

from benchmark.benchlib import progspans
from benchmark.benchlib.record import Run, Step
from benchmark.benchlib.spec import metric_reader
from benchmark.reference import psignn

MS = 1_000_000                          # ns
NAME = "adjoint_reads_per_step.train"


def _span(name, start_ms, end_ms, parent=None):
    return types.SimpleNamespace(name=name, start=start_ms * MS,
                                 end=None if end_ms is None else end_ms * MS,
                                 parent=parent, root=1, thread=1)


def _steps(profiled=2):
    """Steps of the window, the last ``profiled`` of them in the slice."""
    steps = [Step(samples=50, seconds=1.0, loss=1.0, fw_launches=300,
                  bw_launches=1008) for _ in range(3)]
    for s in steps[len(steps) - profiled:]:
        s.profiled = True
    return Run(cell="c", config={}, traffic={}, reference=psignn,
               steps=steps)


def _host_loop_steps():
    """Two steps whose adjoint solves (on another thread: no parent) read
    once a Broyden step: 5 and 7 ``solver.read``s; the forward solve's
    reads and one outside any solve are not the adjoint's."""
    out = []
    for t, n in ((0, 5), (2000, 7)):
        step = _span("train.step", t, t + 1000)
        f = _span("deq.forward", t + 1, t + 100, step)
        a = _span("deq.adjoint", t + 200, t + 900)
        out += [step, f, _span("solver.read", t + 2, t + 3, f),
                _span("loop.read", t + 4, t + 5, f), a]
        out += [_span("solver.read", t + 201 + i, t + 202 + i, a)
                for i in range(n)]
    out.append(_span("solver.read", 5000, 5001))
    return out


def _carried_steps():
    """Two steps whose adjoint solves take the carried loop: 3 and 4
    chunks (a ``loop.read`` each, beside its ``loop.eager`` or
    ``loop.replay``) and the solver's final fetch, a ``solver.read``,
    under a span nested in the adjoint; one replay still open."""
    out = []
    for t, chunks in ((0, 3), (2000, 4)):
        a = _span("deq.adjoint", t + 200, t + 900)
        inner = _span("solver.broyden", t + 201, t + 899, a)
        out += [a, inner, _span("loop.eager", t + 202, t + 210, inner)]
        for i in range(chunks):
            out.append(_span("loop.replay", t + 210 + 10 * i,
                             t + 218 + 10 * i, inner))
            out.append(_span("loop.read", t + 218 + 10 * i,
                             t + 220 + 10 * i, inner))
        out.append(_span("solver.read", t + 890, t + 891, inner))
    out.append(_span("loop.replay", 9000, None))
    return out


def _closed(spans):
    return lambda: [r for r in spans if r.end is not None]


def test_host_loop_reads(monkeypatch):
    monkeypatch.setattr(progspans, "records", _closed(_host_loop_steps()))
    assert metric_reader(NAME)(_steps()) == (5 + 7) / 2


def test_carried_loop_reads_at_any_depth(monkeypatch):
    monkeypatch.setattr(progspans, "records", _closed(_carried_steps()))
    assert metric_reader(NAME)(_steps()) == (3 + 1 + 4 + 1) / 2
    assert metric_reader(NAME)(_steps(profiled=1)) == 9


def test_nothing_to_read_reads_none(monkeypatch):
    """No adjoint span (a program without the recorder, or spans of other
    names only), or no step in the slice, reads None."""
    for planted in ([], [_span("deq.forward", 0, 1),
                         _span("solver.read", 0, 1)]):
        monkeypatch.setattr(progspans, "records", lambda: planted)
        assert metric_reader(NAME)(_steps()) is None
    monkeypatch.setattr(progspans, "records", _closed(_host_loop_steps()))
    assert metric_reader(NAME)(_steps(profiled=0)) is None
