"""The readers of the program's spans (``benchlib/progspans.py``) and the
nine metrics that use them, on hand-built runs and planted spans."""

import types

import pytest

from benchmark.benchlib import progspans
from benchmark.benchlib.record import Request, Run, Step
from benchmark.benchlib.spec import metric_reader
from benchmark.reference import psignn

MS = 1_000_000                          # ns


def _span(name, start_ms, end_ms, parent=None):
    return types.SimpleNamespace(name=name, start=start_ms * MS,
                                 end=None if end_ms is None else end_ms * MS,
                                 parent=parent, root=1, thread=1)


def _requests():
    """Two profiled requests (300 f_θ calls in all) and one outside the
    slice."""
    reqs = [Request(mesh=0, n=100, e=600, seconds=0.1, graph_s=0.01,
                    fw_launches=1000),
            Request(mesh=1, n=100, e=600, seconds=0.1, graph_s=0.01,
                    fw_launches=200, profiled=True),
            Request(mesh=2, n=400, e=2400, seconds=0.3, graph_s=0.03,
                    fw_launches=400, profiled=True)]
    run = Run(cell="c", config={}, traffic={}, reference=psignn,
              requests=reqs)
    run.profiled = [r for r in reqs if r.profiled]
    return run


def _request_spans():
    """Two requests' spans: RCM 2 + 4 ms, CSR 1 + 3 ms, forward solves of
    50 and 150 ms holding reads of 10 + 5 and 60 ms and three captures of
    4 ms, eager chunks of 6 and 8 ms, and a read outside any solve."""
    out = []
    for t, rcm, csr, fw, reads, caps, eager in (
            (0, 2, 1, 50, (10, 5), 1, 6),
            (1000, 4, 3, 150, (60,), 2, 8)):
        out.append(_span("graph.rcm", t, t + rcm))
        batch = _span("graph.batch", t + 10, t + 20)
        out += [batch, _span("graph.csr", t + 11, t + 11 + csr, batch)]
        root = _span("infer", t + 30, t + 300)
        f = _span("deq.forward", t + 40, t + 40 + fw, root)
        out += [root, f, _span("loop.eager", t + 40, t + 40 + eager, f)]
        replay = _span("loop.replay", t + 50, t + 60, f)
        out.append(replay)
        out += [_span("loop.capture", t + 50 + 4 * i, t + 54 + 4 * i, replay)
                for i in range(caps)]
        out += [_span("loop.read", t + 60 + i, t + 60 + i + r, f)
                for i, r in enumerate(reads)]
    out.append(_span("loop.read", 5000, 5100))
    out.append(_span("deq.forward", 6000, None))        # still open
    return out


def _steps():
    """Two profiled steps (300 VJPs in all) and one outside the slice."""
    return Run(cell="c", config={}, traffic={}, reference=psignn, steps=[
        Step(samples=50, seconds=1.0, loss=1.0, fw_launches=300,
             bw_launches=1000),
        Step(samples=50, seconds=1.0, loss=1.0, fw_launches=300,
             bw_launches=200, profiled=True),
        Step(samples=50, seconds=1.0, loss=1.0, fw_launches=300,
             bw_launches=400, profiled=True)])


def _step_spans():
    """Two steps: forward solves of 100 and 140 ms, adjoint solves of 500
    and 700 ms (on another thread: no parent but the root) holding reads
    of 100 and 150 ms, and a read of the forward solve."""
    out = []
    for t, fw, adj, read in ((0, 100, 500, 100), (2000, 140, 700, 150)):
        step = _span("train.step", t, t + 1000)
        f = _span("deq.forward", t + 1, t + 1 + fw, step)
        a = _span("deq.adjoint", t + 200, t + 200 + adj)
        out += [step, f, _span("solver.read", t + 2, t + 3, f), a,
                _span("solver.read", t + 201, t + 201 + read, a)]
    return out


SWEEP = {"capture_ms.solve": 3 * 4 / 2,
         "captures_per_request.solve": 3 / 2,
         "eager_ms.solve": (6 + 8) / 2,
         "host_ms_per_fw_call.solve": (50 + 150 - 75) / 300,
         "rcm_ms.unroll": (2 + 4) / 2,
         "csr_ms.unroll": (1 + 3) / 2}
TRAIN = {"fw_solve_ms_per_step.train": (100 + 140) / 2,
         "adjoint_ms_per_step.train": (500 + 700) / 2,
         "adjoint_host_ms_per_vjp.train": (1200 - 250) / 300}


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_request_metrics(monkeypatch, name):
    monkeypatch.setattr(progspans, "records",
                        lambda: [r for r in _request_spans()
                                 if r.end is not None])
    assert metric_reader(name)(_requests()) == pytest.approx(SWEEP[name])
    assert metric_reader(name)(Run(cell="c", config={}, traffic={},
                                   reference=psignn)) is None


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_step_metrics(monkeypatch, name):
    monkeypatch.setattr(progspans, "records", _step_spans)
    assert metric_reader(name)(_steps()) == pytest.approx(TRAIN[name])


@pytest.mark.parametrize("name", sorted(SWEEP) + sorted(TRAIN))
def test_no_span_of_its_name_reads_none(monkeypatch, name):
    """Spans of other names only, or none at all (a program without the
    recorder), read None."""
    spans = [_span("graph.copy", 0, 1), _span("train.read", 2, 3)]
    for planted in (spans, []):
        monkeypatch.setattr(progspans, "records", lambda: planted)
        assert metric_reader(name)(_requests()) is None
        assert metric_reader(name)(_steps()) is None


def test_records_reads_the_programs_closed_spans(monkeypatch):
    from psignn_tpu_torch import profiling
    from torch.profiler import ProfilerActivity, profile
    first = len(progspans.records())
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("graph.rcm"):
            with profiling.span("graph.csr"):
                assert len(progspans.records()) == first      # open
    after = progspans.records()
    assert [r.name for r in after[first:]] == ["graph.rcm", "graph.csr"]
    monkeypatch.delattr(profiling, "recorded")
    assert progspans.records() == []
