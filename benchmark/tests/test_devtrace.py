"""The trace arithmetic and the metric readers on made-up runs."""

import types

import pytest
from torch.autograd import DeviceType

from benchmark.benchlib import readers
from benchmark.benchlib.devtrace import summarize
from benchmark.benchlib.record import Request, Run
from benchmark.benchlib.roofline import fused_mp_bound_s
from benchmark.reference import psignn

BASE = 1_700_000_000_000_000_000          # the profiler's start, epoch ns


def _prof(intervals):
    """A profiler stand-in: device events (name, start µs, end µs)."""
    evs = [types.SimpleNamespace(
        device_type=DeviceType.CUDA, name=n, is_user_annotation=False,
        time_range=types.SimpleNamespace(start=a, end=b))
        for n, a, b in intervals]
    evs.append(types.SimpleNamespace(device_type=DeviceType.CPU, name="cpu",
                                     time_range=None))
    res = types.SimpleNamespace(trace_start_ns=lambda: BASE)
    return types.SimpleNamespace(events=lambda: evs,
                                 profiler=types.SimpleNamespace(
                                     kineto_results=res))


def test_busy_is_the_union_and_gaps_carry_the_open_span():
    prof = _prof([("k", 0, 10), ("k", 5, 20), ("fused_mp_fwd_x", 30, 40),
                  ("k", 100, 110)])
    spans = [("solve r=1.0", BASE + 25_000, BASE + 50_000),
             ("graph_build r=5.0", BASE + 50_000, BASE + 200_000)]
    s = summarize(prof, 1e-3, spans, BASE)
    assert s.busy_s == pytest.approx(40e-6)
    assert s.gaps == [("graph_build r=5.0", pytest.approx(60e-6)),
                      ("solve r=1.0", pytest.approx(10e-6))]
    assert s.seconds_of("fused_mp_fwd") == (pytest.approx(10e-6), 1)
    assert s.by_name["k"][1] == 3


def test_a_clock_far_from_the_hosts_labels_nothing():
    s = summarize(_prof([("k", 0, 1), ("k", 2, 3)]), 1e-3, [], 0)
    assert s.gaps[0][0] == "unaligned"


def _run(trace=None):
    reqs = [Request(mesh=0, n=1000, e=6000, seconds=0.1, graph_s=0.02,
                    fw_launches=200),
            Request(mesh=1, n=3000, e=18000, seconds=0.3, graph_s=0.04,
                    fw_launches=400, profiled=True)]
    run = Run(cell="c", config={"model": {"latent_dim": 10, "n_layers": 1}},
              traffic={}, reference=psignn, window_s=0.5, requests=reqs,
              trace=trace)
    run.profiled = [r for r in reqs if r.profiled]
    return run


def test_readers():
    run = _run()
    assert readers.nodes_per_s(run) == pytest.approx(4000 / 0.5)
    assert readers.latency_ms(run, 50) == pytest.approx(200.0)
    assert readers.graph_build_ms(run) == pytest.approx(20.0)
    assert readers.fw_calls_per_request(run) == pytest.approx(150.0)
    assert readers.ms_per_fw_call(run) == pytest.approx(80.0 / 100)
    assert readers.fw_roofline_pct(run) is None
    assert readers.device_idle_pct(run) is None
    assert 0 < readers.mfu_pct(run) < 100
    device_s = 400 * fused_mp_bound_s(3000, 18000) / 0.25
    trace = types.SimpleNamespace(
        busy_s=0.2, window_s=0.8,
        seconds_of=lambda frag: (device_s, 400))
    run = _run(trace)
    assert readers.fw_roofline_pct(run) == pytest.approx(25.0)
    assert readers.device_idle_pct(run) == pytest.approx(75.0)
