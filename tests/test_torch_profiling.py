"""Port profiling (``psignn_tpu_torch.profiling``): the program's spans,
recorded only under a ``torch.profiler`` session, where the port puts
them (graph build, entry points, solves, carried loop, training step)
and in ``trace``'s Chrome trace; ``timed``, ``trace``, the device-event
readers; and the entry point ``psignn_tpu_torch.entry`` against
``__graft_entry__``'s samples (the same numbers: equal arrays)."""

import contextlib
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import __graft_entry__ as jentry
from psignn_tpu_torch import deq, entry, loop, profiling
from psignn_tpu_torch.dist.partition import rcm_ordered
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import Psignn, PsignnConfig, psignn_inference
from psignn_tpu_torch.train.optim import make_optimizers
from psignn_tpu_torch.train.step import train_step


@contextlib.contextmanager
def session():
    """A CPU ``torch.profiler`` session; yields the list that holds, once
    the block has run, the spans recorded in it."""
    first = len(profiling.recorded())
    got = []
    with profile(activities=[ProfilerActivity.CPU]):
        yield got
    got.extend(profiling.recorded()[first:])


def names(records):
    return [r.name for r in records]


def within(records, outer):
    """The records of ``records`` whose parent chain reaches ``outer``."""
    def inside(r):
        while r.parent is not None:
            if r.parent is outer:
                return True
            r = r.parent
        return False
    return [r for r in records if inside(r)]


@pytest.fixture(scope="module")
def tiny():
    """(model, cfg, graph): ``entry``'s seeded Ψ-GNN and tiny batch on the
    CPU, whose solves run the host loop there."""
    cfg = PsignnConfig(**entry.ENTRY_CFG)
    model = Psignn(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    return model, cfg, batch_graphs(entry.tiny_samples(), device="cpu")


def test_no_session_records_nothing(tiny):
    model, cfg, graph = tiny
    first = len(profiling.recorded())
    assert profiling.span("infer") is profiling.span("graph.rcm")
    psignn_inference(model, graph, cfg)
    profiling.closed_span("loop.capture", 0, 1)
    assert len(profiling.recorded()) == first


def test_inference_spans_nest_under_one_root(tiny):
    model, cfg, graph = tiny
    with session() as got:
        psignn_inference(model, graph, cfg)
    (root,) = [r for r in got if r.parent is None]
    assert root.name == "infer"
    children = [r for r in got if r.parent is root]
    assert names(children) == ["infer.encode", "deq.forward",
                               "infer.decode"]
    fw = children[1]
    reads = [r for r in got if r.parent is fw]
    assert reads and set(names(reads)) == {"solver.read"}
    assert len(got) == 1 + 3 + len(reads)
    assert {r.root for r in got} == {root.root}
    assert {r.thread for r in got} == {threading.get_native_id()}
    for r in got:
        assert r.start <= r.end
        if r.parent is not None:
            assert r.parent.start <= r.start and r.end <= r.parent.end
    for a, b in zip(children, children[1:]):
        assert a.end <= b.start


def test_carried_forward_records_its_chunks(tiny):
    model, cfg, graph = tiny
    h0 = model.encoder(graph.x).detach()
    with session() as got:
        out = deq.fixed_point_forward(model.function, h0, graph, cfg.deq,
                                      loop="while")
    (fw,) = [r for r in got if r.name == "deq.forward"]
    inner = [r for r in got if r.parent is fw]
    assert set(names(inner)) >= {"loop.eager", "loop.read"}
    assert names(inner).count("loop.read") == out.host_reads - 1
    assert names(inner).count("loop.eager") == out.host_reads - 1


def test_run_while_spans_match_loop_stats():
    carry = {"done": torch.tensor(False), "x": torch.zeros(())}

    def body(c, _static):
        c["x"] += 1

    with session() as got:
        stats = loop.run_while(body, carry, 10, chunk=4)
    assert stats == loop.LoopStats(10, 3, 0, 0.0) and float(carry["x"]) == 10
    assert names(got) == ["loop.eager", "loop.read"] * 3
    assert names(got).count("loop.read") == stats.host_reads
    assert names(got).count("loop.capture") == stats.graphs


def test_train_step_adjoint_reads(tiny, monkeypatch):
    model, cfg, graph = tiny
    model = Psignn(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    results = []

    def keep(out):
        results.append(out)
        return deq.SolveStats(out.lowest, out.nstep, out.calls, out.jvps)

    monkeypatch.setattr(deq, "solve_stats", keep)
    opts = make_optimizers(model, 0.01, 0.05)
    with session() as got:
        train_step(model, opts, graph, cfg, (0.01, 0.05), 0.1, 1.0,
                   torch.Generator().manual_seed(1))
    (step,) = [r for r in got if r.name == "train.step"]
    assert step.parent is None
    assert names([r for r in got if r.parent is step]) == [
        "train.forward", "train.backward", "train.optim", "train.read"]
    (adjoint,) = [r for r in got if r.name == "deq.adjoint"]
    assert adjoint.root == step.root
    reads = [r for r in got if r.parent is adjoint]
    assert set(names(reads)) == {"solver.read"}
    assert len(reads) == results[-1].host_reads > 0
    (fw,) = [r for r in got if r.name == "deq.forward"]
    assert len([r for r in got if r.parent is fw]) == results[0].host_reads
    assert "deq.jac" in names(within(got, step))


def test_graph_build_spans():
    sample = entry.tiny_samples(1)[0]
    with session() as got:
        batch_graphs([rcm_ordered(sample)], device="cpu")
    rcm, batch = [r for r in got if r.parent is None]
    assert (rcm.name, batch.name) == ("graph.rcm", "graph.batch")
    assert rcm.root != batch.root and rcm.end <= batch.start
    inner = [r for r in got if r.parent is batch]
    assert names(inner).count("graph.csr") == 1
    assert set(names(inner)) == {"graph.csr", "graph.copy"}
    assert names(inner).count("graph.copy") >= 15
    assert len(got) == 2 + len(inner)


def test_a_span_on_another_thread_takes_the_open_root():
    """The adjoint solve runs in an autograd hook on the card's backward
    thread: its spans, opened on an empty stack there, belong to the root
    span open on the caller's thread."""
    def worker():
        with profiling.span("deq.adjoint"):
            with profiling.span("solver.read"):
                pass

    with session() as got:
        with profiling.span("train.step"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
        assert not t.is_alive()
        with profiling.span("graph.rcm"):
            pass
    step, adjoint, read, rcm = got
    assert adjoint.parent is None and read.parent is adjoint
    assert adjoint.root == read.root == step.root != rcm.root
    assert adjoint.thread != step.thread


def test_closed_span_keeps_the_callers_reading():
    with session() as got:
        with profiling.span("deq.forward"):
            t0 = time.perf_counter_ns()
            time.sleep(0.002)
            t1 = time.perf_counter_ns()
            profiling.closed_span("loop.capture", t0, t1)
    fw, capture = got
    assert capture.parent is fw and capture.root == fw.root
    assert capture.end - capture.start == t1 - t0
    assert fw.start <= capture.start + 1000 and capture.end <= fw.end + 1000


def test_threads_recording_at_once_lose_nothing(monkeypatch):
    """Sixteen threads open nested spans at once past the cap: every span
    is kept or counted as dropped, and a kept span's parent is on its own
    thread."""
    monkeypatch.setattr(profiling, "CAP", len(profiling.recorded()) + 1000)
    dropped = profiling.DROPPED

    def work():
        for _ in range(100):
            with profiling.span("graph.batch"):
                with profiling.span("graph.copy"):
                    pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with session() as got:
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 1000 and profiling.DROPPED - dropped == 2200
    assert all(r.parent is None or r.parent.thread == r.thread for r in got)
    assert len({r.thread for r in got}) > 1


def test_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", len(profiling.recorded()) + 2)
    dropped = profiling.DROPPED
    with session() as got:
        for _ in range(5):
            with profiling.span("graph.copy"):
                pass
    assert names(got) == ["graph.copy"] * 2
    assert profiling.DROPPED - dropped == 3


def test_timed_is_best_of_reps():
    calls = []

    def fn(x):
        calls.append(time.perf_counter())
        time.sleep(0.002 if len(calls) > 2 else 0.02)
        return {"y": (x * 2,)}

    out, best = profiling.timed(fn, torch.ones(3), reps=3, warmup=2)
    assert len(calls) == 5 and torch.equal(out["y"][0], 2 * torch.ones(3))
    assert 0.002 <= best < 0.02


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = os.listdir(log_dir)
    events = json.loads((log_dir / path).read_text())["traceEvents"]
    assert any("mm" in ev.get("name", "") for ev in events)


def test_trace_writes_the_program_spans(tmp_path):
    """The spans of the block are host events of the trace on the
    profiler's time base, enclosing the operators launched inside them."""
    with profiling.span("infer"):
        pass                                    # no session: not written
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        with profiling.span("infer"):
            with profiling.span("deq.forward"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = os.listdir(log_dir)
    events = json.loads((log_dir / path).read_text())["traceEvents"]
    spans = {ev["name"]: ev for ev in events
             if ev.get("cat") == "program_span"}
    assert sorted(spans) == ["deq.forward", "infer"]
    (mm,) = [ev for ev in events if ev.get("name") == "aten::mm"]
    for outer, inner in ((spans["infer"], spans["deq.forward"]),
                         (spans["deq.forward"], mm)):
        assert (outer["pid"], outer["tid"]) == (inner["pid"], inner["tid"])
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_kernel_times_count_device_kernels_only():
    """``kernel_times`` sums the device's kernels and copies of a trace by
    name; ``record_function`` ranges on the device's timeline and the
    host's events are left out (``device_events``)."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, us, device=DeviceType.CUDA, annotation=False):
        span = SimpleNamespace(elapsed_us=lambda: us)
        return SimpleNamespace(name=name, device_type=device,
                               is_user_annotation=annotation,
                               time_range=span)

    prof = SimpleNamespace(events=lambda: [
        ev("fused_mp_fwd", 5.0), ev("fused_mp_fwd", 7.0), ev("memcpy", 1.5),
        ev("Optimizer.step#Adam.step", 900.0, annotation=True),
        ev("aten::mm", 40.0, device=DeviceType.CPU)])
    assert [e.name for e in profiling.device_events(prof)] == [
        "fused_mp_fwd", "fused_mp_fwd", "memcpy"]
    assert profiling.kernel_times(prof) == {"fused_mp_fwd": (12.0, 2),
                                            "memcpy": (1.5, 1)}


@pytest.mark.parametrize("host", [True, False])
def test_profiled_runs_once_and_times_it(host):
    calls = []
    prof, wall = profiling.profiled(lambda: calls.append(time.sleep(0.01)),
                                    host)
    assert calls == [None] and wall >= 0.01
    assert profiling.kernel_times(prof) == {}        # no card here


def test_entry_samples_and_forward():
    """The entry's samples are ``__graft_entry__``'s (same seeds, same
    meshes and normalisation); its forward runs and differentiates on the
    CPU, and without a device it needs the card."""
    got = entry.tiny_samples()
    want = jentry._tiny_samples()
    for g, w in zip(got, want):
        for k in ("x", "b", "sol", "prb_data", "tags", "pos", "senders",
                  "receivers", "a_ij", "edge_attr"):
            np.testing.assert_array_equal(np.asarray(g[k]).reshape(
                np.shape(w[k])), w[k], err_msg=k)
    fn, args = entry.entry("cpu")
    loss, u = fn(*args)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert u.shape == (args[1].total_nodes, 1)
    assert args[0].function.alpha.weight.grad is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            entry.entry()
