"""The program's spans on the card, under the benchmark's own profiler
session (``devtrace.Slice``, device activity only): the recorder is on
there, the spans and the device trace share one clock, and the carried
loop's capture spans are its captures.  Every test needs the card."""

import os
import time

import numpy as np
import pytest
import torch

from benchmark.benchlib import devtrace, gen


def _new(first):
    from psignn_tpu_torch import profiling
    return profiling.recorded()[first:]


@pytest.mark.chip
def test_the_recorder_is_on_under_a_cuda_only_session(cuda):
    from psignn_tpu_torch import profiling
    first = len(profiling.recorded())
    with profiling.span("infer"):
        pass
    slice_ = devtrace.Slice(cuda)
    slice_.start()
    assert torch.autograd.profiler._is_profiler_enabled
    with profiling.span("infer"):
        torch.ones(8, device=cuda).sum()
    slice_.stop()
    with profiling.span("infer"):
        pass
    assert [r.name for r in _new(first)] == ["infer"]


@pytest.mark.chip
def test_a_host_sleep_in_a_span_is_the_device_gap_inside_it(cuda):
    """20 ms of host sleep inside a span, between two kernels: the
    device's longest idle gap has its middle inside the span, on the
    profiler's clock."""
    from psignn_tpu_torch import profiling
    x = torch.randn(512, 512, device=cuda)
    first = len(profiling.recorded())
    slice_ = devtrace.Slice(cuda)
    slice_.start()
    x @ x
    torch.cuda.synchronize(cuda)
    with profiling.span("planted.sleep"):
        time.sleep(0.02)
        x @ x
    slice_.stop()
    (rec,) = _new(first)
    s = devtrace.summarize(slice_.prof, slice_.window_s,
                           [(rec.name, rec.start, rec.end)],
                           slice_._start_ns)
    label, seconds = s.gaps[0]
    assert label == "planted.sleep" and seconds >= 0.02


@pytest.mark.chip
def test_capture_spans_are_the_loops_captures(cuda):
    """A radius-5 request's forward solve: one ``loop.capture`` span a
    captured graph, their time ``capture_s`` to within 1 µs, and one
    ``loop.read`` span a read of ``done``."""
    from psignn_tpu_torch import profiling
    from psignn_tpu_torch.deq import fixed_point_forward
    from psignn_tpu_torch.dist.partition import rcm_ordered
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.graphs import batch_graphs
    from benchmark.benchlib.spec import ROOT, load_cell

    config = load_cell("psignn_dirichlet.sweep").config
    _, _, cfg, model = load_predictor(
        os.path.join(ROOT, config["checkpoint"]), cuda)
    rng = np.random.default_rng(5)
    sample = gen.psignn_sample_from_fem(gen.solve_poisson(
        gen.blob_mesh(5.0, 0.08, rng), 5.0, rng))
    graph = batch_graphs([rcm_ordered(sample)], device=cuda)
    with torch.no_grad():
        h0 = model.encoder(graph.x) * graph.fnode_mask
    first = len(profiling.recorded())
    slice_ = devtrace.Slice(cuda)
    slice_.start()
    out = fixed_point_forward(model.function, h0, graph, cfg.deq)
    slice_.stop()
    spans = _new(first)
    captures = [r for r in spans if r.name == "loop.capture"]
    assert out.graphs >= 1 and len(captures) == out.graphs
    assert abs(sum(r.ms for r in captures) - out.capture_s * 1e3) <= 1e-3
    reads = [r for r in spans if r.name == "loop.read"]
    assert len(reads) == out.host_reads - 1      # and the result's read
    (fw,) = [r for r in spans if r.name == "deq.forward"]
    assert all(r.root == fw.root for r in spans)


@pytest.mark.chip
def test_the_adjoint_on_the_backward_thread_joins_the_step(cuda):
    """On the card autograd runs the adjoint solve's hook on its device
    thread: its spans take the training step's root."""
    import threading
    from psignn_tpu_torch import entry, profiling
    from psignn_tpu_torch.graphs import batch_graphs
    from psignn_tpu_torch.models import Psignn, PsignnConfig
    from psignn_tpu_torch.train.optim import make_optimizers
    from psignn_tpu_torch.train.step import train_step

    cfg = PsignnConfig(**entry.ENTRY_CFG)
    model = Psignn(cfg, generator=torch.Generator().manual_seed(0),
                   device=cuda)
    graph = batch_graphs(entry.tiny_samples(), device=cuda)
    opts = make_optimizers(model, 0.01, 0.05)
    first = len(profiling.recorded())
    slice_ = devtrace.Slice(cuda)
    slice_.start()
    train_step(model, opts, graph, cfg, (0.01, 0.05), 0.1, 1.0,
               torch.Generator().manual_seed(1))
    slice_.stop()
    spans = _new(first)
    (step,) = [r for r in spans if r.name == "train.step"]
    (adjoint,) = [r for r in spans if r.name == "deq.adjoint"]
    assert adjoint.root == step.root
    assert adjoint.thread != threading.get_native_id()
    assert step.start < adjoint.start and adjoint.end < step.end
    assert any(r.parent is adjoint and r.name == "solver.read"
               for r in spans)
