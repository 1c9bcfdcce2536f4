"""Port profiling (``psignn_tpu_torch.profiling``: ``EdgeThroughput``,
``timed``, ``trace``) against the JAX package's ``profiling`` on the CPU,
and the entry point ``psignn_tpu_torch.entry`` against
``__graft_entry__``'s samples.  ``EdgeThroughput`` is arithmetic: equal
reports; the entry's samples are the same numbers: equal arrays."""

import json
import os
import time

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from psignn_tpu import profiling as jprofiling
from psignn_tpu_torch import entry, profiling


@pytest.mark.parametrize("directions,n_layers,baseline", [
    (2, 1, None), (3, 1, 1.5e8), (2, 3, 2e7)])
def test_edge_throughput_report_matches_jax(directions, n_layers, baseline):
    args = (76_353, directions, n_layers)
    got = profiling.EdgeThroughput(*args).report(531, 0.51, baseline)
    want = jprofiling.EdgeThroughput(*args).report(531, 0.51, baseline)
    assert got == want


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
