"""The arithmetic of the metric readers in ``metrics/``: each file there
names one metric and reads it with one of these.  Each returns None when
the run holds nothing to read."""

from __future__ import annotations

import numpy as np

from .roofline import PEAK_F32_FLOPS, fused_mp_bound_s, fused_mp_flops


def nodes_per_s(run):
    """Mesh nodes of every request completed in the window over the
    window's seconds (host clock)."""
    if not run.requests or run.window_s <= 0:
        return None
    return sum(r.n for r in run.requests) / run.window_s


def latency_ms(run, q: float):
    """The ``q``-th percentile (numpy's linear interpolation) of the
    latency of every request of the window, each timed whole."""
    if not run.requests:
        return None
    return float(np.percentile([r.seconds for r in run.requests], q)) * 1e3


def graph_build_ms(run):
    """Mean host ms a request spends on the program's node order, graph
    build and copy to the card (the span before the predictor), over the
    requests outside the profiled slice."""
    reqs = run.timed
    if not reqs:
        return None
    return sum(r.graph_s for r in reqs) / len(reqs) * 1e3


def fw_calls_per_request(run):
    """Evaluations of f_θ a request, from the program's forward-kernel
    launch counter (two launches an evaluation, one a direction)."""
    if not run.requests:
        return None
    return sum(r.fw_launches for r in run.requests) / 2 / len(run.requests)


def ms_per_fw_call(run):
    """Host ms of the solve (request less graph span) per evaluation of
    f_θ, over the requests outside the profiled slice."""
    reqs = run.timed
    calls = sum(r.fw_launches for r in reqs) / 2
    if not reqs or calls <= 0:
        return None
    return sum(r.seconds - r.graph_s for r in reqs) / calls * 1e3


def fw_roofline_pct(run):
    """Σ over the profiled slice's requests of launches × the frozen least
    time of one forward call at the request's (n, e), over the device time
    of the kernels whose name holds ``fused_mp_fwd`` (CUPTI names a
    replayed one ``(anonymous namespace)::fused_mp_fwd_kernel<…>``)."""
    if run.trace is None:
        return None
    seconds, count = run.trace.seconds_of("fused_mp_fwd")
    launches = sum(r.fw_launches for r in run.profiled)
    if seconds <= 0 or launches == 0:
        return None
    d = run.config["model"]["latent_dim"]
    least = sum(r.fw_launches * fused_mp_bound_s(r.n, r.e, d)
                for r in run.profiled)
    # a trace that lost kernels (CUPTI can drop a few) is held to the
    # least time of the kernels it kept
    return 100.0 * least * (count / launches) / seconds


def mfu_pct(run):
    """Model operations of every request of the window (the
    configuration's reference counts them from shapes and the counted f_θ
    evaluations) over the window's seconds, as a share of the H100's f32
    peak outside the tensor cores."""
    if not run.requests or run.window_s <= 0:
        return None
    cfg = run.config["model"]
    d = cfg["latent_dim"]
    flops = sum(run.reference.request_flops(
        cfg, r.n, r.e, r.fw_launches // 2,
        lambda n, e: fused_mp_flops(n, e, d)) for r in run.requests)
    return 100.0 * flops / run.window_s / PEAK_F32_FLOPS


def device_idle_pct(run):
    """Share of the profiled slice (host clock, the card synced at both
    ends) in which no kernel or copy ran on the card (the union of their
    intervals)."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def samples_per_s(run):
    """Samples (meshes) of every training step completed in the window
    over the window's seconds (host clock)."""
    if not run.steps or run.window_s <= 0:
        return None
    return sum(s.samples for s in run.steps) / run.window_s


def calls_per_step(run, kind: str):
    """Evaluations a training step of f_θ (``kind`` "fw": forward-kernel
    launches) or of its VJP (``kind`` "bw": backward-kernel launches),
    two launches each, from the program's counters."""
    if not run.steps:
        return None
    return sum(getattr(s, kind + "_launches") for s in run.steps) / 2 \
        / len(run.steps)
