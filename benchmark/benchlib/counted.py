"""Readers over what the program counts itself: its f_θ evaluations
(``psignn_tpu_torch.models.psignn.F_CALLS``, which the carried loop's
replays advance) as the mixed sweep's requests record them, and the
data-parallel training cell's per-rank counts and rank 0's all-reduce
spans.  The readers in ``readers.py`` count an evaluation as two
forward-kernel launches, which holds for the Dirichlet f_θ only (the
mixed one launches three).  Each returns None when the run holds nothing
to read: a program without the count, or a run without a traced slice.
"""

from __future__ import annotations

from .roofline import PEAK_F32_FLOPS, fused_mp_flops


def _counted(requests):
    """The requests' f_θ evaluations, or None if any went uncounted."""
    calls = [getattr(r, "f_calls", None) for r in requests]
    return None if not calls or None in calls else calls


def f_calls_per_request(run):
    """Evaluations of f_θ a request, over every request of the window."""
    calls = _counted(run.requests)
    return None if calls is None else sum(calls) / len(calls)


def ms_per_f_call(run):
    """Host ms of the solve (request less graph span) per counted
    evaluation of f_θ, over the requests outside the profiled slice."""
    reqs = run.timed
    calls = _counted(reqs)
    if calls is None or sum(calls) <= 0:
        return None
    return sum(r.seconds - r.graph_s for r in reqs) / sum(calls) * 1e3


def mfu_pct(run):
    """Model operations of every request of the window (the
    configuration's reference counts them from shapes and the counted
    evaluations of f_θ) over the window's seconds, as a share of the
    H100's f32 peak outside the tensor cores."""
    calls = _counted(run.requests)
    if calls is None or run.window_s <= 0:
        return None
    cfg = run.config["model"]
    d = cfg["latent_dim"]
    flops = sum(run.reference.request_flops(
        cfg, r.n, r.e, c, lambda n, e: fused_mp_flops(n, e, d))
        for r, c in zip(run.requests, calls))
    return 100.0 * flops / run.window_s / PEAK_F32_FLOPS


def allreduce_ms_per_step(run):
    """Σ ms of rank 0's ``dp.allreduce`` spans (the all-reduce of the
    gradients and its wait for the other ranks) over the traced slice's
    steps."""
    ms = getattr(run, "allreduce_ms", None)
    steps = [s for s in run.steps if s.profiled]
    if not ms or not steps:
        return None
    return sum(ms) / len(steps)


def f_calls_spread_per_step(run):
    """The mean over the window's steps of the largest less the smallest
    rank's count of f_θ evaluations in the step: the forward solves'
    imbalance, which the all-reduce waits out."""
    per_rank = getattr(run, "rank_f_calls", None)
    if not per_rank or any(c is None for c in per_rank):
        return None
    steps = list(zip(*per_rank))
    if not steps:
        return None
    return sum(max(s) - min(s) for s in steps) / len(steps)
