"""One Ψ-GNN training step on the card with the adjoint solve on the
carried loop (one-step CUDA graphs, the route's default there) against
the same step with the adjoint solve on the host loop.  The file imports
no JAX; it needs a CUDA card and skips without one:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_adjoint_card.py

Tolerance of the gradients, with its reason: neither adjoint solve
reaches ``bw_tol`` 1e-8; each stops at the threshold, 500 Broyden steps,
at its best iterate, and the two loops sum the rank products in other
orders (the carried one over whole zeroed blocks), so their iterates part
by f32 round-off grown through the secant updates.  Both best iterates lie
near 8e-8 in relative residual (the CPU's eager chunks against its host
loop at 8 meshes of this batch: 7.98e-8 and 7.94e-8, every leaf's
gradient within 1.4e-6), so each leaf's clipped gradient is held to 1e-3
of max(its norm, the median leaf's norm), the benchmark's ``grad_gap``
measure, whose limit against the plain reference is 0.3.
"""

import numpy as np
import pytest
import torch

from psignn_tpu_torch import bench, solvers
from psignn_tpu_torch.kernels import fused_mp

TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the carried loop's graphs need one")
    return torch.device("cuda:0")


def test_carried_adjoint_step_matches_host_loop_adjoint(cuda, monkeypatch):
    graph = bench.train_batch(bench.TRAIN_MESHES, device=cuda, rcm=True)
    model, cfg, init = bench.trained_model(cuda, bench.TRAIN_OVERRIDES)
    real = solvers.SOLVERS["broyden"]
    bench.step_from(model, cfg, init, graph)            # warm-up
    runs = {}
    for lp in ("while", "host"):
        adjoint = []

        def spy(f, x0, **kw):
            is_adjoint = kw.get("eps") == cfg.bw_tol
            if is_adjoint and lp == "host":
                kw["loop"] = "host"
            out = real(f, x0, **kw)
            if is_adjoint:
                adjoint.append(out)
            return out

        monkeypatch.setitem(solvers.SOLVERS, "broyden", spy)
        before = fused_mp.BWD_LAUNCHES
        res, _ = bench.step_from(model, cfg, init, graph)
        runs[lp] = dict(
            res=res, adjoint=adjoint, bwd=fused_mp.BWD_LAUNCHES - before,
            grads={k: p.grad.detach().cpu().clone()
                   for k, p in model.named_parameters()})
    carried, host = runs["while"], runs["host"]
    assert len(carried["adjoint"]) == len(host["adjoint"]) == 1
    assert carried["adjoint"][0].graphs >= 1
    assert host["adjoint"][0].graphs == 0
    assert carried["adjoint"][0].host_reads < host["adjoint"][0].host_reads
    assert carried["bwd"] == host["bwd"] > 0
    assert carried["res"].bw.calls == host["res"].bw.calls
    norms = {k: float(g.norm()) for k, g in host["grads"].items()}
    median = float(np.median(list(norms.values())))
    for k, g in host["grads"].items():
        gap = float((carried["grads"][k] - g).norm()) / max(norms[k], median)
        assert gap <= TOL, (k, gap)
