"""Deep-equilibrium forward solve.

Port of ``DEQConfig`` and ``fixed_point_forward`` (``psignn_tpu/deq.py``).
The forward fixed point runs under ``torch.no_grad()``: its result is data
to whatever consumes it.  ``deq_attach`` (the implicit-gradient backward
solve) and the Jacobian loss come with the training slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .solvers import SolverResult, get_solver


class DEQConfig(NamedTuple):
    """Solver knobs (reference ``config_deq``)."""
    solver: str = "broyden"
    fw_tol: float = 1e-5
    fw_thres: int = 300


def fixed_point_forward(f: Callable, h_init: torch.Tensor, graph,
                        cfg: DEQConfig, keep_trace: bool = False
                        ) -> SolverResult:
    """Solve h* = f(h*, h_init, graph) with ``cfg.solver`` from h_init."""
    solver = get_solver(cfg.solver)
    with torch.no_grad():
        h0 = h_init.detach()
        return solver(lambda h: f(h, h0, graph), h0, threshold=cfg.fw_thres,
                      eps=cfg.fw_tol, keep_trace=keep_trace)
