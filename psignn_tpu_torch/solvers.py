"""Fixed-point solvers: Broyden.

Port of ``psignn_tpu/solvers.py:broyden`` (the reference's
``utilities/solver.py:116-207``).  JAX runs it as a ``lax.while_loop`` with
fixed-shape, step-blocked rank buffers; here the loop is host-driven, the
live rank is a Python integer, and the rank-1 factors live in
preallocated ``(threshold, d)`` buffers used through ``[:nstep]`` slices.
One small host read per iteration fetches the two residual norms that the
stop tests need.  Kept exactly:

* rel/abs stop modes, ``rel = ‖g‖ / (‖g + x‖ + 1e-9)``;
* best-iterate tracking, ``nstep`` = the step of the best iterate;
* the plateau break (last-30 window max/min < 1.3 once under 3·eps, after
  step 30) and divergence protection (``diff > first·1e3·D``);
* NaN/inf scrubbing of the rank-1 factors u and vᵀ;
* unvisited trace entries padded with the lowest value.

Anderson, Picard and Newton are not ported yet: ``get_solver`` names them.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch


class SolverResult(NamedTuple):
    result: torch.Tensor           # best iterate, shape of x0
    lowest: float                  # best stop-mode residual
    nstep: int                     # step index of the best iterate
    prot_break: bool               # divergence protection fired
    abs_trace: torch.Tensor        # (threshold,) float32, CPU
    rel_trace: torch.Tensor        # (threshold,) float32, CPU
    trace: Optional[torch.Tensor]  # (threshold+1, *x0.shape) iterates, or None
    trace_len: int                 # number of valid entries in `trace`


_F32 = np.float32


def broyden(f: Callable, x0: torch.Tensor, threshold: int = 50,
            eps: float = 1e-3, stop_mode: str = "rel",
            keep_trace: bool = False) -> SolverResult:
    """Broyden quasi-Newton root finder for g(x) = f(x) − x.

    The inverse Jacobian is −I + U Vᵀ with one rank-1 pair per step
    (``rmatvec`` xᵀ(−I + UVᵀ), ``matvec`` (−I + UVᵀ)x).  Scalars that steer
    the loop are compared in float32, as the JAX loop does."""
    if stop_mode not in ("rel", "abs"):
        raise ValueError(stop_mode)
    shape = x0.shape
    d = x0.numel()
    T = int(threshold)
    big = _F32(1e8)
    seq_len = shape[-1] if x0.dim() > 1 else 1
    protect_thres = _F32((1e6 if stop_mode == "abs" else 1e3) * seq_len)
    eps32 = _F32(eps)

    def g(xf):
        return f(xf.reshape(shape)).reshape(-1) - xf

    x = x0.reshape(-1)
    gx = g(x)
    Us = torch.empty((T, d), dtype=x0.dtype, device=x0.device)
    VTs = torch.empty((T, d), dtype=x0.dtype, device=x0.device)
    update = gx
    abs_trace = np.zeros(T, _F32)
    rel_trace = np.zeros(T, _F32)
    stop_trace = rel_trace if stop_mode == "rel" else abs_trace
    lowest, lowest_alt = big, big
    lowest_x, lowest_step = x, 0
    prot_break = False
    trace: List[torch.Tensor] = [x0.clone()] if keep_trace else []

    nstep = 0
    while nstep < T:
        x_new = x + update
        gx_new = g(x_new)
        nstep += 1
        k = nstep - 1                      # stored rank-1 pairs

        norms = torch.stack([torch.linalg.vector_norm(gx_new),
                             torch.linalg.vector_norm(gx_new + x_new)])

        # rank-1 update, enqueued before the host read so the device has
        # the work in hand while the host waits
        delta_x = x_new - x
        delta_gx = gx_new - gx
        U, V = Us[:k], VTs[:k]
        ra = (U @ delta_x) @ V                                 # (d,)
        mv2 = (V @ torch.stack([delta_gx, gx_new]).T).T @ U    # (2, d)
        vT = -delta_x + ra                                     # rmatvec(Δx)
        denom = torch.dot(vT, delta_gx)
        mv_dgx = -delta_gx + mv2[0]                            # matvec(Δg)
        mv_gx = -gx_new + mv2[1]                               # matvec(g_new)
        u = (delta_x - mv_dgx) / denom
        vT = torch.nan_to_num(vT, nan=0.0, posinf=0.0, neginf=0.0)
        u = torch.nan_to_num(u, nan=0.0, posinf=0.0, neginf=0.0)
        Us[k] = u
        VTs[k] = vT
        update = -(mv_gx + u * torch.dot(vT, gx_new))

        ab_t, den_t = norms.cpu().numpy()
        ab = _F32(ab_t)
        rel = _F32(ab / _F32(den_t + _F32(1e-9)))
        diff, alt = (rel, ab) if stop_mode == "rel" else (ab, rel)
        abs_trace[k] = ab
        rel_trace[k] = rel
        if keep_trace:
            trace.append(x_new.reshape(shape))

        if diff < lowest:
            lowest, lowest_x, lowest_step = diff, x_new, nstep
        if alt < lowest_alt:
            lowest_alt = alt

        win = stop_trace[max(nstep - 30, 0):nstep]
        with np.errstate(divide="ignore", invalid="ignore"):
            flat = win.max() / win.min() < _F32(1.3)
        plateau = diff < 3 * eps32 and nstep > 30 and flat
        prot = diff > stop_trace[0] * protect_thres
        prot_break |= bool(prot)
        x, gx = x_new, gx_new
        if diff < eps32 or plateau or prot:
            break

    # pad unvisited trace entries with the lowest value
    low_rel, low_abs = ((lowest, lowest_alt) if stop_mode == "rel"
                        else (lowest_alt, lowest))
    rel_trace[nstep:] = low_rel
    abs_trace[nstep:] = low_abs

    full_trace = None
    if keep_trace:
        full_trace = torch.zeros((T + 1,) + tuple(shape), dtype=x0.dtype,
                                 device=x0.device)
        full_trace[:len(trace)] = torch.stack(trace)

    return SolverResult(
        result=lowest_x.reshape(shape), lowest=float(lowest),
        nstep=int(lowest_step), prot_break=prot_break,
        abs_trace=torch.from_numpy(abs_trace),
        rel_trace=torch.from_numpy(rel_trace),
        trace=full_trace, trace_len=nstep + 1)


SOLVERS = {"broyden": broyden}
NOT_YET_PORTED = ("anderson", "forward_iteration", "picard", "newton",
                  "newton_krylov")


def get_solver(name: str) -> Callable:
    """Solver by flag name."""
    if name in SOLVERS:
        return SOLVERS[name]
    if name in NOT_YET_PORTED:
        raise NotImplementedError(f"solver '{name}' is not yet ported")
    raise ValueError(f"unknown solver '{name}'; choose from {list(SOLVERS)}")
