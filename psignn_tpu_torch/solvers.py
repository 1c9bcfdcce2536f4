"""Fixed-point solvers: Picard, Anderson, Broyden (with an optional Armijo
line search).

Port of ``psignn_tpu/solvers.py`` (the reference's
``utilities/solver.py``).  JAX runs each solver as a ``lax.while_loop``
with fixed-shape carries; here the loops are host-driven, with one small
host read per iteration (per line-search candidate) of the scalars that
steer them.  Those scalars are compared in float32, as the JAX loops do.
Broyden's live rank is a Python integer and its rank-1 factors live in
preallocated ``(threshold, d)`` buffers used through ``[:nstep]`` slices.
Kept exactly, solver by solver:

* ``broyden``: rel/abs stop modes, ``rel = ‖g‖ / (‖g + x‖ + 1e-9)``;
  best-iterate tracking, ``nstep`` = the step of the best iterate; the
  plateau break (last-30 window max/min < 1.3 once under 3·eps, after step
  30) and divergence protection (``diff > first·1e3·D``); NaN/inf
  scrubbing of the rank-1 factors u and vᵀ; unvisited trace entries padded
  with the lowest value; with ``ls=True`` the Armijo backtracking of each
  step (``_armijo_line_search``);
* ``anderson``: window 2, regulariser 1e-4, mixing β = 1, the bordered
  normal equations solved on the device in f32, best-iterate tracking;
  unvisited trace entries stay 0;
* ``picard`` (``forward_iteration``): z ← f(z) until the relative step
  norm is below eps, whatever ``stop_mode`` says; the last iterate is the
  result; unvisited trace entries stay 0.

``SolverResult.calls`` counts the evaluations of ``f``.  Newton and
Newton-Krylov, and the ``reduce`` / ``sync`` hooks of the JAX solvers
(which serve its multi-device solves), are not ported yet.
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
    trace: Optional[torch.Tensor]  # iterates (threshold+1 or +2, *x0.shape), or None
    trace_len: int                 # number of valid entries in `trace`
    calls: int                     # evaluations of f


_F32 = np.float32


class _Counted:
    """``f`` with a count of its calls."""

    def __init__(self, f: Callable):
        self.f, self.n = f, 0

    def __call__(self, x):
        self.n += 1
        return self.f(x)


def _host(*scalars: torch.Tensor) -> np.ndarray:
    """0-d device scalars as one float32 host array (one transfer)."""
    return torch.stack(scalars).cpu().numpy().astype(_F32)


def picard(f: Callable, x0: torch.Tensor, threshold: int = 50,
           eps: float = 1e-5, stop_mode: str = "rel",
           keep_trace: bool = False) -> SolverResult:
    """Plain fixed-point iteration z ← f(z), stopped when the relative step
    ‖z_prev − z‖ / ‖z‖ is at most eps or after ``threshold`` steps; the
    reference ignores ``stop_mode`` here, and so does this port.  The
    result is the last iterate, ``nstep`` the number of steps after the
    first evaluation."""
    del stop_mode
    f = _Counted(f)
    shape = x0.shape
    T = int(threshold)
    eps32 = _F32(eps)
    abs_trace = np.zeros(T + 1, _F32)
    rel_trace = np.zeros(T + 1, _F32)

    def step(z_prev, ite):
        z = f(z_prev.reshape(shape)).reshape(-1)
        ab, nz = _host(torch.linalg.vector_norm(z_prev - z),
                       torch.linalg.vector_norm(z))
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = _F32(ab / nz)
        abs_trace[ite], rel_trace[ite] = ab, rel
        return z, rel

    z, rel = step(x0.reshape(-1), 0)
    trace: List[torch.Tensor] = [x0.clone(), z.reshape(shape)] \
        if keep_trace else []
    ite = 0
    while rel > eps32 and ite < T:
        ite += 1
        z, rel = step(z, ite)
        if keep_trace:
            trace.append(z.reshape(shape))

    full_trace = None
    if keep_trace:
        full_trace = torch.zeros((T + 2,) + tuple(shape), dtype=x0.dtype,
                                 device=x0.device)
        full_trace[:len(trace)] = torch.stack(trace)
    return SolverResult(
        result=z.reshape(shape), lowest=float(rel), nstep=ite,
        prot_break=False, abs_trace=torch.from_numpy(abs_trace[:T]),
        rel_trace=torch.from_numpy(rel_trace[:T]), trace=full_trace,
        trace_len=ite + 2, calls=f.n)


forward_iteration = picard


# Anderson's window and Tikhonov regulariser, and its mixing β = 1, as the
# JAX package's defaults (solvers.py:165-167; no caller sets others)
ANDERSON_WINDOW = 2
ANDERSON_LAM = 1e-4


def anderson(f: Callable, x0: torch.Tensor, threshold: int = 50,
             eps: float = 1e-3, stop_mode: str = "rel",
             keep_trace: bool = False) -> SolverResult:
    """Anderson acceleration: each step mixes the last two evaluations
    F_i = f(X_i) with the weights α of the regularised least-squares
    problem min ‖Σ α_i (F_i − X_i)‖² + lam‖α‖², Σ α_i = 1, solved on the
    device as its 3×3 bordered normal equations, and x = Σ α_i F_i.
    ``rel = ‖g‖ / (1e-5 + ‖f(x)‖)``; the best iterate is the result,
    ``nstep`` its step."""
    if stop_mode not in ("rel", "abs"):
        raise ValueError(stop_mode)
    f = _Counted(f)
    shape = x0.shape
    m = ANDERSON_WINDOW
    T = int(threshold)
    eps32 = _F32(eps)
    dt, dev = x0.dtype, x0.device

    X = torch.stack([x0.reshape(-1), f(x0).reshape(-1)])
    F = torch.stack([X[1], f(X[1].reshape(shape)).reshape(-1)])

    abs_trace = np.zeros(T, _F32)
    rel_trace = np.zeros(T, _F32)
    lowest, lowest_x, lowest_step = _F32(1e8), x0.reshape(-1), 0
    trace = torch.zeros((T + 1,) + tuple(shape), dtype=dt, device=dev) \
        if keep_trace else None
    if keep_trace:
        trace[0] = x0
    lam_eye = ANDERSON_LAM * torch.eye(m, dtype=dt, device=dev)
    H = torch.zeros((m + 1, m + 1), dtype=dt, device=dev)
    H[0, 1:] = 1.0
    H[1:, 0] = 1.0
    rhs = torch.zeros(m + 1, dtype=dt, device=dev)
    rhs[0] = 1.0

    k = 2
    while k < T:
        G = F - X
        H[1:, 1:] = G @ G.T + lam_eye
        alpha = torch.linalg.solve(H, rhs)[1:]
        xk = alpha @ F
        fk = f(xk.reshape(shape)).reshape(-1)
        X[k % m] = xk
        F[k % m] = fk

        ab, nfk = _host(torch.linalg.vector_norm(fk - xk),
                        torch.linalg.vector_norm(fk))
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = _F32(ab / _F32(_F32(1e-5) + nfk))
        diff = rel if stop_mode == "rel" else ab
        if diff < lowest:
            lowest, lowest_x, lowest_step = diff, xk, k
        abs_trace[k - 2] = ab
        rel_trace[k - 2] = rel
        if keep_trace:
            # the reference appends the running best each step
            trace[k - 1] = lowest_x.reshape(shape)
        k += 1
        if diff < eps32:
            break

    return SolverResult(
        result=lowest_x.reshape(shape), lowest=float(lowest),
        nstep=int(lowest_step), prot_break=False,
        abs_trace=torch.from_numpy(abs_trace),
        rel_trace=torch.from_numpy(rel_trace), trace=trace,
        trace_len=k - 1, calls=f.n)


# Armijo's sufficient-decrease constant and smallest step (solver.py:20-94)
ARMIJO_C1 = 1e-4
ARMIJO_AMIN = 1e-2


def _armijo_line_search(g: Callable, x0: torch.Tensor, gx0: torch.Tensor,
                        update: torch.Tensor):
    """Armijo backtracking on φ(s) = ‖g(x0 + s·update)‖² with
    φ'(0) = −φ(0) (the reference's heuristic, solver.py:20-94): try s = 1,
    then the quadratic interpolant's minimiser, then cubic interpolation
    with the reference's halving safeguard, until the first Wolfe
    condition holds or the step falls below ``ARMIJO_AMIN`` (then s = 1).
    Returns (x_new, gx_new); each candidate costs one ``g`` and one host
    read.  The quadratic candidate is evaluated only when s = 1 fails: the
    JAX loop evaluates it always and then ignores it."""
    F32 = _F32
    c1 = F32(ARMIJO_C1)

    def phi_eval(s):
        x = x0 + float(s) * update
        gx = g(x)
        ph, nonfin = _host(torch.dot(gx, gx),
                           (~torch.isfinite(gx)).sum().to(gx.dtype))
        return (ph if nonfin == 0 else F32(np.inf)), x, gx

    with np.errstate(all="ignore"):
        (phi0,) = _host(torch.dot(gx0, gx0))
        derphi0 = -phi0
        phi_1, x_1, gx_1 = phi_eval(F32(1.0))
        if phi_1 <= phi0 + c1 * derphi0:
            return x_1, gx_1
        # quadratic interpolant's minimiser (solver.py:27)
        a0 = F32(1.0)
        a1 = F32(F32(-derphi0 / F32(2.0)) / (phi_1 - phi0 - derphi0))
        pa0 = phi_1
        pa1, _, _ = phi_eval(a1)
        while a1 > F32(ARMIJO_AMIN):
            factor = a0 * a0 * (a1 * a1) * (a1 - a0)
            t1 = pa1 - phi0 - derphi0 * a1
            t0 = pa0 - phi0 - derphi0 * a0
            A = (a0 * a0 * t1 - a1 * a1 * t0) / factor
            B = (-(a0 * (a0 * a0)) * t1 + a1 * (a1 * a1) * t0) / factor
            a2 = (-B + np.sqrt(np.abs(B * B - F32(3.0) * A * derphi0))) \
                / (F32(3.0) * A)
            pa2, x2, gx2 = phi_eval(a2)
            if pa2 <= phi0 + c1 * a2 * derphi0:
                return x2, gx2
            # the halving safeguard, with φ kept from the unguarded α2
            # (solver.py:50-56)
            if (a1 - a2) > a1 / F32(2.0) or (F32(1.0) - a2 / a1) < F32(0.96):
                a2 = a1 / F32(2.0)
            a0, a1, pa0, pa1 = a1, a2, pa1, pa2
    return x_1, gx_1


def broyden(f: Callable, x0: torch.Tensor, threshold: int = 50,
            eps: float = 1e-3, stop_mode: str = "rel",
            keep_trace: bool = False, ls: bool = False) -> SolverResult:
    """Broyden quasi-Newton root finder for g(x) = f(x) − x.

    The inverse Jacobian is −I + U Vᵀ with one rank-1 pair per step
    (``rmatvec`` xᵀ(−I + UVᵀ), ``matvec`` (−I + UVᵀ)x).  ``ls=True``
    backtracks each step with ``_armijo_line_search``."""
    if stop_mode not in ("rel", "abs"):
        raise ValueError(stop_mode)
    f = _Counted(f)
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
        if ls:
            x_new, gx_new = _armijo_line_search(g, x, gx, update)
        else:
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
        trace=full_trace, trace_len=nstep + 1, calls=f.n)


SOLVERS = {
    "broyden": broyden,
    "anderson": anderson,
    "forward_iteration": picard,
    "picard": picard,
}
NOT_YET_PORTED = ("newton", "newton_krylov")


def get_solver(name: str) -> Callable:
    """Solver by flag name."""
    if name in SOLVERS:
        return SOLVERS[name]
    if name in NOT_YET_PORTED:
        raise NotImplementedError(f"solver '{name}' is not yet ported")
    raise ValueError(f"unknown solver '{name}'; choose from {list(SOLVERS)}")
