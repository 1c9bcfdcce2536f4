"""Fixed-point solvers: Picard, Anderson, Broyden (with an optional Armijo
line search), Newton and Newton-Krylov.

Port of ``psignn_tpu/solvers.py`` (the reference's
``utilities/solver.py``).  JAX runs each solver as a ``lax.while_loop``
with fixed-shape carries.  Here two loops exist:

* **carried** (``loop="while"``; ``broyden`` and ``picard``): JAX's form.
  The solver's whole state is a carry of preallocated device tensors, and
  one function (``_broyden_body``, ``_picard_body``) writes an iteration
  into it in place, the stop test, best iterate, plateau window,
  divergence guard and traces included, freezing every entry once the
  solve has stopped.  ``loop.run_while`` steps it in chunks of
  ``loop.CHUNK`` iterations, each step after the first chunk a replayed
  one-step CUDA graph on the card, with one host read of the stop flag a
  chunk.  Broyden's pairs live in zeroed rows, whole ``_LR_BLOCK``
  blocks of them, whose live blocks the products read, as JAX's
  ``fori_loop`` over live blocks does.
* **host** (``loop="host"``; every solver): the loop is driven from the
  host, with one small host read per iteration (per line-search
  candidate) of the scalars that steer it.  Broyden's live rank is then a
  Python integer and its pairs live in ``(cap, d)`` buffers used through
  ``[:live]`` slices.

``loop=None`` takes the carried loop for a CUDA tensor and the host loop
otherwise; the options the carried loop does not take (Broyden's line
search, lanes, ``reduce`` / ``sync``) take the host loop by name, and
raise with ``loop="while"``.  Anderson and the Newton solvers keep the
host loop.  Either way the scalars that steer a solve are compared in
float32, as the JAX loops do.
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
  result; unvisited trace entries stay 0;
* ``newton`` and ``newton_krylov``: ``picard`` on a Newton step of
  g(z) = f(z) − z, with the dense Jacobian (demo scale) or with JAX's
  single-restart batched GMRES (``_gmres``), whose matvec is a JVP.  Both
  take ``jvp(x, v)``, the derivative of f at x along v; by default it is
  forward-mode AD through f (``forward_jvp``).

Broyden also takes the JAX package's rank-memory options: ``max_rank``
caps its memory as a ring of the newest pairs, and ``lowrank_dtype``
stores the pairs in bfloat16 (see ``broyden``).

**Lanes.** Given ``lanes`` (a ``Lanes``: the rows of each of G independent
problems, contiguous in x0), each solver runs G solves at once, as the JAX
package's ``vmap`` over a stacked batch runs them: every lane has its own
norms, stop test, best iterate, step count, traces, plateau window and
divergence threshold, Broyden its own secant coefficients and Anderson its
own small system.  A lane that has stopped keeps its state exactly as it
was while the others go on; ``f`` is still evaluated once per iteration on
the whole state, so it must not couple the lanes (message passing never
crosses graphs).  Inside, the state is held padded, one row per lane, so
that every per-lane product is one batched matmul.  One host read per
iteration carries every lane's scalars.  With lanes, ``lowest``, ``nstep``,
``prot_break`` and ``trace_len`` are (G,) numpy arrays and the residual
traces (threshold, G); ``keep_trace`` is not taken.  Broyden's line
search runs per lane too, one step length each (``_armijo_lanes``).

**Groups of ranks.** ``reduce`` and ``sync`` are the JAX solvers' hooks
for a solve whose state is split over the ranks of a group (the
partitioned solve of ``dist/partitioned.py``).  ``reduce(t)`` returns the
tensor ``t`` of partial sums summed over the group; every inner product
goes through it: the norms, the non-finite test, Anderson's Gram matrix,
the line search's φ, Broyden's secant coefficients, its secant
denominator and its eviction products.  The partials of one stage share
one call, so that a Broyden step makes two.  Every scalar that steers a
loop is read on the host only after it was reduced, so every rank of the
group takes the same branch.  ``sync(go) -> bool`` is a global any() for
ranks whose ``f`` holds collectives that span more than their group: the
loop runs while any rank goes on, and a rank that has stopped evaluates
each step still (its collectives keep step with the others') but keeps
its state, as the JAX loops freeze their carries.  Lanes take neither.

``SolverResult.calls`` counts the evaluations of ``f`` (the carried loop's
frozen ones after its stop included), ``SolverResult.jvps`` the JVPs of
the Newton solvers (each evaluates ``f`` once more, on dual tensors, when
``jvp`` is the default), ``host_reads`` the reads of device values that
steered the solve, and ``graphs`` / ``capture_s`` the CUDA graphs that
the carried loop captured and the host seconds that took.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from . import profiling
from .loop import run_while


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
    jvps: int = 0                  # JVPs of f (Newton, Newton-Krylov)
    host_reads: int = 0            # device reads that steered the loop
    graphs: int = 0                # CUDA graphs captured (carried loop)
    capture_s: float = 0.0         # host seconds of their capture


class Lanes:
    """G independent problems in one state: the rows of lane g are
    ``[off_g, off_g + counts[g])`` of an (N, W) state, ``row_lane`` (N,)
    says which lane each row belongs to.  ``pad`` lays the state out as
    (G, n_max·W), one zero-padded row per lane; ``unpad`` inverts it."""

    def __init__(self, row_lane: torch.Tensor, counts: Sequence[int]):
        counts_np = np.asarray(counts, np.int64)
        self.G = len(counts_np)
        self.n_max = int(counts_np.max()) if self.G else 0
        dev = row_lane.device
        self.counts = torch.from_numpy(counts_np).to(dev)
        self.row_lane = row_lane
        off = torch.cumsum(self.counts, 0) - self.counts
        local = torch.arange(row_lane.shape[0], device=dev) - off[row_lane]
        self.rows = row_lane * self.n_max + local

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """(N, W) → (G, n_max·W), pad entries zero."""
        out = x.new_zeros((self.G * self.n_max,) + tuple(x.shape[1:]))
        out[self.rows] = x
        return out.reshape(self.G, -1)

    def unpad(self, xp: torch.Tensor, shape) -> torch.Tensor:
        """(G, n_max·W) → the (N, W) state of ``shape``."""
        return xp.reshape(self.G * self.n_max, -1)[self.rows].reshape(shape)

    def segment_sum(self, v: torch.Tensor) -> torch.Tensor:
        """(G,) sums of the per-row values ``v`` (N,) over each lane."""
        out = torch.zeros(self.G, dtype=v.dtype, device=v.device)
        return out.index_add_(0, self.row_lane, v)


_F32 = np.float32


class _Counted:
    """``f`` with a count of its calls."""

    def __init__(self, f: Callable):
        self.f, self.n = f, 0

    def __call__(self, *args):
        self.n += 1
        return self.f(*args)


# Reads of device values that steered a solver loop since the process
# started; each solver's result holds the reads its call made.
HOST_READS = 0


def _fetch(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: one read, counted, and the span
    ``solver.read``."""
    global HOST_READS
    HOST_READS += 1
    with profiling.span("solver.read"):
        return t.cpu()


def _host(*scalars: torch.Tensor) -> np.ndarray:
    """0-d device scalars (or (G,) lane vectors) as one float32 host array
    (one transfer)."""
    return _fetch(torch.stack(scalars)).numpy().astype(_F32)


def _counts_reads(solver: Callable) -> Callable:
    """``solver`` whose result's ``host_reads`` counts the reads the call
    made, those of the solvers it calls included."""
    @functools.wraps(solver)
    def counted(*args, **kwargs) -> SolverResult:
        start = HOST_READS
        out = solver(*args, **kwargs)
        return out._replace(host_reads=HOST_READS - start)
    return counted


def _lane_mask(active: np.ndarray, device) -> torch.Tensor:
    """(G, 1) bool mask of the lanes still stepping, on ``device``."""
    return torch.from_numpy(active).to(device)[:, None]


def _padded(f: Callable, lanes: Lanes, shape) -> Callable:
    """``f`` on the padded (G, C) layout of ``lanes``."""
    return lambda xp: lanes.pad(f(lanes.unpad(xp, shape)))


def _lane_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=1)


def _no_lane_options(name: str, lanes, keep_trace: bool, reduce=None,
                     sync=None):
    if lanes is not None and keep_trace:
        raise NotImplementedError(f"{name} with lanes takes no keep_trace")
    if lanes is not None and (reduce is not None or sync is not None):
        # JAX refuses --stacked_batch with data parallelism the same way
        raise NotImplementedError(f"{name} with lanes takes no reduce or "
                                  "sync")


def _go(sync: Optional[Callable], cont: bool) -> bool:
    """Whether a loop takes another step: ``cont``, or with ``sync`` the
    global any() of every rank's ``cont``."""
    return bool(cont) if sync is None else bool(sync(bool(cont)))


def _summed(reduce: Optional[Callable], t: torch.Tensor) -> torch.Tensor:
    """The partial sums ``t`` summed over the group (``t`` alone)."""
    return t if reduce is None else reduce(t)


def _norms(reduce: Optional[Callable], *vs: torch.Tensor) -> torch.Tensor:
    """The 2-norms of the flat vectors ``vs``: each over the whole state
    when it is split over a group (``reduce``), as √(Σ partial squares)."""
    if reduce is None:
        return torch.stack([torch.linalg.vector_norm(v) for v in vs])
    return torch.sqrt(reduce(torch.stack([torch.dot(v, v) for v in vs])))


@_counts_reads
def picard(f: Callable, x0: torch.Tensor, threshold: int = 50,
           eps: float = 1e-5, stop_mode: str = "rel",
           keep_trace: bool = False, lanes: Optional[Lanes] = None,
           reduce: Optional[Callable] = None,
           sync: Optional[Callable] = None,
           loop: Optional[str] = None) -> SolverResult:
    """Plain fixed-point iteration z ← f(z), stopped when the relative step
    ‖z_prev − z‖ / ‖z‖ is at most eps or after ``threshold`` steps; the
    reference ignores ``stop_mode`` here, and so does this port.  The
    result is the last iterate, ``nstep`` the number of steps after the
    first evaluation.  ``reduce`` / ``sync``, ``loop``: see the module
    docstring."""
    del stop_mode
    _no_lane_options("picard", lanes, keep_trace, reduce, sync)
    if resolve_loop("picard", loop, x0, lanes=lanes is not None,
                    reduce=reduce is not None,
                    sync=sync is not None) == "while":
        return _picard_while(f, x0, int(threshold), eps, keep_trace)
    if lanes is not None:
        return _picard_lanes(f, x0, int(threshold), eps, lanes)
    f = _Counted(f)
    shape = x0.shape
    T = int(threshold)
    eps32 = _F32(eps)
    abs_trace = np.zeros(T + 1, _F32)
    rel_trace = np.zeros(T + 1, _F32)

    def step(z_prev):
        z = f(z_prev.reshape(shape)).reshape(-1)
        ab, nz = _host(*_norms(reduce, z_prev - z, z))
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = _F32(ab / nz)
        return z, ab, rel

    z, abs_trace[0], rel = step(x0.reshape(-1))
    rel_trace[0] = rel
    trace: List[torch.Tensor] = [x0.clone(), z.reshape(shape)] \
        if keep_trace else []
    ite = 0
    while _go(sync, rel > eps32 and ite < T):
        z_new, ab, rel_new = step(z)
        if not (rel > eps32 and ite < T):
            continue                 # stopped: the state stays (sync)
        ite += 1
        z, rel = z_new, rel_new
        abs_trace[ite], rel_trace[ite] = ab, rel
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


def _picard_lanes(f: Callable, x0: torch.Tensor, T: int, eps: float,
                  lanes: Lanes) -> SolverResult:
    """``picard`` on each lane of ``lanes``."""
    f = _Counted(f)
    shape = x0.shape
    step = _padded(f, lanes, shape)
    eps32 = _F32(eps)
    abs_trace = np.zeros((T + 1, lanes.G), _F32)
    rel_trace = np.zeros((T + 1, lanes.G), _F32)
    ite = np.zeros(lanes.G, np.int64)

    def rels(z_prev, z):
        ab, nz = _host(_lane_norm(z_prev - z), _lane_norm(z))
        with np.errstate(divide="ignore", invalid="ignore"):
            return ab, (ab / nz).astype(_F32)

    z_prev = lanes.pad(x0)
    z = step(z_prev)
    abs_trace[0], rel = rels(z_prev, z)
    rel_trace[0] = rel
    active = (rel > eps32) & (ite < T)
    it = 0
    while active.any():
        it += 1
        z_new = step(z)
        ab_n, rel_n = rels(z, z_new)
        z = torch.where(_lane_mask(active, z.device), z_new, z)
        abs_trace[it, active] = ab_n[active]
        rel_trace[it, active] = rel_n[active]
        rel = np.where(active, rel_n, rel)
        ite[active] = it
        active &= (rel > eps32) & (ite < T)
    return SolverResult(
        result=lanes.unpad(z, shape), lowest=rel, nstep=ite,
        prot_break=np.zeros(lanes.G, bool),
        abs_trace=torch.from_numpy(abs_trace[:T]),
        rel_trace=torch.from_numpy(rel_trace[:T]), trace=None,
        trace_len=ite + 2, calls=f.n)


forward_iteration = picard


# Anderson's window and Tikhonov regulariser, and its mixing β = 1, as the
# JAX package's defaults (solvers.py:165-167; no caller sets others)
ANDERSON_WINDOW = 2
ANDERSON_LAM = 1e-4


@_counts_reads
def anderson(f: Callable, x0: torch.Tensor, threshold: int = 50,
             eps: float = 1e-3, stop_mode: str = "rel",
             keep_trace: bool = False, lanes: Optional[Lanes] = None,
             reduce: Optional[Callable] = None,
             sync: Optional[Callable] = None) -> SolverResult:
    """Anderson acceleration: each step mixes the last two evaluations
    F_i = f(X_i) with the weights α of the regularised least-squares
    problem min ‖Σ α_i (F_i − X_i)‖² + lam‖α‖², Σ α_i = 1, solved on the
    device as its 3×3 bordered normal equations, and x = Σ α_i F_i.
    ``rel = ‖g‖ / (1e-5 + ‖f(x)‖)``; the best iterate is the result,
    ``nstep`` its step.  ``reduce`` / ``sync``: see the module docstring
    (the Gram matrix is summed over the group)."""
    if stop_mode not in ("rel", "abs"):
        raise ValueError(stop_mode)
    _no_lane_options("anderson", lanes, keep_trace, reduce, sync)
    if lanes is not None:
        return _anderson_lanes(f, x0, int(threshold), eps, stop_mode, lanes)
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

    k, done = 2, False
    while _go(sync, k < T and not done):
        G = F - X
        H[1:, 1:] = _summed(reduce, G @ G.T) + lam_eye
        alpha = torch.linalg.solve(H, rhs)[1:]
        xk = alpha @ F
        fk = f(xk.reshape(shape)).reshape(-1)
        ab, nfk = _host(*_norms(reduce, fk - xk, fk))
        if not (k < T and not done):
            continue                 # stopped: the state stays (sync)
        X[k % m] = xk
        F[k % m] = fk

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
        done = diff < eps32

    return SolverResult(
        result=lowest_x.reshape(shape), lowest=float(lowest),
        nstep=int(lowest_step), prot_break=False,
        abs_trace=torch.from_numpy(abs_trace),
        rel_trace=torch.from_numpy(rel_trace), trace=trace,
        trace_len=k - 1, calls=f.n)


def _anderson_lanes(f: Callable, x0: torch.Tensor, T: int, eps: float,
                    stop_mode: str, lanes: Lanes) -> SolverResult:
    """``anderson`` on each lane of ``lanes``: one batch of G bordered
    3×3 systems a step."""
    f = _Counted(f)
    shape = x0.shape
    step = _padded(f, lanes, shape)
    m, G = ANDERSON_WINDOW, lanes.G
    eps32 = _F32(eps)
    dt, dev = x0.dtype, x0.device

    x0p = lanes.pad(x0)
    X = torch.stack([x0p, step(x0p)])                # (m, G, C)
    F = torch.stack([X[1], step(X[1])])

    abs_trace = np.zeros((T, G), _F32)
    rel_trace = np.zeros((T, G), _F32)
    lowest = np.full(G, _F32(1e8), _F32)
    lowest_step = np.zeros(G, np.int64)
    lowest_x = x0p
    H = torch.zeros((G, m + 1, m + 1), dtype=dt, device=dev)
    H[:, 0, 1:] = 1.0
    H[:, 1:, 0] = 1.0
    lam_eye = ANDERSON_LAM * torch.eye(m, dtype=dt, device=dev)
    rhs = torch.zeros((G, m + 1), dtype=dt, device=dev)
    rhs[:, 0] = 1.0
    active = np.ones(G, bool)
    k_end = np.full(G, 2, np.int64)

    k = 2
    while k < T and active.any():
        Gm = (F - X).transpose(0, 1)                         # (G, m, C)
        H[:, 1:, 1:] = torch.bmm(Gm, Gm.transpose(1, 2)) + lam_eye
        alpha = torch.linalg.solve(H, rhs)[:, 1:]            # (G, m)
        xk = torch.bmm(alpha[:, None, :], F.transpose(0, 1))[:, 0]
        fk = step(xk)
        mask = _lane_mask(active, dev)
        X[k % m] = torch.where(mask, xk, X[k % m])
        F[k % m] = torch.where(mask, fk, F[k % m])

        ab, nfk = _host(_lane_norm(fk - xk), _lane_norm(fk))
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = (ab / (_F32(1e-5) + nfk)).astype(_F32)
        diff = rel if stop_mode == "rel" else ab
        better = active & (diff < lowest)
        lowest = np.where(better, diff, lowest)
        lowest_step = np.where(better, k, lowest_step)
        lowest_x = torch.where(_lane_mask(better, dev), xk, lowest_x)
        abs_trace[k - 2, active] = ab[active]
        rel_trace[k - 2, active] = rel[active]
        k += 1
        k_end[active] = k
        active &= ~(diff < eps32)

    return SolverResult(
        result=lanes.unpad(lowest_x, shape), lowest=lowest,
        nstep=lowest_step, prot_break=np.zeros(G, bool),
        abs_trace=torch.from_numpy(abs_trace),
        rel_trace=torch.from_numpy(rel_trace), trace=None,
        trace_len=k_end - 1, calls=f.n)


# Armijo's sufficient-decrease constant and smallest step (solver.py:20-94)
ARMIJO_C1 = 1e-4
ARMIJO_AMIN = 1e-2


def _armijo_line_search(g: Callable, x0: torch.Tensor, gx0: torch.Tensor,
                        update: torch.Tensor,
                        reduce: Optional[Callable] = None,
                        sync: Optional[Callable] = None):
    """Armijo backtracking on φ(s) = ‖g(x0 + s·update)‖² with
    φ'(0) = −φ(0) (the reference's heuristic, solver.py:20-94): try s = 1,
    then the quadratic interpolant's minimiser, then cubic interpolation
    with the reference's halving safeguard, until the first Wolfe
    condition holds or the step falls below ``ARMIJO_AMIN`` (then s = 1).
    Returns (x_new, gx_new); each candidate costs one ``g`` and one host
    read.  The quadratic candidate is evaluated only when s = 1 fails: the
    JAX loop evaluates it always and then ignores it.  φ and the
    non-finite count are summed over the group (``reduce``); with
    ``sync``, a rank that has accepted evaluates s = 1 again while another
    still searches, and keeps its step."""
    F32 = _F32
    c1 = F32(ARMIJO_C1)

    def phi_eval(s):
        x = x0 + float(s) * update
        gx = g(x)
        ph, nonfin = _host(*_summed(reduce, torch.stack(
            [torch.dot(gx, gx), (~torch.isfinite(gx)).sum().to(gx.dtype)])))
        return (ph if nonfin == 0 else F32(np.inf)), x, gx

    with np.errstate(all="ignore"):
        (phi0,) = _host(_summed(reduce, torch.dot(gx0, gx0)))
        derphi0 = -phi0
        phi_1, x_1, gx_1 = phi_eval(F32(1.0))
        found = x_1, gx_1
        searching = not phi_1 <= phi0 + c1 * derphi0
        if not _go(sync, searching):
            return found
        # quadratic interpolant's minimiser (solver.py:27)
        a0 = F32(1.0)
        a1 = F32(F32(-derphi0 / F32(2.0)) / (phi_1 - phi0 - derphi0))
        pa0 = phi_1
        pa1, _, _ = phi_eval(a1 if searching else F32(1.0))
        searching = searching and a1 > F32(ARMIJO_AMIN)
        while _go(sync, searching):
            if not searching:
                phi_eval(F32(1.0))   # keeps step with the group (sync)
                continue
            factor = a0 * a0 * (a1 * a1) * (a1 - a0)
            t1 = pa1 - phi0 - derphi0 * a1
            t0 = pa0 - phi0 - derphi0 * a0
            A = (a0 * a0 * t1 - a1 * a1 * t0) / factor
            B = (-(a0 * (a0 * a0)) * t1 + a1 * (a1 * a1) * t0) / factor
            a2 = (-B + np.sqrt(np.abs(B * B - F32(3.0) * A * derphi0))) \
                / (F32(3.0) * A)
            pa2, x2, gx2 = phi_eval(a2)
            if pa2 <= phi0 + c1 * a2 * derphi0:
                found, searching = (x2, gx2), False
                continue
            # the halving safeguard, with φ kept from the unguarded α2
            # (solver.py:50-56)
            if (a1 - a2) > a1 / F32(2.0) or (F32(1.0) - a2 / a1) < F32(0.96):
                a2 = a1 / F32(2.0)
            a0, a1, pa0, pa1 = a1, a2, pa1, pa2
            searching = a1 > F32(ARMIJO_AMIN)
    return found


def _armijo_lanes(g: Callable, x0: torch.Tensor, gx0: torch.Tensor,
                  update: torch.Tensor, active: np.ndarray):
    """``_armijo_line_search`` on each lane of the padded (G, C) state, a
    step length per lane; candidates are evaluated, one ``g`` and one host
    read each, while any active lane has not accepted.  Lanes not
    ``active`` search nothing (their s = 1 result is discarded by the
    caller)."""
    F32 = _F32
    c1 = F32(ARMIJO_C1)
    dev = x0.device

    def phi_eval(s):
        x = x0 + torch.from_numpy(s.astype(F32)).to(dev)[:, None] * update
        gx = g(x)
        ph, nonfin = _host(_lane_dot(gx, gx)[:, 0],
                           (~torch.isfinite(gx)).sum(1).to(gx.dtype))
        return np.where(nonfin == 0, ph, F32(np.inf)).astype(F32), x, gx

    ones = np.ones(len(active), F32)
    with np.errstate(all="ignore"):
        (phi0,) = _host(_lane_dot(gx0, gx0)[:, 0])
        derphi0 = -phi0
        phi_1, x_out, gx_out = phi_eval(ones)
        done = ~active | (phi_1 <= phi0 + c1 * derphi0)
        if done.all():
            return x_out, gx_out
        a0 = ones
        a1 = ((-derphi0 / F32(2.0)) / (phi_1 - phi0 - derphi0)).astype(F32)
        pa0 = phi_1
        pa1, _, _ = phi_eval(np.where(done, ones, a1))
        search = ~done & (a1 > F32(ARMIJO_AMIN))
        while search.any():
            factor = a0 * a0 * (a1 * a1) * (a1 - a0)
            t1 = pa1 - phi0 - derphi0 * a1
            t0 = pa0 - phi0 - derphi0 * a0
            A = (a0 * a0 * t1 - a1 * a1 * t0) / factor
            B = (-(a0 * (a0 * a0)) * t1 + a1 * (a1 * a1) * t0) / factor
            a2 = ((-B + np.sqrt(np.abs(B * B - F32(3.0) * A * derphi0)))
                  / (F32(3.0) * A)).astype(F32)
            pa2, x2, gx2 = phi_eval(np.where(search, a2, ones))
            acc = search & (pa2 <= phi0 + c1 * a2 * derphi0)
            if acc.any():
                mask = _lane_mask(acc, dev)
                x_out = torch.where(mask, x2, x_out)
                gx_out = torch.where(mask, gx2, gx_out)
            halve = ((a1 - a2) > a1 / F32(2.0)) | \
                ((F32(1.0) - a2 / a1) < F32(0.96))
            a2 = np.where(halve, a1 / F32(2.0), a2).astype(F32)
            a0, a1, pa0, pa1 = (np.where(search, a1, a0),
                                np.where(search, a2, a1),
                                np.where(search, pa1, pa0),
                                np.where(search, pa2, pa1))
            done |= acc
            search = ~done & (a1 > F32(ARMIJO_AMIN))
    return x_out, gx_out


# Rank-1 pairs are kept in blocks of this many steps, and a ``max_rank`` cap
# rounds up to whole blocks (JAX ``solvers.py:272-275, 403``: a cap of 32
# keeps 128 pairs).
_LR_BLOCK = 128


def rank_cap(threshold: int, max_rank: int = 0) -> int:
    """Pairs Broyden keeps: ``threshold`` (full memory) or, with
    ``max_rank`` > 0, ``max_rank`` rounded up to whole ``_LR_BLOCK``
    blocks, whichever is less."""
    T = int(threshold)
    if max_rank <= 0:
        return T
    return min(T, -(-int(max_rank) // _LR_BLOCK) * _LR_BLOCK)


def _rounded(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype``, read back as float32."""
    return t.to(dtype).float()


def _rank_products(U, V, delta_x, rhs2, partials, reduce=None):
    """(ra, mv2, partials) with ra = (U Δx)ᵀ V and mv2 = (V rhs2ᵀ)ᵀ U over
    the live pairs.  Pairs stored narrower than x (bfloat16): the
    right-hand sides Δx, rhs2 and the coefficient vectors are rounded to
    the storage type before each product, and every product accumulates
    and returns float32, as JAX's ``_lr_matmul`` with its casts
    (``solvers.py:278-285, 477-480``).  The products themselves run on
    float32 copies of the rounded operands, so that no bfloat16 matmul
    (which returns bfloat16) is involved.  With ``reduce`` the coefficients
    U Δx and V rhs2ᵀ are summed over the group between the two products,
    in one call with the caller's other ``partials`` (a 1-D tensor of
    partial sums), which come back summed (as they are, without)."""
    lo = U.dtype
    narrow = lo != delta_x.dtype
    if narrow:
        U, V = U.float(), V.float()
        delta_x, rhs2 = _rounded(delta_x, lo), _rounded(rhs2, lo)
    xtu, vtx = U @ delta_x, V @ rhs2.T
    n = xtu.numel()
    flat = _summed(reduce, torch.cat([xtu, vtx.reshape(-1), partials]))
    xtu, vtx = flat[:n], flat[n:3 * n].reshape(n, 2)
    if narrow:
        xtu, vtx = _rounded(xtu, lo), _rounded(vtx, lo)
    return xtu @ V, vtx.T @ U, flat[3 * n:]


def _lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, 1) per-lane dot products of two (G, C) states."""
    return torch.sum(a * b, dim=1, keepdim=True)


def _lane_rank_products(U, V, delta_x, rhs2):
    """``_rank_products`` on each lane: U, V (G, k, C), Δx (G, C), rhs2
    (G, C, 2); returns ra (G, C) and mv2 (G, 2, C) as batched matmuls."""
    if U.dtype == delta_x.dtype:
        xtu = torch.bmm(U, delta_x[:, :, None])              # (G, k, 1)
        vtx = torch.bmm(V, rhs2)                             # (G, k, 2)
        return (torch.bmm(xtu.transpose(1, 2), V)[:, 0],
                torch.bmm(vtx.transpose(1, 2), U))
    lo, Uf, Vf = U.dtype, U.float(), V.float()
    xtu = torch.bmm(Uf, _rounded(delta_x, lo)[:, :, None])
    vtx = torch.bmm(Vf, _rounded(rhs2, lo))
    return (torch.bmm(_rounded(xtu, lo).transpose(1, 2), Vf)[:, 0],
            torch.bmm(_rounded(vtx, lo).transpose(1, 2), Uf))


# ----------------------------------------------------------- carried loop

LOOPS = ("while", "host")


def resolve_loop(name: str, loop: Optional[str], x0: torch.Tensor,
                 **host_only: bool) -> str:
    """The loop a solver runs: ``loop``, or by default ``"while"`` (the
    carried loop) for a CUDA tensor and ``"host"`` otherwise.  Each option
    named in ``host_only`` that is set takes the host loop: by default,
    or with ``loop="while"`` a ``NotImplementedError``."""
    if loop is not None and loop not in LOOPS:
        raise ValueError(f"{name}: loop must be one of {LOOPS} or None, "
                         f"not {loop!r}")
    taken = [opt for opt, on in host_only.items() if on]
    if loop == "while" and taken:
        raise NotImplementedError(
            f"{name}: the carried loop does not take {', '.join(taken)}; "
            "use loop='host'")
    if loop is None:
        return "while" if x0.device.type == "cuda" and not taken else "host"
    return loop


def _keep(done: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> None:
    """``old`` ← ``new`` in place, unless the solve is ``done``."""
    torch.where(done, old, new, out=old)


def _row(done: torch.Tensor, row, scratch: int) -> torch.Tensor:
    """(1,) device index of the row a step writes: ``row``, or once the
    solve is ``done`` the buffer's last row, a scratch row no result
    reads, so that a frozen step writes one row of nothing."""
    return torch.where(done, scratch, row).reshape(1)


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def _picard_done(rel: torch.Tensor, ite, T: int,
                 eps32: float) -> torch.Tensor:
    """Whether Picard has stopped: the step is no longer above eps (NaN
    stops), or the threshold is reached."""
    return ~(rel > eps32) | (ite >= T)


def _picard_carry(x0: torch.Tensor, z1: torch.Tensor, T: int, eps32: float,
                  keep_trace: bool) -> Dict[str, torch.Tensor]:
    """Picard's carry after the first evaluation z1 = f(x0) (JAX
    ``solvers.py:112-122, 140-143``); each trace has one scratch row."""
    dev, f32 = x0.device, torch.float32
    ab, nz = _norms(None, x0.reshape(-1) - z1, z1).float()
    rel = ab / nz
    c = dict(z=z1, ite=torch.zeros((), dtype=torch.int64, device=dev),
             rel=rel, abs_trace=torch.zeros(T + 2, dtype=f32, device=dev),
             rel_trace=torch.zeros(T + 2, dtype=f32, device=dev),
             done=_picard_done(rel, 0, T, eps32))
    c["abs_trace"][0] = ab
    c["rel_trace"][0] = rel
    if keep_trace:
        c["trace"] = torch.zeros((T + 3,) + tuple(x0.shape), dtype=x0.dtype,
                                 device=dev)
        c["trace"][0] = x0
        c["trace"][1] = z1.reshape(x0.shape)
    return c


def _picard_body(c: Dict[str, torch.Tensor], static, f: Callable, shape,
                 T: int, eps32: float) -> None:
    """One Picard iteration written into the carry ``c`` (JAX ``body``,
    ``solvers.py:127-138``), frozen once the solve has stopped."""
    done = _picard_done(c["rel"], c["ite"], T, eps32)
    z = f(c["z"].reshape(shape)).reshape(-1)
    ite = c["ite"] + 1
    ab, nz = _norms(None, c["z"] - z, z).float()
    rel = ab / nz
    row = _row(done, ite, T + 1)
    c["abs_trace"].index_copy_(0, row, ab.reshape(1))
    c["rel_trace"].index_copy_(0, row, rel.reshape(1))
    if "trace" in c:
        c["trace"].index_copy_(0, _row(done, ite + 1, T + 2),
                               z.reshape((1,) + tuple(shape)))
    _keep(done, c["z"], z)
    _keep(done, c["ite"], ite)
    _keep(done, c["rel"], rel)
    torch.logical_or(~(c["rel"] > eps32), c["ite"] >= T, out=c["done"])


def _picard_while(f: Callable, x0: torch.Tensor, T: int, eps: float,
                  keep_trace: bool) -> SolverResult:
    """``picard`` as a carried loop (``loop.run_while``)."""
    global HOST_READS
    shape = x0.shape
    eps32 = float(_F32(eps))
    c = _picard_carry(x0, f(x0).reshape(-1).clone(), T, eps32, keep_trace)
    stats = run_while(functools.partial(_picard_body, f=f, shape=shape, T=T,
                                        eps32=eps32), c, T)
    head = _fetch(torch.cat([c["abs_trace"][:T], c["rel_trace"][:T],
                             c["rel"].reshape(1),
                             c["ite"].reshape(1).float()]))
    HOST_READS += stats.host_reads
    ite = int(head[2 * T + 1])
    trace = c["trace"][:T + 2] if keep_trace else None
    return SolverResult(
        result=c["z"].reshape(shape), lowest=float(head[2 * T]), nstep=ite,
        prot_break=False, abs_trace=head[:T].clone(),
        rel_trace=head[T:2 * T].clone(), trace=trace, trace_len=ite + 2,
        calls=1 + stats.steps, graphs=stats.graphs,
        capture_s=stats.capture_s)


def _broyden_carry(x0: torch.Tensor, gx: torch.Tensor, T: int, R_cap: int,
                   lr_dtype, keep_trace: bool) -> Dict[str, torch.Tensor]:
    """Broyden's carry before its first step (JAX ``solvers.py:399-412,
    524-533``): the pairs in zeroed rows, whole ``_LR_BLOCK`` blocks of
    them, and each buffer a step writes a row of with one scratch row."""
    dev, dt, f32 = x0.device, x0.dtype, torch.float32
    d = x0.numel()
    rows = -(-R_cap // _LR_BLOCK) * _LR_BLOCK
    x = x0.reshape(-1).clone()
    big = float(_F32(1e8))
    c = dict(x=x, gx=gx, update=gx.clone(),
             Us=torch.zeros((rows + 1, d), dtype=lr_dtype, device=dev),
             VTs=torch.zeros((rows + 1, d), dtype=lr_dtype, device=dev),
             nstep=torch.zeros((), dtype=torch.int64, device=dev),
             abs_trace=torch.zeros(T + 1, dtype=f32, device=dev),
             rel_trace=torch.zeros(T + 1, dtype=f32, device=dev),
             lowest=_scalar(big, f32, dev), lowest_alt=_scalar(big, f32, dev),
             lowest_x=x.clone(),
             lowest_step=torch.zeros((), dtype=torch.int64, device=dev),
             prot_break=torch.zeros((), dtype=torch.bool, device=dev),
             stop=torch.zeros((), dtype=torch.bool, device=dev),
             done=_scalar(T <= 0, torch.bool, dev),
             window=torch.arange(30, device=dev))
    if keep_trace:
        c["trace"] = torch.zeros((T + 2,) + tuple(x0.shape), dtype=dt,
                                 device=dev)
        c["trace"][0] = x0
    return c


def _broyden_live_blocks(k: int, R_cap: int) -> int:
    """Rank blocks the step after ``k`` steps reads: those holding rows
    0..k (JAX ``solvers.py:467``), at most the buffers'."""
    return min(k // _LR_BLOCK + 1, -(-R_cap // _LR_BLOCK))


def _broyden_body(c: Dict[str, torch.Tensor], nblk: int, g: Callable,
                  shape, T: int, stop_mode: str, R_cap: int, eps32: float,
                  eps3: float, protect: float) -> None:
    """One Broyden step written into the carry ``c`` (JAX ``body``,
    ``solvers.py:417-522``), frozen once the solve has stopped.  The rank
    products read the first ``nblk`` blocks of pairs, whose rows at or
    past the step count are zero, so they equal the live rows' sums."""
    done = c["stop"] | (c["nstep"] >= T)
    live = ~done
    x, gx = c["x"], c["gx"]
    x_new = x + c["update"]
    gx_new = g(x_new)
    k = c["nstep"]                         # stored pairs; step k + 1
    nstep = k + 1
    delta_x = x_new - x
    delta_gx = gx_new - gx
    rows = nblk * _LR_BLOCK
    slot = (k % R_cap).reshape(1)
    y = gx_new + x_new
    parts = [torch.dot(gx_new, gx_new), torch.dot(y, y)]
    wraps = R_cap < T                      # static: the ring can wrap
    if wraps:                              # the slot's pair, zero until full
        u_old = c["Us"].index_select(0, slot)[0].to(x.dtype)
        v_old = c["VTs"].index_select(0, slot)[0].to(x.dtype)
        parts += [torch.dot(delta_x, u_old), torch.dot(v_old, delta_gx),
                  torch.dot(v_old, gx_new)]
    ra, mv2, sums = _rank_products(c["Us"][:rows], c["VTs"][:rows], delta_x,
                                   torch.stack([delta_gx, gx_new]),
                                   torch.stack(parts))
    norms, dots = torch.sqrt(sums[:2]), sums[2:]
    if wraps:                              # evict the oldest pair once full
        dots = torch.where(k >= R_cap, dots, 0.0)
        ra = ra - dots[0] * v_old
        mv2 = mv2 - torch.stack([u_old * dots[1], u_old * dots[2]])
    vT = -delta_x + ra                                     # rmatvec(Δx)
    mv_dgx = -delta_gx + mv2[0]                            # matvec(Δg)
    mv_gx = -gx_new + mv2[1]                               # matvec(g_new)
    vT_clean = torch.nan_to_num(vT, nan=0.0, posinf=0.0, neginf=0.0)
    denom, vt_g = torch.stack([torch.dot(vT, delta_gx),
                               torch.dot(vT_clean, gx_new)])
    u = (delta_x - mv_dgx) / denom
    u = torch.nan_to_num(u, nan=0.0, posinf=0.0, neginf=0.0)
    new_update = -(mv_gx + u * vt_g)

    ab, den = norms.float()
    rel = ab / (den + float(_F32(1e-9)))
    diff, alt = (rel, ab) if stop_mode == "rel" else (ab, rel)
    row = _row(done, k, T)
    c["abs_trace"].index_copy_(0, row, ab.reshape(1))
    c["rel_trace"].index_copy_(0, row, rel.reshape(1))
    stop_trace = c["rel_trace"] if stop_mode == "rel" else c["abs_trace"]
    # plateau: the last-30 window flat once under 3·eps, in JAX's masked
    # form (solvers.py:445-451); divergence: over the first · threshold
    idx = (nstep - 30).clamp(min=0) + c["window"]
    win = stop_trace[idx.clamp(max=T - 1)]
    seen = idx < nstep
    flat = (torch.where(seen, win, -torch.inf).max()
            / torch.where(seen, win, torch.inf).min()) < float(_F32(1.3))
    plateau = (diff < eps3) & (nstep > 30) & flat
    prot = diff > stop_trace[0] * protect

    put = _row(done, slot, c["Us"].shape[0] - 1)
    c["Us"].index_copy_(0, put, u.to(c["Us"].dtype).unsqueeze(0))
    c["VTs"].index_copy_(0, put, vT_clean.to(c["VTs"].dtype).unsqueeze(0))
    if "trace" in c:
        c["trace"].index_copy_(0, _row(done, nstep, T + 1),
                               x_new.reshape((1,) + tuple(shape)))
    better = (diff < c["lowest"]) & live
    torch.where(better, x_new, c["lowest_x"], out=c["lowest_x"])
    torch.where(better, nstep, c["lowest_step"], out=c["lowest_step"])
    torch.where(better, diff, c["lowest"], out=c["lowest"])
    torch.where((alt < c["lowest_alt"]) & live, alt, c["lowest_alt"],
                out=c["lowest_alt"])
    torch.logical_or(c["prot_break"], prot & live, out=c["prot_break"])
    _keep(done, c["stop"], (diff < eps32) | plateau | prot)
    _keep(done, c["x"], x_new)
    _keep(done, c["gx"], gx_new)
    _keep(done, c["update"], new_update)
    _keep(done, c["nstep"], nstep)
    torch.logical_or(c["stop"], c["nstep"] >= T, out=c["done"])


def _broyden_while(f: Callable, x0: torch.Tensor, T: int, eps: float,
                   stop_mode: str, keep_trace: bool, max_rank: int,
                   lowrank_dtype) -> SolverResult:
    """``broyden`` as a carried loop (``loop.run_while``), the live rank
    blocks a static key of its graphs."""
    global HOST_READS
    shape = x0.shape
    seq_len = shape[-1] if x0.dim() > 1 else 1
    R_cap = rank_cap(T, max_rank)

    def g(xf):
        return f(xf.reshape(shape)).reshape(-1) - xf

    c = _broyden_carry(x0, g(x0.reshape(-1)), T, R_cap,
                       lowrank_dtype or x0.dtype, keep_trace)
    body = functools.partial(
        _broyden_body, g=g, shape=shape, T=T, stop_mode=stop_mode,
        R_cap=R_cap, eps32=float(_F32(eps)), eps3=float(3 * _F32(eps)),
        protect=float(_F32((1e6 if stop_mode == "abs" else 1e3) * seq_len)))
    stats = run_while(body, c, T,
                      key=lambda k: _broyden_live_blocks(k, R_cap))

    # unvisited trace entries take the lowest value (JAX :536-545)
    visited = torch.arange(T, device=x0.device) < c["nstep"]
    low_rel, low_abs = ((c["lowest"], c["lowest_alt"]) if stop_mode == "rel"
                        else (c["lowest_alt"], c["lowest"]))
    head = _fetch(torch.cat([
        torch.where(visited, c["abs_trace"][:T], low_abs),
        torch.where(visited, c["rel_trace"][:T], low_rel),
        torch.stack([c["lowest"], c["nstep"].float(),
                     c["lowest_step"].float(), c["prot_break"].float()])]))
    HOST_READS += stats.host_reads
    lowest, nstep, lowest_step, prot = head[2 * T:].tolist()
    return SolverResult(
        result=c["lowest_x"].reshape(shape), lowest=lowest,
        nstep=int(lowest_step), prot_break=bool(prot),
        abs_trace=head[:T].clone(), rel_trace=head[T:2 * T].clone(),
        trace=c["trace"][:T + 1] if keep_trace else None,
        trace_len=int(nstep) + 1, calls=1 + stats.steps,
        graphs=stats.graphs, capture_s=stats.capture_s)


@_counts_reads
def broyden(f: Callable, x0: torch.Tensor, threshold: int = 50,
            eps: float = 1e-3, stop_mode: str = "rel",
            keep_trace: bool = False, ls: bool = False, max_rank: int = 0,
            lowrank_dtype: Optional[torch.dtype] = None,
            lanes: Optional[Lanes] = None,
            reduce: Optional[Callable] = None,
            sync: Optional[Callable] = None,
            loop: Optional[str] = None) -> SolverResult:
    """Broyden quasi-Newton root finder for g(x) = f(x) − x.

    The inverse Jacobian is −I + U Vᵀ with one rank-1 pair per step
    (``rmatvec`` xᵀ(−I + UVᵀ), ``matvec`` (−I + UVᵀ)x).  ``ls=True``
    backtracks each step with ``_armijo_line_search``.

    ``max_rank`` > 0 keeps only the newest ``rank_cap(threshold,
    max_rank)`` pairs: once the memory is full, step ``nstep``'s pair
    overwrites ring slot ``(nstep − 1) % cap``, the oldest pair.  The old
    pair's rank-1 terms are taken out of the sweep results first, so that
    vᵀ, the secant denominator, u and the next update all use the operator
    without it (JAX ``solvers.py:487-500``).  Below the cap nothing is
    evicted and the iterates are those of full memory, bit for bit.
    ``lowrank_dtype`` (``torch.bfloat16``) stores the pairs narrower; u and
    vᵀ are still computed in x's precision (``_rank_products``).  Neither
    is on by default.  ``reduce`` / ``sync``, ``loop``: see the module
    docstring."""
    if stop_mode not in ("rel", "abs"):
        raise ValueError(stop_mode)
    _no_lane_options("broyden", lanes, keep_trace, reduce, sync)
    if resolve_loop("broyden", loop, x0, ls=ls, lanes=lanes is not None,
                    reduce=reduce is not None,
                    sync=sync is not None) == "while":
        return _broyden_while(f, x0, int(threshold), eps, stop_mode,
                              keep_trace, max_rank, lowrank_dtype)
    if lanes is not None:
        return _broyden_lanes(f, x0, int(threshold), eps, stop_mode, ls,
                              max_rank, lowrank_dtype, lanes)
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
    R_cap = rank_cap(T, max_rank)
    lr_dtype = lowrank_dtype or x0.dtype
    Us = torch.empty((R_cap, d), dtype=lr_dtype, device=x0.device)
    VTs = torch.empty((R_cap, d), dtype=lr_dtype, device=x0.device)
    update = gx
    abs_trace = np.zeros(T, _F32)
    rel_trace = np.zeros(T, _F32)
    stop_trace = rel_trace if stop_mode == "rel" else abs_trace
    lowest, lowest_alt = big, big
    lowest_x, lowest_step = x, 0
    prot_break = False
    trace: List[torch.Tensor] = [x0.clone()] if keep_trace else []

    nstep, stop = 0, False
    while _go(sync, nstep < T and not stop):
        live = nstep < T and not stop   # False: stopped, stepping (sync)
        if ls:
            x_new, gx_new = _armijo_line_search(g, x, gx, update, reduce,
                                                sync)
        else:
            x_new = x + update
            gx_new = g(x_new)
        k = nstep                          # stored rank-1 pairs

        # rank-1 update, enqueued before the host read so the device has
        # the work in hand while the host waits
        delta_x = x_new - x
        delta_gx = gx_new - gx
        n_live, slot = min(k, R_cap), k % R_cap
        evict = k >= R_cap                 # the ring is full
        if evict:                          # the oldest pair, slot's, goes
            u_old, v_old = Us[slot].to(x.dtype), VTs[slot].to(x.dtype)
        rhs2 = torch.stack([delta_gx, gx_new])
        y = gx_new + x_new
        parts = [torch.dot(gx_new, gx_new), torch.dot(y, y)]
        if evict:
            parts += [torch.dot(delta_x, u_old), torch.dot(v_old, delta_gx),
                      torch.dot(v_old, gx_new)]
        ra, mv2, sums = _rank_products(Us[:n_live], VTs[:n_live], delta_x,
                                       rhs2, torch.stack(parts), reduce)
        norms, dots = torch.sqrt(sums[:2]), sums[2:]
        if evict:
            ra = ra - dots[0] * v_old
            mv2 = mv2 - torch.stack([u_old * dots[1], u_old * dots[2]])
        vT = -delta_x + ra                                     # rmatvec(Δx)
        mv_dgx = -delta_gx + mv2[0]                            # matvec(Δg)
        mv_gx = -gx_new + mv2[1]                               # matvec(g_new)
        vT_clean = torch.nan_to_num(vT, nan=0.0, posinf=0.0, neginf=0.0)
        denom, vt_g = _summed(reduce, torch.stack(
            [torch.dot(vT, delta_gx), torch.dot(vT_clean, gx_new)]))
        u = (delta_x - mv_dgx) / denom
        u = torch.nan_to_num(u, nan=0.0, posinf=0.0, neginf=0.0)
        new_update = -(mv_gx + u * vt_g)

        ab_t, den_t = _fetch(norms).numpy()
        if not live:
            continue                 # stopped: the state stays (sync)
        Us[slot] = u
        VTs[slot] = vT_clean
        update = new_update
        nstep += 1
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
        stop = diff < eps32 or plateau or prot

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


def _broyden_lanes(f: Callable, x0: torch.Tensor, T: int, eps: float,
                   stop_mode: str, ls: bool, max_rank: int, lowrank_dtype,
                   lanes: Lanes) -> SolverResult:
    """``broyden`` on each lane of ``lanes``.  The pairs of lane g live in
    row g of (G, cap, C) buffers, so each rank product is one batched
    matmul over the lanes; the active lanes share one step count and so
    one ring slot, and only their rows of the slot are written."""
    f = _Counted(f)
    shape = x0.shape
    G, dev = lanes.G, x0.device
    big = _F32(1e8)
    seq_len = shape[-1] if x0.dim() > 1 else 1
    protect_thres = _F32((1e6 if stop_mode == "abs" else 1e3) * seq_len)
    eps32 = _F32(eps)
    step = _padded(f, lanes, shape)

    def g(xp):
        return step(xp) - xp

    x = lanes.pad(x0)
    gx = g(x)
    R_cap = rank_cap(T, max_rank)
    lr_dtype = lowrank_dtype or x0.dtype
    # zeros, not empty: a stopped lane's unwritten rows still go through
    # the (discarded) products of the lanes that go on
    Us = torch.zeros((G, R_cap, x.shape[1]), dtype=lr_dtype, device=dev)
    VTs = torch.zeros_like(Us)
    update = gx
    abs_trace = np.zeros((T, G), _F32)
    rel_trace = np.zeros((T, G), _F32)
    stop_trace = rel_trace if stop_mode == "rel" else abs_trace
    lowest = np.full(G, big, _F32)
    lowest_alt = np.full(G, big, _F32)
    lowest_step = np.zeros(G, np.int64)
    lowest_x = x
    prot_break = np.zeros(G, bool)
    taken = np.zeros(G, np.int64)          # steps each lane took
    active = np.ones(G, bool)

    nstep = 0
    while nstep < T and active.any():
        if ls:
            x_new, gx_new = _armijo_lanes(g, x, gx, update, active)
        else:
            x_new = x + update
            gx_new = g(x_new)
        nstep += 1
        k = nstep - 1
        norms = torch.stack([_lane_norm(gx_new), _lane_norm(gx_new + x_new)])

        delta_x = x_new - x
        delta_gx = gx_new - gx
        live, slot = min(k, R_cap), k % R_cap
        ra, mv2 = _lane_rank_products(Us[:, :live], VTs[:, :live], delta_x,
                                      torch.stack([delta_gx, gx_new], dim=2))
        if k >= R_cap:
            u_old, v_old = Us[:, slot].to(x.dtype), VTs[:, slot].to(x.dtype)
            ra = ra - _lane_dot(delta_x, u_old) * v_old
            mv2 = mv2 - torch.stack([u_old * _lane_dot(v_old, delta_gx),
                                     u_old * _lane_dot(v_old, gx_new)], 1)
        vT = -delta_x + ra
        denom = _lane_dot(vT, delta_gx)
        mv_dgx = -delta_gx + mv2[:, 0]
        mv_gx = -gx_new + mv2[:, 1]
        u = (delta_x - mv_dgx) / denom
        vT = torch.nan_to_num(vT, nan=0.0, posinf=0.0, neginf=0.0)
        u = torch.nan_to_num(u, nan=0.0, posinf=0.0, neginf=0.0)
        mask = _lane_mask(active, dev)
        Us[:, slot] = torch.where(mask, u.to(lr_dtype), Us[:, slot])
        VTs[:, slot] = torch.where(mask, vT.to(lr_dtype), VTs[:, slot])
        update = torch.where(mask, -(mv_gx + u * _lane_dot(vT, gx_new)),
                             update)
        x = torch.where(mask, x_new, x)
        gx = torch.where(mask, gx_new, gx)

        ab, den = _fetch(norms).numpy().astype(_F32)
        rel = (ab / (den + _F32(1e-9))).astype(_F32)
        diff, alt = (rel, ab) if stop_mode == "rel" else (ab, rel)
        abs_trace[k, active] = ab[active]
        rel_trace[k, active] = rel[active]
        taken[active] = nstep
        better = active & (diff < lowest)
        lowest = np.where(better, diff, lowest)
        lowest_step = np.where(better, nstep, lowest_step)
        lowest_alt = np.where(active & (alt < lowest_alt), alt, lowest_alt)
        lowest_x = torch.where(_lane_mask(better, dev), x_new, lowest_x)

        win = stop_trace[max(nstep - 30, 0):nstep]
        with np.errstate(divide="ignore", invalid="ignore"):
            flat = win.max(0) / win.min(0) < _F32(1.3)
        plateau = (diff < 3 * eps32) & (nstep > 30) & flat
        prot = diff > stop_trace[0] * protect_thres
        prot_break |= active & prot
        active &= ~((diff < eps32) | plateau | prot)

    # pad each lane's unvisited trace entries with its lowest value
    low_rel, low_abs = ((lowest, lowest_alt) if stop_mode == "rel"
                        else (lowest_alt, lowest))
    visited = np.arange(T)[:, None] < taken[None, :]
    rel_trace = np.where(visited, rel_trace, low_rel[None]).astype(_F32)
    abs_trace = np.where(visited, abs_trace, low_abs[None]).astype(_F32)
    return SolverResult(
        result=lanes.unpad(lowest_x, shape), lowest=lowest,
        nstep=lowest_step, prot_break=prot_break,
        abs_trace=torch.from_numpy(abs_trace),
        rel_trace=torch.from_numpy(rel_trace), trace=None,
        trace_len=taken + 1, calls=f.n)


# ---------------------------------------------------------------- Newton

def forward_jvp(f: Callable) -> Callable:
    """``jvp(x, v)``: the derivative of ``f`` at ``x`` along ``v``, by
    forward-mode AD (``torch.autograd.forward_ad``; the fused message
    passing's rule is ``kernels.fused_mp._FusedMP.jvp``).  Each call
    evaluates ``f`` once on dual tensors."""
    def jvp(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        with fwAD.dual_level():
            out = fwAD.unpack_dual(f(fwAD.make_dual(x, v)))
        return torch.zeros_like(out.primal) if out.tangent is None \
            else out.tangent
    return jvp


def _no_hooks(name: str, reduce, sync) -> None:
    if reduce is not None or sync is not None:
        # JAX's newton and newton_krylov take neither, so its partitioned
        # solve fails for them with a TypeError too
        raise TypeError(f"{name} takes no reduce or sync: it cannot solve a "
                        "state split over ranks (partitioned solve)")


def _newton(name: str, direction: Callable, f: Callable, x0: torch.Tensor,
            threshold: int, eps: float, keep_trace: bool,
            lanes: Optional[Lanes], jvp: Optional[Callable], reduce,
            sync) -> SolverResult:
    """``picard`` on the Newton step z ← z + direction(J_g, g(z)) of
    g(z) = f(z) − z, on the (G, C) layout of the state (one row per lane,
    G = 1 without lanes); J_g v = ``jvp(z, v)`` − v."""
    _no_hooks(name, reduce, sync)
    _no_lane_options(name, lanes, keep_trace)
    jvp = _Counted(jvp or forward_jvp(f))
    f = _Counted(f)
    shape = x0.shape
    pad = (lambda x: x.reshape(1, -1)) if lanes is None else lanes.pad

    def unpad(xp):
        return xp.reshape(shape) if lanes is None else lanes.unpad(xp, shape)

    def newton_step(z):
        return z + unpad(direction(lambda vp: pad(jvp(z, unpad(vp))) - vp,
                                   pad(f(z) - z)))

    out = picard(newton_step, x0, threshold=threshold, eps=eps,
                 keep_trace=keep_trace, lanes=lanes, loop="host")
    return out._replace(calls=f.n, jvps=jvp.n)


@_counts_reads
def newton(f: Callable, x0: torch.Tensor, threshold: int = 50,
           eps: float = 1e-5, stop_mode: str = "rel",
           keep_trace: bool = False, lanes: Optional[Lanes] = None,
           jvp: Optional[Callable] = None,
           reduce: Optional[Callable] = None,
           sync: Optional[Callable] = None) -> SolverResult:
    """Dense-Jacobian Newton (JAX ``solvers.py:562-577``): ``picard`` on
    z ← z − J⁻¹ g(z), g(z) = f(z) − z, ``stop_mode`` ignored.  J is built
    column by column from one ``jvp`` a column, in a host loop, then
    solved (demo scale: (N·D)² entries).  With ``lanes`` each lane's block
    of the block-diagonal J takes n_max·D JVPs, one tangent per local
    column set in every lane at once, and one batched solve."""
    del stop_mode

    def direction(Jg, gz):                               # gz: (G, C)
        cols = []
        for c in range(gz.shape[1]):
            e = torch.zeros_like(gz)
            e[:, c] = 1.0
            cols.append(Jg(e))
        return -torch.linalg.solve(torch.stack(cols, dim=2), gz)

    return _newton("newton", direction, f, x0, threshold, eps, keep_trace,
                   lanes, jvp, reduce, sync)


# JAX's gmres defaults that newton_krylov keeps (tol, atol = 0, maxiter 1)
GMRES_TOL = 1e-5
NEWTON_KRYLOV_INNER = 20


@_counts_reads
def newton_krylov(f: Callable, x0: torch.Tensor, threshold: int = 50,
                  eps: float = 1e-5, stop_mode: str = "rel",
                  inner_iters: int = NEWTON_KRYLOV_INNER,
                  keep_trace: bool = False, lanes: Optional[Lanes] = None,
                  jvp: Optional[Callable] = None,
                  reduce: Optional[Callable] = None,
                  sync: Optional[Callable] = None) -> SolverResult:
    """Jacobian-free Newton-Krylov (JAX ``solvers.py:580-605``): ``picard``
    on z ← z + dz, dz the single-restart GMRES solution of
    J_g dz = −g(z) from 0 (``_gmres``), J_g v = ``jvp(z, v)`` − v: at most
    ``inner_iters`` + 2 JVPs a step.  With ``lanes`` the Arnoldi process
    runs per lane, one JVP of the whole state a step."""
    del stop_mode
    return _newton("newton_krylov",
                   lambda Jg, gz: _gmres(Jg, -gz, inner_iters), f, x0,
                   threshold, eps, keep_trace, lanes, jvp, reduce, sync)


def _safe_normalize(x: torch.Tensor, thresh=None):
    """Each row of ``x`` (G, C) over its norm, and the norms; a norm at or
    below ``thresh`` (default the dtype's eps; or a (G,) tensor) gives the
    zero row and norm 0 (JAX ``_safe_normalize``)."""
    norm = _lane_norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return (torch.where(use[:, None], x / norm[:, None], 0.0),
            torch.where(use, norm, 0.0))


def _gmres(A: Callable, b: torch.Tensor, restart: int) -> torch.Tensor:
    """JAX's ``gmres(A, b, x0=0, tol=1e-5, restart=restart, maxiter=1,
    solve_method="batched")`` (``jax/_src/scipy/sparse/linalg.py``
    ``_gmres_solve`` with ``_gmres_batched``, JAX 0.9.0), step for step,
    on each row of ``b`` (G, C); ``A`` maps (G, C) to (G, C) row by row.

    A(0) is evaluated; a row whose residual norm is above 1e-5·‖b‖ takes
    one restart of min(restart, C) Arnoldi steps, stopped at its
    breakdown (a new vector of norm at most eps·‖A v‖); the projected
    least-squares problem is solved through its normal equations by
    Cholesky; then A(x) is evaluated for the restart's residual, which
    maxiter = 1 leaves unused.  Rows that have stopped keep their state,
    as JAX's vmapped loops freeze theirs.  JAX's iterated Gram-Schmidt
    with ``max_iterations=2`` makes a single classical pass (its loop
    test ``k < max_iterations − 1`` fails after the first), and so does
    this copy.  One host read per Arnoldi step."""
    G, C = b.shape
    restart = min(restart, C)
    dt, dev = b.dtype, b.device
    x0 = torch.zeros_like(b)
    unit_r, r_norm = _safe_normalize(b - A(x0))
    run = r_norm > GMRES_TOL * _lane_norm(b)
    active = _fetch(run).numpy()
    if not active.any():
        return x0
    V = b.new_zeros((G, restart + 1, C))
    V[:, 0] = unit_r
    H = torch.eye(restart, restart + 1, dtype=dt, device=dev).repeat(G, 1, 1)
    eps = torch.finfo(dt).eps
    k = 0
    while k < restart and active.any():
        v = A(V[:, k])
        _, v_norm_0 = _safe_normalize(v)
        h = torch.bmm(V, v[:, :, None])[:, :, 0]              # (G, R + 1)
        q = v - torch.bmm(V.transpose(1, 2), h[:, :, None])[:, :, 0]
        unit_v, v_norm_1 = _safe_normalize(q, eps * v_norm_0)
        h[:, k + 1] = v_norm_1
        mask = _lane_mask(active, dev)
        V[:, k + 1] = torch.where(mask, unit_v, V[:, k + 1])
        H[:, k] = torch.where(mask, h, H[:, k])
        active = active & ~_fetch(v_norm_1 == 0).numpy()      # breakdown
        k += 1
    beta = b.new_zeros((G, restart + 1))
    beta[:, 0] = r_norm
    # _lstsq(Hᵀ, β): (H Hᵀ) y = H β, Cholesky (JAX: solve(assume_a='pos'))
    L, info = torch.linalg.cholesky_ex(H @ H.transpose(1, 2))
    y = torch.cholesky_solve(torch.bmm(H, beta[:, :, None]), L)[:, :, 0]
    y = torch.where((info == 0)[:, None], y, torch.nan)
    dx = torch.bmm(V[:, :-1].transpose(1, 2), y[:, :, None])[:, :, 0]
    x = torch.where(run[:, None], x0 + dx, x0)
    A(x)       # the restart's residual, as JAX evaluates it
    return x


SOLVERS = {
    "broyden": broyden,
    "anderson": anderson,
    "forward_iteration": picard,
    "picard": picard,
    "newton": newton,
    "newton_krylov": newton_krylov,
}
# solvers that take ``jvp`` (the adjoint solve passes its exact tangent)
JVP_SOLVERS = ("newton", "newton_krylov")
# solvers that take ``loop`` (the carried loop, or the host loop)
LOOP_SOLVERS = ("broyden", "forward_iteration", "picard")


def get_solver(name: str) -> Callable:
    """Solver by flag name."""
    if name in SOLVERS:
        return SOLVERS[name]
    raise ValueError(f"unknown solver '{name}'; choose from {list(SOLVERS)}")
