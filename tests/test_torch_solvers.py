"""Port solvers (Broyden with and without its Armijo line search, Anderson,
Picard) against the JAX package's on the analytic problems of
tests/test_solvers.py, at tolerances the f32 iteration reaches well
before its plateau (near the plateau the stopping step is chaotic under
f32 reduction order, so exact step counts are compared only there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psignn_tpu import solvers as jsolvers
from psignn_tpu_torch import solvers


def make_linear(n=12, d=4, rho=0.6, seed=0):
    """f(x) = M x + c with spectral radius rho < 1, as in test_solvers."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n * d, n * d)).astype(np.float32)
    M *= rho / max(abs(np.linalg.eigvals(M)))
    c = rng.normal(size=(n * d,)).astype(np.float32)
    xstar = np.linalg.solve(np.eye(n * d) - M, c).reshape(n, d)
    Mj, cj = jnp.asarray(M), jnp.asarray(c)
    Mt, ct = torch.from_numpy(M), torch.from_numpy(c)
    return ((lambda x: (Mj @ x.reshape(-1) + cj).reshape(n, d)),
            (lambda x: (Mt @ x.reshape(-1) + ct).reshape(n, d)),
            xstar, (n, d))


@pytest.mark.parametrize("stop_mode", ["rel", "abs"])
@pytest.mark.parametrize("rho,seed,eps", [(0.6, 0, 1e-5), (0.9, 2, 1e-4)])
def test_broyden_linear_matches_jax(rho, seed, eps, stop_mode):
    jf, tf, xstar, shape = make_linear(rho=rho, seed=seed)
    if stop_mode == "abs":
        eps = eps * 10
    want = jsolvers.broyden(jf, jnp.zeros(shape), threshold=200, eps=eps,
                            stop_mode=stop_mode, keep_trace=True)
    got = solvers.broyden(tf, torch.zeros(shape), threshold=200, eps=eps,
                          stop_mode=stop_mode, keep_trace=True)
    assert got.nstep == int(want.nstep)
    assert got.trace_len == int(want.trace_len)
    assert got.prot_break is False and not bool(want.prot_break)
    # best residual: f32 round-off amplified over ~30 secant updates
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=2e-2)
    # traces, padding included, step by step
    np.testing.assert_allclose(got.rel_trace.numpy(),
                               np.asarray(want.rel_trace), rtol=2e-2)
    np.testing.assert_allclose(got.abs_trace.numpy(),
                               np.asarray(want.abs_trace), rtol=2e-2)
    # iterates, iterate by iterate
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.result.numpy(), xstar, rtol=2e-3,
                               atol=2e-3)


def test_broyden_tanh_matches_jax():
    rng = np.random.default_rng(3)
    n, d = 10, 5
    W = rng.normal(size=(n * d, n * d)).astype(np.float32) * 0.3
    b = rng.normal(size=(n * d,)).astype(np.float32)
    Wj, bj = jnp.asarray(W), jnp.asarray(b)
    Wt, bt = torch.from_numpy(W), torch.from_numpy(b)

    def jf(x):
        return jnp.tanh(Wj @ x.reshape(-1) + bj).reshape(n, d)

    def tf(x):
        return torch.tanh(Wt @ x.reshape(-1) + bt).reshape(n, d)

    want = jsolvers.broyden(jf, jnp.zeros((n, d)), threshold=200, eps=1e-5)
    got = solvers.broyden(tf, torch.zeros(n, d), threshold=200, eps=1e-5)
    assert abs(got.nstep - int(want.nstep)) <= 2
    assert got.lowest < 1e-5 and float(want.lowest) < 1e-5
    x = got.result
    np.testing.assert_allclose(tf(x).numpy(), x.numpy(), atol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(want.result), atol=1e-4)


@pytest.mark.parametrize("cubic", [False, True])
def test_broyden_divergence_protection_matches_jax(cubic):
    """g(x) = f(x) − x = x² + 1 (or 10x³ + 1) has no root near the start:
    the residual blows up and divergence protection stops both solvers at
    the same step, returning the best iterate."""
    def f(x):
        return x + 1 + (10 * x ** 3 if cubic else x ** 2)

    x0 = np.linspace(-1, 1, 8).reshape(8, 1).astype(np.float32)
    want = jsolvers.broyden(f, jnp.asarray(x0), threshold=60, eps=1e-6,
                            stop_mode="abs")
    got = solvers.broyden(f, torch.from_numpy(x0), threshold=60, eps=1e-6,
                          stop_mode="abs")
    assert got.prot_break is True and bool(want.prot_break)
    assert got.trace_len == int(want.trace_len) < 61
    assert got.nstep == int(want.nstep)
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=1e-3)
    # the best iterate sits on a diverging path: f32 round-off grows there
    np.testing.assert_allclose(got.result.numpy(), np.asarray(want.result),
                               rtol=5e-3, atol=1e-5)
    # unvisited trace entries carry the lowest value
    visited = got.trace_len - 1
    assert torch.all(got.abs_trace[visited:] == np.float32(got.lowest))


def test_broyden_plateau_break_matches_jax():
    """g(x) = f(x) − x is a constant δ = 2⁻¹⁰ (exact in f32 on this path):
    the secant denominator is 0 every step (u is scrubbed to 0), the
    residual stays at ‖δ‖ between eps and 3·eps, and the last-30 plateau
    break stops both solvers at step 31 with the first iterate as the
    best."""
    def f(x):
        return x + 2.0 ** -10

    x0 = np.zeros((4, 2), np.float32)
    want = jsolvers.broyden(f, jnp.asarray(x0), threshold=100, eps=2e-3,
                            stop_mode="abs")
    got = solvers.broyden(f, torch.from_numpy(x0), threshold=100, eps=2e-3,
                          stop_mode="abs")
    assert got.trace_len == int(want.trace_len) == 32
    assert got.nstep == int(want.nstep) == 1
    assert not got.prot_break and not bool(want.prot_break)
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=1e-6)
    np.testing.assert_allclose(got.abs_trace.numpy(),
                               np.asarray(want.abs_trace), rtol=1e-5)
    np.testing.assert_allclose(got.rel_trace.numpy(),
                               np.asarray(want.rel_trace), rtol=1e-5)


def test_broyden_scrubs_nonfinite_updates():
    """A map returning inf/nan for part of the state must not poison the
    rank-1 factors: the solve keeps its best finite iterate."""
    def f(x):
        y = 0.5 * x + 1.0
        return torch.where(x > 1.5, torch.full_like(x, float("nan")), y)

    got = solvers.broyden(f, torch.zeros(6, 2), threshold=40, eps=1e-6)
    assert np.isfinite(got.lowest) and torch.isfinite(got.result).all()


def test_get_solver():
    assert solvers.get_solver("broyden") is solvers.broyden
    assert solvers.get_solver("anderson") is solvers.anderson
    assert solvers.get_solver("picard") is solvers.picard
    assert solvers.get_solver("forward_iteration") is solvers.picard
    assert solvers.get_solver("newton") is solvers.newton
    assert solvers.get_solver("newton_krylov") is solvers.newton_krylov
    with pytest.raises(ValueError):
        solvers.get_solver("nope")
    for solver in (solvers.broyden, solvers.anderson):
        with pytest.raises(ValueError):
            solver(lambda x: x, torch.zeros(2, 2), stop_mode="max")


def _assert_traces_match(got, want, rtol, atol=0.0):
    """Residual traces (padding included), nstep, trace_len and the iterate
    trace of a port result against the JAX result."""
    assert got.nstep == int(want.nstep)
    assert got.trace_len == int(want.trace_len)
    assert got.prot_break is False and not bool(want.prot_break)
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=rtol)
    for k in ("rel_trace", "abs_trace"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=rtol,
                                   atol=atol, err_msg=k)
    if want.trace is not None:
        assert got.trace.shape == want.trace.shape
        np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace),
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("rho,seed,eps", [(0.6, 0, 1e-6), (0.9, 2, 1e-5)])
def test_picard_linear_matches_jax(rho, seed, eps):
    """Picard stops on the relative step norm and returns its last
    iterate: the same step, iterates within 2e-5, traces within 2e-2 (the
    step norm ‖z_prev − z‖ cancels to a few f32 ulps of z near eps)."""
    jf, tf, xstar, shape = make_linear(rho=rho, seed=seed)
    want = jsolvers.picard(jf, jnp.zeros(shape), threshold=300, eps=eps,
                           keep_trace=True)
    got = solvers.picard(tf, torch.zeros(shape), threshold=300, eps=eps,
                         keep_trace=True)
    _assert_traces_match(got, want, rtol=2e-2)
    assert got.calls == got.nstep + 1
    # the trace holds x0, f(x0), ..., and its last valid entry is the result
    assert got.trace.shape[0] == 302
    np.testing.assert_array_equal(got.trace[0].numpy(), 0.0)
    np.testing.assert_array_equal(got.trace[got.trace_len - 1].numpy(),
                                  got.result.numpy())
    np.testing.assert_allclose(got.result.numpy(), xstar, rtol=1e-3,
                               atol=1e-3)


def test_picard_stops_at_threshold_and_ignores_stop_mode():
    jf, tf, _, shape = make_linear(rho=0.9, seed=1)
    for mode in ("rel", "abs"):
        want = jsolvers.picard(jf, jnp.zeros(shape), threshold=7, eps=0.0,
                               stop_mode=mode)
        got = solvers.picard(tf, torch.zeros(shape), threshold=7, eps=0.0,
                             stop_mode=mode)
        assert got.nstep == int(want.nstep) == 7 and got.calls == 8
        np.testing.assert_allclose(got.rel_trace.numpy(),
                                   np.asarray(want.rel_trace), rtol=1e-5)


@pytest.mark.parametrize("stop_mode", ["rel", "abs"])
@pytest.mark.parametrize("rho,seed,eps", [(0.6, 0, 1e-5), (0.9, 2, 1e-4)])
def test_anderson_linear_matches_jax(rho, seed, eps, stop_mode):
    """m = 2, lam = 1e-4, beta = 1: the same steps, traces within 2e-2
    (f32 round-off through the small solve each step), the best iterate
    and the running-best iterate trace."""
    jf, tf, xstar, shape = make_linear(rho=rho, seed=seed)
    want = jsolvers.anderson(jf, jnp.zeros(shape), threshold=200, eps=eps,
                             stop_mode=stop_mode, keep_trace=True)
    got = solvers.anderson(tf, torch.zeros(shape), threshold=200, eps=eps,
                           stop_mode=stop_mode, keep_trace=True)
    _assert_traces_match(got, want, rtol=2e-2)
    assert got.calls == got.trace_len + 1
    np.testing.assert_allclose(got.result.numpy(), xstar, rtol=2e-3,
                               atol=2e-3)


def test_anderson_tracks_its_best_iterate():
    """On an expanding linear map (spectral radius 1.5) the residual never
    falls to eps (tests/test_solvers.py:109-115 on a divergent problem):
    the result is the best iterate, not the last, at JAX's step, and the
    first 20 residuals match JAX's within 1e-4."""
    jf, tf, _, shape = make_linear(rho=1.5, seed=6)
    want = jsolvers.anderson(jf, jnp.zeros(shape), threshold=80, eps=1e-10)
    got = solvers.anderson(tf, torch.zeros(shape), threshold=80, eps=1e-10,
                           keep_trace=True)
    rel = got.rel_trace.numpy()[:got.trace_len - 1]
    assert got.trace_len == int(want.trace_len) == 79
    assert got.nstep == int(want.nstep) and rel[got.nstep - 2] == rel.min()
    np.testing.assert_allclose(got.lowest, float(want.lowest), rtol=1e-4)
    np.testing.assert_allclose(rel[:20], np.asarray(want.rel_trace)[:20],
                               rtol=1e-4)
    assert np.float32(got.lowest) == rel.min() < rel[-1]
    # the running best is the result from its step on
    np.testing.assert_array_equal(got.trace[got.trace_len - 1].numpy(),
                                  got.result.numpy())
    np.testing.assert_allclose(got.result.numpy(), np.asarray(want.result),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,kw,scale", [
    ("picard", {}, 0.1), ("anderson", {}, 0.3),
    ("broyden", dict(ls=True), 0.3)])
def test_tanh_matches_jax(name, kw, scale):
    """The nonlinear problem of tests/test_solvers.py:52-64 (Picard on a
    weaker coupling, where the map contracts) by each solver this slice
    ports: a fixed point within 1e-4 of JAX's."""
    rng = np.random.default_rng(3)
    n, d = 10, 5
    W = rng.normal(size=(n * d, n * d)).astype(np.float32) * scale
    b = rng.normal(size=(n * d,)).astype(np.float32)
    Wj, bj = jnp.asarray(W), jnp.asarray(b)
    Wt, bt = torch.from_numpy(W), torch.from_numpy(b)

    def jf(x):
        return jnp.tanh(Wj @ x.reshape(-1) + bj).reshape(n, d)

    def tf(x):
        return torch.tanh(Wt @ x.reshape(-1) + bt).reshape(n, d)

    want = getattr(jsolvers, name)(jf, jnp.zeros((n, d)), threshold=300,
                                   eps=1e-5, **kw)
    got = getattr(solvers, name)(tf, torch.zeros(n, d), threshold=300,
                                 eps=1e-5, **kw)
    assert abs(got.nstep - int(want.nstep)) <= 2
    assert got.lowest < 1e-5 and float(want.lowest) < 1e-5
    x = got.result
    np.testing.assert_allclose(tf(x).numpy(), x.numpy(), atol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(want.result), atol=1e-4)


def test_broyden_line_search_matches_jax():
    """tests/test_solvers.py:204-238.  On a well-behaved problem s = 1 is
    accepted every step: the iterates are those without the search.  On
    g(x) = −3.5(x − a) − 0.2 sin(x − a) the full first step overshoots the
    root 2.5×; the search backtracks it, and the port's steps, residuals
    and result match JAX's (1e-4: the cubic interpolation's f32 scalars)."""
    jf, tf, _, shape = make_linear()
    plain = solvers.broyden(tf, torch.zeros(shape), threshold=100, eps=1e-5)
    ls = solvers.broyden(tf, torch.zeros(shape), threshold=100, eps=1e-5,
                         ls=True)
    assert ls.nstep == plain.nstep
    np.testing.assert_array_equal(ls.result.numpy(), plain.result.numpy())
    # s = 1 accepted at once: one evaluation a step, as without the search
    assert ls.calls == plain.calls == plain.trace_len

    a = 0.3

    def jover(x):
        return x - 3.5 * (x - a) - 0.2 * jnp.sin(x - a)

    def tover(x):
        return x - 3.5 * (x - a) - 0.2 * torch.sin(x - a)

    x0 = np.full((4, 2), 1.5, np.float32)
    want = jsolvers.broyden(jover, jnp.asarray(x0), threshold=60, eps=1e-6,
                            ls=True)
    got = solvers.broyden(tover, torch.from_numpy(x0), threshold=60,
                          eps=1e-6, ls=True)
    nols = solvers.broyden(tover, torch.from_numpy(x0), threshold=60,
                           eps=1e-6)
    _assert_traces_match(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.result.numpy(), np.full((4, 2), a),
                               rtol=1e-4, atol=1e-4)
    assert got.abs_trace[0] < nols.abs_trace[0]
    # the first step tried s = 1, then backtracked: more than one
    # evaluation for it
    assert got.calls > got.trace_len


@pytest.mark.parametrize("name,kw", [
    ("picard", {}), ("anderson", {}), ("broyden", {}),
    ("broyden", dict(ls=True))])
def test_calls_count_every_evaluation(name, kw):
    jf, tf, _, shape = make_linear(rho=0.9, seed=2)
    seen = []

    def counted(x):
        seen.append(1)
        return tf(x)

    out = getattr(solvers, name)(counted, torch.zeros(shape), threshold=50,
                                 eps=1e-5, **kw)
    assert out.calls == len(seen) > 1
