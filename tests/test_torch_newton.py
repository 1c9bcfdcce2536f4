"""Port Newton and Newton-Krylov (``solvers.newton``, ``newton_krylov``,
the GMRES copy ``_gmres``, their lanes) against the JAX package on the
CPU: on the analytic problems of tests/test_solvers.py, as lanes against
``jax.vmap`` of JAX's solvers, in the DEQ's forward solve of the trained
Dirichlet Ψ-GNN and in its implicit gradient.

Tolerances: GMRES solutions within 1e-5 of JAX's (f32 products in
another order); Newton iterates within 1e-5 and the same ``nstep``, each
step's relative residual within 2e-3 and 3e-7 absolute (``TRACE_RTOL``,
``TRACE_ATOL``); the DEQ solve the same, and gradients within 1e-4 as
relative norms (as ``test_torch_deq.py``'s per-solver gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.sparse.linalg import gmres as jax_gmres

from _torch_parity import fem_sample, grad_rel, load_trained
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu import deq as jdeq
from psignn_tpu import solvers as jsolvers
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models.psignn import encoder_apply, make_function
from psignn_tpu_torch import deq, solvers
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import PsignnConfig
from psignn_tpu_torch.weights import params_from_jax, psignn_from_jax
from test_torch_solvers import make_linear

NEWTONS = ("newton", "newton_krylov")
# each step's relative residual ‖z_prev − z‖/‖z‖: GMRES's inexact steps
# carry JAX's and the port's rounding apart by up to 2e-3, and near the
# f32 floor the norm of a difference of nearly equal iterates carries an
# absolute error of a few eps (1.2e-7)
TRACE_RTOL = 2e-3
TRACE_ATOL = 3e-7


def _counted(fn):
    calls = []

    def A(v):
        calls.append(1)
        return fn(v)
    return A, calls


# ---------------------------------------------------------------- GMRES

@pytest.mark.parametrize("n,restart,seed", [(30, 20, 0), (8, 20, 1),
                                             (50, 10, 2), (48, 20, 3)])
def test_gmres_matches_jax(n, restart, seed):
    """A well-conditioned nonsymmetric system: the same solution as
    JAX's batched single-restart GMRES, and min(restart, n) + 2
    evaluations of A."""
    rng = np.random.default_rng(seed)
    M = (3 * np.eye(n) + 0.3 * rng.normal(size=(n, n))).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    want, _ = jax_gmres(lambda v: jnp.asarray(M) @ v, jnp.asarray(b),
                        x0=jnp.zeros(n), restart=restart, maxiter=1,
                        solve_method="batched")
    Mt = torch.from_numpy(M)
    A, calls = _counted(lambda v: v @ Mt.T)
    got = solvers._gmres(A, torch.from_numpy(b)[None], restart)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert len(calls) == min(restart, n) + 2


def test_gmres_identity_breaks_down_at_step_1():
    """On A = I the first Arnoldi vector is A's image: breakdown at step 1,
    three evaluations (A(0), one Arnoldi step, A(x)), x = b as JAX's.  The
    entries ±1.5 of b (16 of them, norm 6) make the Gram-Schmidt remainder
    exactly 0; a general b leaves one of a few eps, which may pass the
    breakdown test in either package."""
    signs = np.random.default_rng(4).integers(0, 2, 16) * 2 - 1
    b = (1.5 * signs).astype(np.float32)
    want, _ = jax_gmres(lambda v: v, jnp.asarray(b), x0=jnp.zeros(16),
                        restart=20, maxiter=1, solve_method="batched")
    A, calls = _counted(lambda v: v)
    got = solvers._gmres(A, torch.from_numpy(b)[None], 20)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), b, rtol=1e-6)
    assert len(calls) == 3


def test_gmres_zero_right_hand_side_takes_no_restart():
    """b = 0: the residual is not above 1e-5·‖b‖ = 0, x stays 0 after the
    one evaluation of A(0), as in JAX."""
    A, calls = _counted(lambda v: 2 * v)
    got = solvers._gmres(A, torch.zeros(1, 6), 20)
    assert torch.equal(got, torch.zeros(1, 6)) and len(calls) == 1


# ------------------------------------------------------ analytic problems

def _tanh_problem(seed, n=8, d=4, scale=0.3):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(n * d, n * d)).astype(np.float32) * scale
    b = rng.normal(size=(n * d,)).astype(np.float32)
    Wj, bj, Wt, bt = (jnp.asarray(W), jnp.asarray(b), torch.from_numpy(W),
                      torch.from_numpy(b))
    return ((lambda x: jnp.tanh(Wj @ x.reshape(-1) + bj).reshape(n, d)),
            (lambda x: torch.tanh(Wt @ x.reshape(-1) + bt).reshape(n, d)),
            (n, d))


def _assert_matches(got, want, atol=1e-5):
    assert got.nstep == int(want.nstep)
    assert got.trace_len == int(want.trace_len)
    np.testing.assert_allclose(got.result.numpy(), np.asarray(want.result),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(got.rel_trace.numpy(),
                               np.asarray(want.rel_trace), rtol=TRACE_RTOL,
                               atol=TRACE_ATOL)


# (problem, seed, threshold, eps) of tests/test_solvers.py:27-41 and
# 118-137 (dense Newton on the linear map with 8 steps, not 20: each takes
# 48 JVPs, and the f32 floor stops none before the threshold)
PROBLEMS = {"linear": ("linear", 0, 8, 1e-8),
            "linear_nk": ("linear", 7, 20, 1e-6),
            "tanh": ("tanh", 8, 30, 1e-9)}


@pytest.mark.parametrize("name", NEWTONS)
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_newton_solvers_match_jax(name, problem):
    kind, seed, thr, eps = PROBLEMS[problem]
    if kind == "linear":
        jf, tf, xstar, shape = make_linear(seed=seed)
    else:
        jf, tf, shape = _tanh_problem(seed)
        xstar = None
    want = getattr(jsolvers, name)(jf, jnp.zeros(shape), threshold=thr,
                                   eps=eps)
    got = getattr(solvers, name)(tf, torch.zeros(shape), threshold=thr,
                                 eps=eps)
    _assert_matches(got, want)
    assert got.prot_break is False and got.calls == got.trace_len - 1
    size = shape[0] * shape[1]
    if name == "newton":       # one JVP a Jacobian column
        assert got.jvps == size * got.calls
    else:                      # at most restart + 2 a step
        assert got.calls <= got.jvps <= (20 + 2) * got.calls
    if xstar is not None:
        np.testing.assert_allclose(got.result.numpy(), xstar, rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("name", NEWTONS)
def test_explicit_jvp_replaces_forward_mode(name):
    """A given ``jvp`` is used instead of forward-mode AD: the analytic
    derivative of tanh(Wx + b) gives the default's result."""
    rng = np.random.default_rng(8)
    W = torch.from_numpy(rng.normal(size=(32, 32)).astype(np.float32) * 0.3)
    b = torch.from_numpy(rng.normal(size=32).astype(np.float32))

    def f(x):
        return torch.tanh(W @ x.reshape(-1) + b).reshape(8, 4)

    def jvp(x, v):
        y = f(x).reshape(-1)
        return ((1 - y * y) * (W @ v.reshape(-1))).reshape(8, 4)

    solver = getattr(solvers, name)
    want = solver(f, torch.zeros(8, 4), threshold=30, eps=1e-6)
    got = solver(f, torch.zeros(8, 4), threshold=30, eps=1e-6, jvp=jvp)
    assert got.nstep == want.nstep and got.jvps == want.jvps
    np.testing.assert_allclose(got.result.numpy(), want.result.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", NEWTONS)
@pytest.mark.parametrize("hook", ["reduce", "sync"])
def test_hooks_raise_type_error(name, hook):
    """JAX's Newton solvers take no ``reduce`` / ``sync``: its partitioned
    solve fails for them with a TypeError, and so does the port's."""
    with pytest.raises(TypeError, match="no reduce or sync"):
        getattr(solvers, name)(lambda x: x, torch.zeros(2, 2),
                               **{hook: (lambda t: t)})


# ----------------------------------------------------------------- lanes

COUNTS = (5, 9, 7)
D = 3


def _lane_problems():
    """Three tanh maps of 5, 9 and 7 rows: the port's on the concatenated
    state, JAX's on a zero-padded (3, 9, D) stack (pad rows map to 0)."""
    rng = np.random.default_rng(0)
    n_max = max(COUNTS)
    Ms = np.zeros((3, n_max * D, n_max * D), np.float32)
    cs = np.zeros((3, n_max * D), np.float32)
    for g, n in enumerate(COUNTS):
        M = rng.normal(size=(n * D, n * D)).astype(np.float32)
        Ms[g, :n * D, :n * D] = M * ((0.5, 0.9, 0.7)[g]
                                     / max(abs(np.linalg.eigvals(M))))
        cs[g, :n * D] = rng.normal(size=n * D)
    off = np.concatenate([[0], np.cumsum(COUNTS)])

    def f_all(x):
        return torch.cat([torch.tanh(
            torch.from_numpy(Ms[g, :n * D, :n * D]) @ x[off[g]:off[g + 1]]
            .reshape(-1) + torch.from_numpy(cs[g, :n * D])).reshape(-1, D)
            for g, n in enumerate(COUNTS)])

    def jf(M, c, x):
        return jnp.tanh(M @ x.reshape(-1) + c).reshape(n_max, D)
    return f_all, jf, jnp.asarray(Ms), jnp.asarray(cs), off


@pytest.mark.parametrize("name", NEWTONS)
def test_lanes_match_jax_vmap(name):
    """One laned solve of three problems of different sizes against
    ``jax.vmap`` of JAX's solver over their padded stack: each lane's
    steps, best residual and iterate."""
    f_all, jf, Ms, cs, off = _lane_problems()
    n_max = max(COUNTS)
    jsolve = getattr(jsolvers, name)
    want = jax.vmap(lambda M, c: jsolve(
        lambda x: jf(M, c, x), jnp.zeros((n_max, D)), threshold=30,
        eps=1e-6))(Ms, cs)
    lanes = solvers.Lanes(torch.from_numpy(np.repeat(np.arange(3), COUNTS)),
                          COUNTS)
    got = getattr(solvers, name)(f_all, torch.zeros(off[-1], D),
                                 threshold=30, eps=1e-6, lanes=lanes)
    np.testing.assert_array_equal(got.nstep, np.asarray(want.nstep))
    assert len(set(got.nstep.tolist())) > 1       # lanes stop on their own
    for g, n in enumerate(COUNTS):
        np.testing.assert_allclose(got.result[off[g]:off[g + 1]].numpy(),
                                   np.asarray(want.result)[g, :n], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got.rel_trace.numpy()[:, g],
                                   np.asarray(want.rel_trace)[g],
                                   rtol=TRACE_RTOL, atol=TRACE_ATOL)
    assert got.calls == int(np.max(got.nstep)) + 1


# ------------------------------------------------------------- the DEQ

@pytest.fixture(scope="module")
def trained():
    params, hp = load_trained()
    s = fem_sample(0, hsize=0.2)            # ~90 nodes
    return (params, hp, jax.tree.map(jnp.asarray, params),
            jax_batch_graphs([s]), batch_graphs([s], device="cpu"))


def _configs(hp, **over):
    return (JaxPsignnConfig(**{**hp, **over}),
            PsignnConfig.from_hyperparameters(hp, **over))


def test_fixed_point_forward_matches_jax(trained, fw_tol=1e-6):
    """Newton-Krylov on the trained Dirichlet Ψ-GNN's f_θ: forward-mode AD
    through the plain message passing, LayerNorm and the MLPs gives JAX's
    steps, residuals and fixed point."""
    params, hp, jp, jg, tg = trained
    jcfg, cfg = _configs(hp, solver="newton_krylov", fw_tol=fw_tol,
                         fw_thres=50)
    jh0 = encoder_apply(jp["autoencoder"], jg.x) * jg.fnode_mask
    want = jax.jit(lambda p, h0, g: jdeq.fixed_point_forward(
        make_function(jcfg), p, h0, g, jcfg.deq))(jp["function"], jh0, jg)
    model = psignn_from_jax(params, cfg, "cpu")
    with torch.no_grad():
        h0 = model.encoder(tg.x) * tg.fnode_mask
    got = deq.fixed_point_forward(model.function, h0, tg, cfg.deq)
    _assert_matches(got, jax.tree.map(lambda a: a[:tg.total_nodes]
                                      if a.ndim == 2 else a, want))
    assert got.lowest < fw_tol and got.jvps <= 22 * got.calls


def test_deq_attach_gradients_match_jax(trained):
    """The implicit gradient with Newton-Krylov in both solves (the
    adjoint's JVP is its exact tangent, one VJP) against JAX's
    ``deq_attach`` on the same h*, both solves run to the f32 floor."""
    params, hp, jp, jg, tg = trained
    over = dict(solver="newton_krylov", fw_tol=1e-7, fw_thres=20,
                bw_tol=1e-9, bw_thres=20)
    jcfg, cfg = _configs(hp, **over)
    model = psignn_from_jax(params, cfg, "cpu")
    n = tg.total_nodes
    with torch.no_grad():
        h0 = model.encoder(tg.x) * tg.fnode_mask
    h_star = deq.fixed_point_forward(model.function, h0, tg, cfg.deq).result
    w = torch.from_numpy(np.random.default_rng(3).normal(
        size=(n, 10)).astype(np.float32))

    new_h, adjoint = deq.deq_attach(model.function, cfg.deq, h_star,
                                    h0.requires_grad_(), tg)
    torch.sum(new_h * w).backward()
    assert adjoint.stats.lowest < 1e-6 and adjoint.stats.jvps > 0

    pad = jg.n_node_cap - n
    jw = jnp.pad(jnp.asarray(w.numpy()), ((0, pad), (0, 0)))
    jh = jnp.pad(jnp.asarray(h_star.numpy()), ((0, pad), (0, 0)))
    fn = make_function(jcfg)

    def jloss(p, h_init):
        new = jdeq.deq_attach(fn, jcfg.deq, p, jh, h_init, jg, jnp.zeros(2))
        return jnp.sum(new * jw)

    jh0 = jnp.pad(jnp.asarray(h0.detach().numpy()), ((0, pad), (0, 0)))
    jgp, jgh = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp["function"], jh0)
    want = params_from_jax({"function": jax.tree.map(np.asarray, jgp),
                            "autoencoder": params["autoencoder"]})
    got = {k: p.grad for k, p in model.function.named_parameters()}
    for k, g in got.items():
        assert grad_rel(g.numpy(), want["function." + k].numpy()) < 1e-4, k
    assert grad_rel(h0.grad.numpy(), np.asarray(jgh)[:n]) < 1e-4
