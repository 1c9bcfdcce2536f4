"""Port DEQ core (``deq_attach``'s implicit gradient, the Hutchinson
Jacobian loss, the power method, ``deq_solve``): ``tests/test_deq.py``
mirrored in torch, and the port held against the JAX package on the same
toy problem."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psignn_tpu import deq as jdeq
from psignn_tpu_torch import deq as tdeq
from psignn_tpu_torch.deq import (DEQConfig, deq_attach, deq_solve,
                                  fixed_point_forward, jac_loss_estimate,
                                  jac_loss_probe, power_method)


def _numbers(n=6, d=3, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, d)).astype(np.float32) * 0.3
    b = rng.normal(size=(d,)).astype(np.float32) * 0.1
    h0 = rng.normal(size=(n, d)).astype(np.float32)
    return W, b, h0


class Toy(torch.nn.Module):
    """f(h, h_init) = tanh(h W + b + 0.3 h_init) (tests/test_deq.py:13-23)."""

    def __init__(self, W, b):
        super().__init__()
        self.W = torch.nn.Parameter(torch.from_numpy(W))
        self.b = torch.nn.Parameter(torch.from_numpy(b))

    def forward(self, h, h_init, graph):
        return torch.tanh(h @ self.W + self.b + 0.3 * h_init)


def _jax_toy(h, p, h_init):
    return jnp.tanh(h @ p["W"] + p["b"] + 0.3 * h_init)


def test_forward_fixed_point():
    W, b, h0 = _numbers()
    f = Toy(W, b)
    out = fixed_point_forward(f, torch.from_numpy(h0), None,
                              DEQConfig(fw_tol=1e-7, fw_thres=300))
    with torch.no_grad():
        np.testing.assert_allclose(f(out.result, torch.from_numpy(h0),
                                     None).numpy(),
                                   out.result.numpy(), atol=5e-5)


def _implicit_loss(f, cfg, h_init):
    out = fixed_point_forward(f, h_init, None, cfg)
    new_h, adjoint = deq_attach(f, cfg, out.result, h_init, None)
    return torch.sum(new_h ** 2) + 2.0 * torch.sum(new_h * h_init), adjoint


def test_implicit_gradient_matches_unrolled():
    """The adjoint solve's gradient equals autodiff through 300 unrolled
    iterations (tests/test_deq.py:36-61, 1e-3)."""
    W, b, h0 = _numbers(seed=1)
    cfg = DEQConfig(fw_tol=1e-9, fw_thres=400, bw_tol=1e-11, bw_thres=400)
    f = Toy(W, b)
    hi = torch.from_numpy(h0).requires_grad_()
    loss, adjoint = _implicit_loss(f, cfg, hi)
    gi = torch.autograd.grad(loss, [f.W, f.b, hi])
    assert adjoint.stats is not None and adjoint.stats.calls > 1

    hu = torch.from_numpy(h0).requires_grad_()
    h = hu
    for _ in range(300):
        h = f(h, hu, None)
    lu = torch.sum(h ** 2) + 2.0 * torch.sum(h * hu)
    gu = torch.autograd.grad(lu, [f.W, f.b, hu])
    for a, c, name in zip(gi, gu, ("W", "b", "h_init")):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_h_star_gets_zero_gradient():
    W, b, h0 = _numbers(seed=2)
    f = Toy(W, b)
    cfg = DEQConfig(fw_tol=1e-7, bw_tol=1e-9)
    h_init = torch.from_numpy(h0)
    h_star = fixed_point_forward(f, h_init, None, cfg).result
    h_star = h_star.clone().requires_grad_()
    new_h, _ = deq_attach(f, cfg, h_star, h_init, None)
    (g,) = torch.autograd.grad(torch.sum(new_h ** 2), h_star,
                               allow_unused=True, materialize_grads=True)
    np.testing.assert_array_equal(g.numpy(), 0.0)


def test_deq_attach_matches_jax():
    """The port's implicit gradient equals the JAX package's ``deq_attach``
    on the same toy problem and the same h* (both adjoint solves run to
    their f32 floor, asked for 1e-10; f32 sums in other orders: 1e-4)."""
    W, b, h0 = _numbers(seed=3)
    cfg = DEQConfig(fw_tol=1e-9, fw_thres=300, bw_tol=1e-10, bw_thres=300)
    jcfg = jdeq.DEQConfig(fw_tol=1e-9, fw_thres=300, bw_tol=1e-10,
                          bw_thres=300)
    jp = {"W": jnp.asarray(W), "b": jnp.asarray(b)}

    def jf(p, h, h_init, graph):
        return _jax_toy(h, p, h_init)

    h_star = np.array(jdeq.fixed_point_forward(jf, jp, jnp.asarray(h0),
                                               None, jcfg).result)

    def jloss(p, h_init):
        new_h = jdeq.deq_attach(jf, jcfg, p, jnp.asarray(h_star), h_init,
                                None, jnp.zeros(2))
        return jnp.sum(new_h ** 2) + 2.0 * jnp.sum(new_h * h_init)

    jg_p, jg_h0 = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(h0))

    f = Toy(W, b)
    hi = torch.from_numpy(h0).requires_grad_()
    new_h, adjoint = deq_attach(f, cfg, torch.from_numpy(h_star), hi, None)
    loss = torch.sum(new_h ** 2) + 2.0 * torch.sum(new_h * hi)
    gW, gb, gh0 = torch.autograd.grad(loss, [f.W, f.b, hi])
    for a, c, name in ((gW, jg_p["W"], "W"), (gb, jg_p["b"], "b"),
                       (gh0, jg_h0, "h_init")):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    # the f32 floor of the relative residual, well under the tolerances
    assert adjoint.stats.lowest < 1e-6


def test_jac_loss_probe_matches_jax():
    """‖vᵀJ‖²/denom and its parameter gradient with one shared probe."""
    W, b, h0 = _numbers(n=5, d=4, seed=4)
    v = np.random.default_rng(40).normal(size=h0.shape).astype(np.float32)
    jp = {"W": jnp.asarray(W), "b": jnp.asarray(b)}

    def jloss(p):
        return jdeq.jac_loss_probe(lambda pp, h, hi, g: _jax_toy(h, pp, hi),
                                   p, jnp.asarray(h0), jnp.asarray(h0), None,
                                   jnp.asarray(v), h0.size)

    want, jg = jax.value_and_grad(jloss)(jp)
    f = Toy(W, b)
    got = jac_loss_probe(f, torch.from_numpy(h0), torch.from_numpy(h0), None,
                         torch.from_numpy(v), h0.size)
    gW, gb = torch.autograd.grad(got, [f.W, f.b])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(gW.numpy(), np.asarray(jg["W"]), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jg["b"]), rtol=1e-4,
                               atol=1e-6)


class Linear(torch.nn.Module):
    def __init__(self, M):
        super().__init__()
        self.M = torch.nn.Parameter(torch.from_numpy(M))

    def forward(self, h, h_init, graph):
        return h @ self.M.T


def test_jac_loss_linear_matches_frobenius():
    """E‖vᵀJ‖² over Gaussian probes = tr(JJᵀ), J block-diagonal of M
    (tests/test_deq.py:77-96, 200 probes, 15 %)."""
    d, n = 5, 7
    rng = np.random.default_rng(3)
    M = rng.normal(size=(d, d)).astype(np.float32)
    f = Linear(M)
    h_star = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    est = np.mean([float(jac_loss_estimate(f, h_star, h_star, None,
                                           gen).detach())
                   for _ in range(200)])
    np.testing.assert_allclose(est, n * np.sum(M ** 2) / (n * d), rtol=0.15)


def test_power_method_spectral_radius():
    d = 6
    rng = np.random.default_rng(4)
    M = rng.normal(size=(d, d)).astype(np.float32)
    M = (M + M.T) / 2      # real spectrum: power iteration converges
    h_star = torch.from_numpy(rng.normal(size=(1, d)).astype(np.float32))
    sr = power_method(Linear(M), h_star, h_star, None,
                      torch.Generator().manual_seed(0), n_iters=300)
    np.testing.assert_allclose(float(sr), max(abs(np.linalg.eigvals(M))),
                               rtol=1e-2)


def test_deq_solve_end_to_end():
    W, b, h0 = _numbers(seed=5)
    f = Toy(W, b)
    cfg = DEQConfig(fw_tol=1e-6, fw_thres=200, bw_tol=1e-8, bw_thres=200)
    out = deq_solve(f, torch.from_numpy(h0), None, cfg,
                    torch.Generator().manual_seed(0), compute_sradius=True)
    assert out.new_h_star.shape == h0.shape
    assert out.fw.lowest < 1e-5 and out.fw.nstep > 0
    assert out.fw.calls >= out.fw.nstep + 1
    assert float(out.jac_loss.detach()) > 0.0
    assert 0.0 < float(out.sradius) < 1.0
    assert out.adjoint.stats is None           # no backward yet
    loss = torch.sum(out.new_h_star ** 2) + out.jac_loss
    loss.backward()
    assert np.isfinite(f.W.grad.numpy()).all()
    assert float(f.W.grad.abs().sum()) > 0
    assert out.adjoint.stats.lowest < 1e-7


def test_deq_attach_under_no_grad_attaches_nothing():
    W, b, h0 = _numbers(seed=6)
    with torch.no_grad():
        new_h, adjoint = deq_attach(Toy(W, b), DEQConfig(),
                                    torch.from_numpy(h0),
                                    torch.from_numpy(h0), None)
    assert not new_h.requires_grad and adjoint.stats is None


def test_unported_solver_refused():
    """Newton and Newton-Krylov, once refused here, now resolve and solve
    the toy fixed point (forward-mode AD through it for their JVPs)."""
    W, b, h0 = _numbers(seed=7)
    f = Toy(W, b)
    for name in ("newton", "newton_krylov"):
        out = fixed_point_forward(f, torch.from_numpy(h0), None,
                                  DEQConfig(solver=name, fw_tol=1e-6))
        assert out.lowest < 1e-6 and out.jvps > 0
        with torch.no_grad():
            np.testing.assert_allclose(f(out.result, torch.from_numpy(h0),
                                         None).numpy(),
                                       out.result.numpy(), atol=1e-5)


@pytest.mark.parametrize("solver,ls", [("anderson", False),
                                       ("forward_iteration", False),
                                       ("picard", False), ("broyden", True),
                                       ("newton", False),
                                       ("newton_krylov", False)])
def test_implicit_gradient_by_each_solver(solver, ls):
    """The forward and the adjoint solve by each solver give the unrolled
    gradient (1e-3, as ``test_implicit_gradient_matches_unrolled``), and
    the JAX package's ``deq_attach`` with the same solver on the same h*
    (1e-4)."""
    W, b, h0 = _numbers(seed=8)
    kw = dict(fw_tol=1e-7, fw_thres=400, bw_tol=1e-7, bw_thres=400)
    cfg = DEQConfig(solver=solver, ls=ls, **kw)
    f = Toy(W, b)
    hi = torch.from_numpy(h0).requires_grad_()
    loss, adjoint = _implicit_loss(f, cfg, hi)
    gi = torch.autograd.grad(loss, [f.W, f.b, hi])
    assert adjoint.stats.lowest < 1e-6 and adjoint.stats.calls > 1

    hu = torch.from_numpy(h0).requires_grad_()
    h = hu
    for _ in range(300):
        h = f(h, hu, None)
    lu = torch.sum(h ** 2) + 2.0 * torch.sum(h * hu)
    gu = torch.autograd.grad(lu, [f.W, f.b, hu])
    for a, c, name in zip(gi, gu, ("W", "b", "h_init")):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)

    jcfg = jdeq.DEQConfig(solver=solver, ls=ls, **kw)
    jp = {"W": jnp.asarray(W), "b": jnp.asarray(b)}

    def jf(p, h, h_init, graph):
        return _jax_toy(h, p, h_init)

    h_star = fixed_point_forward(f, torch.from_numpy(h0), None, cfg).result

    def jloss(p, h_init):
        new_h = jdeq.deq_attach(jf, jcfg, p, jnp.asarray(h_star.numpy()),
                                h_init, None, jnp.zeros(2))
        return jnp.sum(new_h ** 2) + 2.0 * jnp.sum(new_h * h_init)

    jg_p, jg_h0 = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(h0))
    hi = torch.from_numpy(h0).requires_grad_()
    new_h, _ = deq_attach(f, cfg, h_star, hi, None)
    got = torch.autograd.grad(torch.sum(new_h ** 2)
                              + 2.0 * torch.sum(new_h * hi), [f.W, f.b, hi])
    for a, c, name in zip(got, (jg_p["W"], jg_p["b"], jg_h0),
                          ("W", "b", "h_init")):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_solver_kwargs_send_ls_to_broyden_only(monkeypatch):
    """``ls`` reaches Broyden in the forward and the adjoint solve, and no
    other solver (``psignn_tpu/deq.py:59-67``)."""
    seen = []
    get_solver = tdeq.get_solver

    def spy(name):
        real = get_solver(name)

        def solver(*a, **k):
            seen.append((name, k.get("ls")))
            return real(*a, **k)
        return solver

    monkeypatch.setattr(tdeq, "get_solver", spy)
    W, b, h0 = _numbers(seed=9)
    for solver in ("broyden", "anderson"):
        cfg = DEQConfig(solver=solver, ls=True, fw_tol=1e-6, bw_tol=1e-6)
        f = Toy(W, b)
        hi = torch.from_numpy(h0).requires_grad_()
        loss, _ = _implicit_loss(f, cfg, hi)
        loss.backward()
    assert seen == [("broyden", True)] * 2 + [("anderson", None)] * 2
