"""The adjoint solve's explicit VJP (``UpdateFunction.linearize``) and its
loop, on the CPU: the VJP against ``torch.autograd.grad`` of f_θ, the
adjoint system solved by the carried loop (eager chunks here; the card
replays them as CUDA graphs) against the host loop, ``deq_attach``'s
gradients against the JAX package's, and the loop ``deq_attach`` asks
for.

Tolerances, with their reasons:

* the VJP against autograd: 1e-5 · max(1, max|ref|), f32 sums of the same
  products in another order (the plain message-passing VJP against
  autograd through the plain message passing);
* the carried loop against the host loop: the first 4 iterates within
  1e-6 · max(1, max|y|), as ``tests/test_torch_while_loop.py`` holds them
  (the carried rank products sum over whole zeroed blocks, another order
  than the host loop's over the live rows);
* ``deq_attach`` against JAX: both adjoint solves run to their f32 floor
  (asked for 1e-10) from the same h*, the gradients within 1e-4
  relative and 1e-6 absolute, as ``tests/test_torch_deq.py`` holds the
  toy problem's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (MIXED_CKPT, fem_sample, kernel_route,
                           load_trained, mixed_sample)
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu import deq as jdeq
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models.psignn import encoder_apply, make_function
from psignn_tpu_torch import loop, solvers
from psignn_tpu_torch.deq import DEQConfig, deq_attach, fixed_point_forward
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import Psignn, PsignnConfig
from psignn_tpu_torch.weights import params_to_jax, psignn_from_jax

CASES = ("dirichlet", "mixed", "n_layers2", "lanes")


def _case(name: str):
    """(model, graph) of a case: the trained Dirichlet and mixed
    checkpoints on a FEM sample, a seeded two-layer mixed model (both
    layers, the Neumann branch in each), and a batch of three graphs of
    the trained Dirichlet model (a stacked batch's state)."""
    if name in ("dirichlet", "lanes"):
        params, hp = load_trained()
        model = psignn_from_jax(params, PsignnConfig.from_hyperparameters(hp),
                                "cpu")
        samples = ([fem_sample(0)] if name == "dirichlet" else
                   [fem_sample(1), fem_sample(2, radius=0.6),
                    fem_sample(3, radius=1.5, hsize=0.3)])
    elif name == "mixed":
        params, hp = load_trained(MIXED_CKPT)
        model = psignn_from_jax(params, PsignnConfig.from_hyperparameters(hp),
                                "cpu")
        samples = [mixed_sample(0)]
    else:
        model = Psignn(PsignnConfig(n_layers=2, bc_mode="mixed"),
                       torch.Generator().manual_seed(5))
        samples = [mixed_sample(1)]
    return model, batch_graphs(samples, device="cpu")


@pytest.fixture(scope="module")
def cases():
    """Each case's model, graph, h_init and h* (30 Broyden steps)."""
    out = {}
    for name in CASES:
        model, graph = _case(name)
        with torch.no_grad():
            h0 = model.encoder(graph.x) * graph.fnode_mask
        cfg = DEQConfig(fw_tol=1e-6, fw_thres=30)
        h_star = fixed_point_forward(model.function, h0, graph, cfg).result
        out[name] = (model, graph, h0, h_star)
    return out


def _autograd_vjp(model, graph, h0, h_star):
    h = h_star.detach().requires_grad_()
    out = model.function(h, h0, graph)
    return lambda v: torch.autograd.grad(out, h, v, retain_graph=True)[0]


def _close(got, want, scale=1e-5):
    tol = scale * max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("name", CASES)
def test_linearize_matches_autograd(cases, name):
    """Jᵀv of ``linearize`` is autograd's VJP of f_θ at the same h* for
    three random cotangents."""
    model, graph, h0, h_star = cases[name]
    vjp = model.function.linearize(h_star, h0, graph)
    ref = _autograd_vjp(model, graph, h0, h_star)
    gen = torch.Generator().manual_seed(7)
    for _ in range(3):
        v = torch.randn(h_star.shape, generator=gen)
        _close(vjp(v), ref(v))


@pytest.mark.parametrize("name", CASES)
def test_linearize_is_linear(cases, name):
    """Jᵀ(2v + w) = 2·Jᵀv + Jᵀw, and the VJP reads nothing it changes:
    a second call repeats the first bit for bit."""
    model, graph, h0, h_star = cases[name]
    vjp = model.function.linearize(h_star, h0, graph)
    gen = torch.Generator().manual_seed(8)
    v, w = (torch.randn(h_star.shape, generator=gen) for _ in range(2))
    jv = vjp(v)
    want = 2 * jv + vjp(w)
    _close(vjp(2 * v + w), want)
    np.testing.assert_array_equal(vjp(v).numpy(), jv.numpy())


def test_linearize_launches_as_the_autograd_vjp(cases, monkeypatch):
    """On the CUDA route's wiring (kernels replaced by their plain
    versions), ``linearize`` runs f_θ once (two forward launches) and
    each VJP launches the backward kernel once a message passing, as
    autograd's VJP through the forward kernel does."""
    model, graph, h0, h_star = cases["dirichlet"]
    fm = kernel_route(monkeypatch)
    vjp = model.function.linearize(h_star, h0, graph)
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == (2, 0)
    v = torch.ones_like(h_star)
    got = vjp(v)
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == (2, 2)
    want = _autograd_vjp(model, graph, h0, h_star)(v)
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == (4, 4)
    _close(got, want)


# ------------------------------------------------------------ the loop


def _adjoint_f(cases, name="dirichlet", seed=9):
    model, graph, h0, h_star = cases[name]
    vjp = model.function.linearize(h_star, h0, graph)
    g = torch.randn(h_star.shape,
                    generator=torch.Generator().manual_seed(seed))
    return lambda y: vjp(y) + g, g


@pytest.mark.parametrize("name", ["dirichlet", "mixed"])
def test_adjoint_carried_matches_host_loop(cases, name):
    """The adjoint system y = Jᵀy + g by Broyden, carried against host
    loop: the first 4 iterates within 1e-6 · max(1, max|y|), one host read
    a chunk and one at the end against one a step, and the carried loop's
    calls whole chunks."""
    f, g = _adjoint_f(cases, name)
    host, carried = (solvers.broyden(f, torch.zeros_like(g), threshold=40,
                                     eps=1e-8, keep_trace=True, loop=lp)
                     for lp in ("host", "while"))
    scale = max(1.0, float(host.trace[:5].abs().max()))
    np.testing.assert_allclose(carried.trace[:5].numpy(),
                               host.trace[:5].numpy(), rtol=0,
                               atol=1e-6 * scale)
    steps = carried.trace_len - 1
    chunks = -(-steps // loop.CHUNK)
    assert carried.host_reads == chunks + 1
    assert host.host_reads == host.trace_len - 1
    assert carried.calls == 1 + chunks * loop.CHUNK >= host.calls
    # both solved the system as far as 40 steps take it
    for out in (host, carried):
        r = f(out.result) - out.result
        assert float(r.norm() / f(out.result).norm()) < 1e-3


@pytest.fixture(scope="module")
def jax_small():
    """The trained Dirichlet model on a small mesh in both packages, and
    the h* of JAX's forward solve at its f32 floor, which both sides
    attach at."""
    params, hp = load_trained()
    jcfg = JaxPsignnConfig(**{**hp, "fw_tol": 1e-9, "fw_thres": 300,
                              "bw_tol": 1e-10, "bw_thres": 300})
    cfg = PsignnConfig.from_hyperparameters(
        hp, fw_tol=1e-9, fw_thres=300, bw_tol=1e-10, bw_thres=300)
    s = fem_sample(4, hsize=0.2)
    jg, tg = jax_batch_graphs([s]), batch_graphs([s], device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    jh0 = encoder_apply(jp["autoencoder"], jg.x) * jg.fnode_mask
    jf = make_function(jcfg)
    h_star = np.array(jdeq.fixed_point_forward(
        jf, jp["function"], jh0, jg, jcfg.deq).result)
    return params, jp, jcfg, cfg, jg, tg, jf, jh0, h_star


@pytest.mark.parametrize("lp", ["host", "while"])
def test_deq_attach_gradients_match_jax(jax_small, monkeypatch, lp):
    """``deq_attach`` on the trained f_θ through the explicit VJP, by the
    host loop and by the carried loop (the route's default sent to
    "while" here), against JAX's ``deq_attach``: the gradients of every
    parameter of f_θ and of ``h_init``, from the same h*."""
    params, jp, jcfg, cfg, jg, tg, jf, jh0, h_star = jax_small
    n = tg.total_nodes
    w = np.random.default_rng(3).normal(size=h_star.shape).astype(np.float32)
    w *= np.asarray(jg.fnode_mask)

    def jloss(p, h_init):
        new_h = jdeq.deq_attach(jf, jcfg.deq, p, jnp.asarray(h_star), h_init,
                                jg, jnp.zeros(2))
        return jnp.sum(new_h * w) + jnp.sum(new_h ** 2)

    jg_p, jg_h0 = jax.grad(jloss, argnums=(0, 1))(jp["function"], jh0)

    if lp == "while":
        real = solvers.resolve_loop
        monkeypatch.setattr(
            solvers, "resolve_loop",
            lambda name, lp_, x0, **kw: real(name, lp_ or "while", x0, **kw))
    model = psignn_from_jax(params, cfg, "cpu")
    hi = (model.encoder(tg.x) * tg.fnode_mask).detach().requires_grad_()
    new_h, adjoint = deq_attach(model.function, cfg.deq,
                                torch.from_numpy(h_star[:n]), hi, tg)
    loss = (torch.sum(new_h * torch.from_numpy(w[:n]))
            + torch.sum(new_h ** 2))
    fn = dict(model.function.named_parameters())
    grads = torch.autograd.grad(loss, list(fn.values()) + [hi])
    sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    sd.update({"function." + k: g for k, g in zip(fn, grads)})
    got = params_to_jax(sd)["function"]
    flat_got, _ = jax.tree.flatten(got)
    flat_want, _ = jax.tree.flatten(jg_p)
    assert len(flat_got) == len(flat_want) > 0
    for a, c in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c), rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg_h0)[:n],
                               rtol=1e-4, atol=1e-6)
    assert adjoint.stats.lowest < 1e-5


# ------------------------------------------------ the loop deq_attach asks


class _NoLinearize:
    """f_θ without its ``linearize``: an f that only autograd
    differentiates."""

    def __init__(self, function):
        self.function = function

    def __call__(self, h, h_init, graph):
        return self.function(h, h_init, graph)


@pytest.mark.parametrize("device,opts,want", [
    ("cuda", {}, "while"), ("cpu", {}, "host"), ("meta", {}, "host"),
    ("cuda", {"ls": True}, "host"), ("cuda", {"lanes": True}, "host"),
    ("cuda", {"reduce": True}, "host"), ("cuda", {"sync": True}, "host")])
def test_deq_attach_leaves_the_adjoint_loop_to_the_route(
        cases, monkeypatch, device, opts, want):
    """With f_θ's ``linearize`` the adjoint solve is asked for no loop and
    runs the loop the route gives for its device and options (the table
    of ``test_torch_while_loop.py``; the route is shown a tensor of
    ``device``); an f without ``linearize`` is asked for the host loop
    and runs it, whatever the device."""
    model, graph, h0, h_star = cases["lanes"]
    real_route, real_while = solvers.resolve_loop, solvers._broyden_while
    shown = types.SimpleNamespace(device=torch.device(device))
    monkeypatch.setattr(solvers, "resolve_loop",
                        lambda name, lp, x0, **kw: real_route(name, lp,
                                                              shown, **kw))
    asked, ran = [], []

    def carried(*args, **kw):
        ran.append("while")
        return real_while(*args, **kw)

    real = solvers.broyden

    def spy(*args, **kw):
        asked.append(kw.get("loop"))
        return real(*args, **kw)

    monkeypatch.setattr(solvers, "_broyden_while", carried)
    monkeypatch.setitem(solvers.SOLVERS, "broyden", spy)
    kw = {"lanes": dict(lanes=solvers.Lanes(graph.graph_id,
                                            graph.n_nodes.tolist())),
          "reduce": dict(reduce=lambda t: t),
          "sync": dict(sync=lambda go: go)}.get(next(iter(opts), None), {})
    dcfg = DEQConfig(bw_tol=1e-8, bw_thres=8, ls="ls" in opts)
    for f, route in ((model.function, want),
                     (_NoLinearize(model.function), "host")):
        asked.clear()
        ran.clear()
        new_h, adjoint = deq_attach(f, dcfg, h_star,
                                    h0.clone().requires_grad_(), graph, **kw)
        new_h.sum().backward()
        assert asked == [None if f is model.function else "host"]
        assert (ran[0] if ran else "host") == route
        assert (np.asarray(adjoint.stats.calls) > 1).all()
