"""Port the fused message passing's tangent (forward-mode AD: the plain
JVP ``mp_jvp_from_csr``, the wrapper ``fused_mp_jvp``, the forward-mode
rules of ``_FusedMP`` and ``_FusedMPVjp``) against the JAX package:
``jax.jvp`` of ``ops.message_passing`` and of the kernels' XLA oracle
``mp_from_blocks``, finite differences in float64, and ``jax.jvp`` of the
whole trained f_θ (``make_function``), Dirichlet and mixed.

Tolerances: 1e-5 against JAX (f32 sums over the edges in other orders,
as ``test_torch_fused_mp.py``), 1e-6 relative against central differences
in float64, 1e-4 for the whole f_θ (its LayerNorm and gate in f32 on top
of two or three message passings)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from _torch_parity import (CKPT, MIXED_CKPT, fem_sample, jax_mlp_params,
                           kernel_route, load_trained, mixed_sample)
from psignn_tpu import ops as jops
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.kernels import pack_mp_blocks
from psignn_tpu.kernels.fused_mp import mp_from_blocks
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models.psignn import encoder_apply, make_function
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.kernels import fused_mp as tmp
from psignn_tpu_torch.models import PsignnConfig
from psignn_tpu_torch.solvers import forward_jvp
from psignn_tpu_torch.weights import psignn_from_jax

TOL = 1e-5
FD_RTOL = 1e-6
F_TOL = 1e-4
N, N_CAP, EDGE_DIM = 37, 128, 3


def hub_graph(seed=5):
    """37 nodes, nodes 30-36 isolated, node 0 receiving and node 1 sending
    40 edges (more than one chunk of a row's edges), self-loops among
    the rest (dropped by both packages)."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, 30, 240), rng.integers(0, 30, 240)
    r[:40], s[40:80] = 0, 1
    s[80:85] = r[80:85]
    ea = rng.normal(size=(240, EDGE_DIM)).astype(np.float32)
    return s, r, ea


def _case(direction, width, seed):
    """(JAX params, jax.jvp of ops.message_passing, of mp_from_blocks) and
    the torch (w1, b1, w2, b2, h, csr, v), on the same numbers."""
    s, r, ea = hub_graph()
    rng = np.random.default_rng(seed)
    params = jax_mlp_params(rng, [2 * width + EDGE_DIM, width, width])
    h, v = (np.zeros((N_CAP, width), np.float32) for _ in range(2))
    h[:N] = rng.normal(size=(N, width))
    v[:N] = rng.normal(size=(N, width))
    graph = types.SimpleNamespace(
        senders=jnp.asarray(s), receivers=jnp.asarray(r),
        edge_attr=jnp.asarray(ea), mp_edge_mask=jnp.asarray(s != r),
        n_node_cap=N_CAP, mp_blocks_to=None, mp_blocks_from=None)
    blocks = pack_mp_blocks(s, r, ea, np.ones(len(s), bool), N_CAP,
                            direction)
    jp = [{k: jnp.asarray(a) for k, a in p.items()} for p in params]
    _, want_ops = jax.jvp(
        lambda x: jops.message_passing(jp, x, graph, direction),
        (jnp.asarray(h),), (jnp.asarray(v),))
    _, want_blocks = jax.jvp(lambda x: mp_from_blocks(jp, x, blocks),
                             (jnp.asarray(h),), (jnp.asarray(v),))
    csr = tmp.pack_csr(s, r, ea, N, direction)
    targs = (torch.from_numpy(params[0]["w"].T.copy()),
             torch.from_numpy(params[0]["b"]),
             torch.from_numpy(params[1]["w"].T.copy()),
             torch.from_numpy(params[1]["b"]),
             torch.from_numpy(h[:N]), csr, torch.from_numpy(v[:N]))
    return (np.asarray(want_ops)[:N], np.asarray(want_blocks)[:N]), targs


@pytest.mark.parametrize("width", [10, 20])
@pytest.mark.parametrize("direction", ["to", "from"])
def test_plain_jvp_matches_jax(direction, width):
    (want_ops, want_blocks), targs = _case(direction, width, 7 + width)
    got = tmp.mp_jvp_from_csr(*targs).numpy()
    np.testing.assert_allclose(got, want_ops, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_blocks, rtol=TOL, atol=TOL)
    assert np.all(got[30:] == 0)           # isolated nodes get nothing
    # the wrapper takes the plain version on the CPU, launching nothing
    before = tmp.JVP_LAUNCHES
    assert torch.equal(tmp.fused_mp_jvp(*targs), tmp.mp_jvp_from_csr(*targs))
    assert tmp.JVP_LAUNCHES == before


@pytest.mark.parametrize("direction", ["to", "from"])
def test_plain_jvp_matches_finite_differences(direction):
    """float64: (MP(h + εv) − MP(h − εv)) / 2ε, ε = 1e-6."""
    _, targs = _case(direction, 10, 3)
    w1, b1, w2, b2, h, csr, v = [t.double() if isinstance(t, torch.Tensor)
                                 else t for t in targs]
    csr = tmp.MPCsr(csr.row_ptr, csr.oth, csr.edge_attr.double(),
                    csr.rev_row_ptr, csr.rev_oth, csr.rev_edge_attr.double())
    eps = 1e-6
    fd = (tmp.mp_from_csr(w1, b1, w2, b2, h + eps * v, csr)
          - tmp.mp_from_csr(w1, b1, w2, b2, h - eps * v, csr)) / (2 * eps)
    got = tmp.mp_jvp_from_csr(w1, b1, w2, b2, h, csr, v)
    np.testing.assert_allclose(got.numpy(), fd.numpy(), rtol=FD_RTOL,
                               atol=FD_RTOL * float(fd.abs().max()))


@pytest.mark.parametrize("direction", ["to", "from"])
def test_forward_mode_rules_on_the_kernel_route(direction, monkeypatch):
    """Forward-mode AD through ``_FusedMP`` (a tangent of h: the JVP
    kernel) and ``_FusedMPVjp`` (a tangent of g: the backward kernel on
    it), each kernel replaced by its plain version, with launches
    counted: the primal launches its kernel, the tangent its own."""
    _, (w1, b1, w2, b2, h, csr, v) = _case(direction, 10, 41)
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N, 10)).astype(np.float32))
    fm = kernel_route(monkeypatch)
    with torch.no_grad(), fwAD.dual_level():
        out = fwAD.unpack_dual(fm._FusedMP.apply(
            w1, b1, w2, b2, fwAD.make_dual(h, v), csr))
    assert torch.equal(out.primal, fm.mp_from_csr(w1, b1, w2, b2, h, csr))
    assert torch.equal(out.tangent,
                       fm.mp_jvp_from_csr(w1, b1, w2, b2, h, csr, v))
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES, fm.JVP_LAUNCHES) == (1, 0, 1)

    with torch.no_grad(), fwAD.dual_level():
        outs = fm._FusedMPVjp.apply(w1, b1, w2, b2, h,
                                    fwAD.make_dual(g, v), csr)
        tangents = [fwAD.unpack_dual(o).tangent for o in outs]
    for got, want in zip(tangents, fm.mp_vjp_from_csr(w1, b1, w2, b2, h,
                                                      csr, v)):
        assert torch.equal(got, want)
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES, fm.JVP_LAUNCHES) == (1, 2, 1)


@pytest.mark.parametrize("which", ["w1", "b1", "w2", "b2"])
def test_weight_tangents_raise(which, monkeypatch):
    """No path needs a tangent of the weights: the kernel route refuses
    one rather than taking the plain route quietly."""
    _, targs = _case("to", 10, 5)
    args = dict(zip(("w1", "b1", "w2", "b2", "h"), targs[:5]))
    fm = kernel_route(monkeypatch)
    with torch.no_grad(), fwAD.dual_level():
        args[which] = fwAD.make_dual(args[which],
                                     torch.ones_like(args[which]))
        with pytest.raises(NotImplementedError, match="tangent of h"):
            fm._FusedMP.apply(*args.values(), targs[5])
        with pytest.raises(NotImplementedError, match="tangent of h"):
            fm._FusedMPVjp.apply(*args.values(), targs[6], targs[5])
    assert fm.JVP_LAUNCHES == 0


@pytest.mark.parametrize("variant", ["dirichlet", "mixed"])
def test_f_theta_forward_mode_matches_jax(variant, monkeypatch):
    """``forward_jvp`` of the trained f_θ (plain message passing, the gate,
    LayerNorm, the Dirichlet reset, the mixed Neumann branch) against
    ``jax.jvp`` of JAX's ``make_function``; then on the kernel route, one
    forward and one JVP launch per message passing."""
    params, hp = load_trained(CKPT if variant == "dirichlet" else MIXED_CKPT)
    s = fem_sample(0) if variant == "dirichlet" else mixed_sample(0)
    jg, tg = jax_batch_graphs([s]), batch_graphs([s], device="cpu")
    n = tg.total_nodes
    jcfg = JaxPsignnConfig(**hp)
    model = psignn_from_jax(params, PsignnConfig.from_hyperparameters(hp),
                            "cpu")
    rng = np.random.default_rng(2)
    h, v = (np.zeros((jg.n_node_cap, 10), np.float32) for _ in range(2))
    h[:n] = rng.normal(size=(n, 10))
    v[:n] = rng.normal(size=(n, 10))
    jp = jax.tree.map(jnp.asarray, params)
    jh0 = encoder_apply(jp["autoencoder"], jg.x) * jg.fnode_mask
    _, want = jax.jvp(lambda x: make_function(jcfg)(jp["function"], x, jh0,
                                                    jg),
                      (jnp.asarray(h),), (jnp.asarray(v),))
    want = np.asarray(want)[:n]
    h0 = torch.from_numpy(np.array(jh0)[:n])
    jvp = forward_jvp(lambda x: model.function(x, h0, tg))
    with torch.no_grad():
        got = jvp(torch.from_numpy(h[:n]), torch.from_numpy(v[:n]))
        np.testing.assert_allclose(got.numpy(), want, rtol=F_TOL, atol=F_TOL)
        fm = kernel_route(monkeypatch)
        routed = jvp(torch.from_numpy(h[:n]), torch.from_numpy(v[:n]))
    np.testing.assert_allclose(routed.numpy(), got.numpy(), rtol=TOL,
                               atol=TOL)
    per_call = 2 if variant == "dirichlet" else 3
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES, fm.JVP_LAUNCHES) == (
        per_call, 0, per_call)
