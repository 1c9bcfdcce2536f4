"""Port the fused message passing's backward (the plain VJP, the autograd
wiring of the CUDA route, the reversed CSR) against the JAX package: the
Pallas backward kernel in interpret mode, ``jax.vjp`` of the XLA oracle
``mp_from_blocks``, and grad-of-VJP through the Pallas kernels, both
directions, edge_dim 3 (Ψ-GNN) and 1 (DSS)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import fem_sample, jax_mlp_params, kernel_route
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.kernels import fused_message_passing as pallas_mp
from psignn_tpu.kernels import pack_mp_blocks
from psignn_tpu.kernels.fused_mp import _fused_mp_bwd_kernel, mp_from_blocks
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.kernels import fused_mp as tmp

D = 10
# first order: the tolerance of tests/test_kernels.py:131-149 (f32 sums
# over the edges in other orders); second order: that of :152-180
TOL = 2e-4
TOL2 = 2e-3


@pytest.fixture(scope="module")
def graphs():
    samples = [fem_sample(s) for s in (3, 4)]
    return samples, jax_batch_graphs(samples), batch_graphs(samples,
                                                            device="cpu")


def _edge_feature(samples, edge_dim):
    key, width = ("edge_attr", 3) if edge_dim == 3 else ("a_ij", 1)
    return np.concatenate([s[key].reshape(-1, width) for s in samples])


def _case(graphs, direction, edge_dim, seed):
    """(JAX params, blocks, padded h and g), (torch w1, b1, w2, b2, h, csr,
    g) on the same numbers."""
    samples, jg, tg = graphs
    n = tg.total_nodes
    rng = np.random.default_rng(seed)
    params = jax_mlp_params(rng, [2 * D + edge_dim, D, D])
    h = np.zeros((jg.n_node_cap, D), np.float32)
    g = np.zeros((jg.n_node_cap, D), np.float32)
    h[:n] = rng.normal(size=(n, D))
    g[:n] = rng.normal(size=(n, D))
    ea = _edge_feature(samples, edge_dim)
    e = tg.senders.shape[0]
    ea_pad = np.zeros((jg.n_edge_cap, edge_dim), np.float32)
    ea_pad[:e] = ea
    blocks = pack_mp_blocks(np.asarray(jg.senders), np.asarray(jg.receivers),
                            ea_pad, np.asarray(jg.edge_mask), jg.n_node_cap,
                            direction)
    csr = tmp.pack_csr(tg.senders.numpy(), tg.receivers.numpy(), ea, n,
                       direction)
    targs = (torch.from_numpy(params[0]["w"].T.copy()),
             torch.from_numpy(params[0]["b"]),
             torch.from_numpy(params[1]["w"].T.copy()),
             torch.from_numpy(params[1]["b"]),
             torch.from_numpy(h[:n]), csr, torch.from_numpy(g[:n]))
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    return (jp, blocks, jnp.asarray(h), jnp.asarray(g)), targs


def _as_torch_layout(jax_grads, n):
    """JAX (dparams, dh) → (dw1, db1, dw2, db2, dh) in nn.Linear layout."""
    (p1, p2), dh = jax_grads
    return (np.asarray(p1["w"]).T, np.asarray(p1["b"]), np.asarray(p2["w"]).T,
            np.asarray(p2["b"]), np.asarray(dh)[:n])


def _assert_close(got, want, tol, names=("dw1", "db1", "dw2", "db2", "dh")):
    for name, a, b in zip(names, got, want):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("edge_dim", [3, 1])
@pytest.mark.parametrize("direction", ["to", "from"])
def test_plain_vjp_matches_jax(graphs, direction, edge_dim):
    (jp, blocks, h, g), targs = _case(graphs, direction, edge_dim,
                                      11 + edge_dim)
    n = targs[4].shape[0]
    got = tmp.mp_vjp_from_csr(*targs)
    pallas = _fused_mp_bwd_kernel(jp, h, blocks, g, D, interpret=True)
    _, vjp_fn = jax.vjp(lambda p, x: mp_from_blocks(p, x, blocks), jp, h)
    _assert_close(got, _as_torch_layout(pallas, n), TOL)
    _assert_close(got, _as_torch_layout(vjp_fn(g), n), TOL)
    # fused_mp_vjp, the kernel's wrapper, takes the plain version on the CPU
    before = tmp.BWD_LAUNCHES
    _assert_close(tmp.fused_mp_vjp(*targs), [t.numpy() for t in got], 0)
    assert tmp.BWD_LAUNCHES == before


@pytest.mark.parametrize("direction", ["to", "from"])
def test_first_order_grad_matches_jax(graphs, direction, monkeypatch):
    """torch.autograd.grad through fused_message_passing, on the plain path
    and on the CUDA route's wiring, against jax.grad through the Pallas
    kernels (tests/test_kernels.py:107-128)."""
    (jp, blocks, h, _), targs = _case(graphs, direction, 3, 21)
    n = targs[4].shape[0]
    want = jax.grad(lambda p, x: jnp.sum(pallas_mp(p, x, blocks, D,
                                                   interpret=True) ** 2),
                    argnums=(0, 1))(jp, h)
    want = _as_torch_layout(want, n)
    inputs = [t.clone().requires_grad_() for t in targs[:5]]

    def grads(mp):
        out = mp(*inputs, targs[5])
        return torch.autograd.grad(torch.sum(out ** 2), inputs)

    _assert_close(grads(tmp.fused_message_passing), want, TOL)
    fm = kernel_route(monkeypatch)
    _assert_close(grads(fm._FusedMP.apply), want, TOL)
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == (1, 1)


@pytest.mark.parametrize("direction", ["to", "from"])
def test_second_order_grad_matches_jax(graphs, direction, monkeypatch):
    """grad of ‖vᵀ·∂MP/∂h‖² (the Hutchinson pattern) on the CUDA route's
    wiring — first order from the backward wrapper, second order from the
    plain VJP — against JAX through its kernels (tests/test_kernels.py:
    152-180)."""
    (jp, blocks, h, v), targs = _case(graphs, direction, 3, 31)
    n = targs[4].shape[0]

    def jacish(p, x):
        _, vjp_fn = jax.vjp(
            lambda xx: pallas_mp(p, xx, blocks, D, interpret=True), x)
        return jnp.sum(vjp_fn(v)[0] ** 2)

    want = _as_torch_layout(jax.grad(jacish, argnums=(0, 1))(jp, h), n)
    inputs = [t.clone().requires_grad_() for t in targs[:5]]
    vt = targs[6]

    def grads(mp):
        out = mp(*inputs, targs[5])
        (vj,) = torch.autograd.grad(out, inputs[4], vt, create_graph=True)
        return torch.autograd.grad(torch.sum(vj ** 2), inputs,
                                   allow_unused=True, materialize_grads=True)

    _assert_close(grads(tmp.fused_message_passing), want, TOL2)
    fm = kernel_route(monkeypatch)
    _assert_close(grads(fm._FusedMP.apply), want, TOL2)
    # one forward and one VJP launch; the VJP's own backward is plain, and
    # ‖vJ‖² of a lone call does not depend on the forward's output
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == (1, 1)


def test_reverse_is_the_other_direction(graphs):
    """The reversed CSR the backward kernel walks for dhb is exactly the
    opposite direction's packing, sharing its tensors."""
    _, _, tg = graphs
    s, r = tg.senders.numpy(), tg.receivers.numpy()
    ea = tg.edge_attr.numpy()
    n = tg.total_nodes
    for direction, other in (("to", "from"), ("from", "to")):
        csr = tmp.pack_csr(s, r, ea, n, direction)
        want = tmp.pack_csr(s, r, ea, n, other)
        rev = csr.reverse()
        for k in ("row_ptr", "oth", "edge_attr", "rev_row_ptr", "rev_oth",
                  "rev_edge_attr"):
            assert torch.equal(getattr(rev, k), getattr(want, k)), k
        assert rev.reverse().row_ptr is csr.row_ptr
    assert tg.mp_from.row_ptr is tg.mp_to.rev_row_ptr
    # every edge of row j of the reversed packing has j as its other end
    rev = tg.mp_to.reverse()
    rows = np.repeat(np.arange(n), np.diff(rev.row_ptr.numpy()))
    pairs = set(zip(rev.oth.numpy().tolist(), rows.tolist()))   # (agg, src)
    fwd_rows = np.repeat(np.arange(n), np.diff(tg.mp_to.row_ptr.numpy()))
    assert pairs == set(zip(fwd_rows.tolist(),
                            tg.mp_to.oth.numpy().tolist()))


def test_vjp_wrapper_refuses_other_devices(graphs):
    """No fallback: neither a CPU nor a CUDA tensor raises."""
    _, _, tg = graphs
    w1, b1 = torch.zeros(D, 2 * D + 3), torch.zeros(D)
    w2, b2 = torch.zeros(D, D), torch.zeros(D)
    h = torch.zeros(tg.total_nodes, D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tmp.fused_mp_vjp(w1, b1, w2, b2, h, tg.mp_to, h)
