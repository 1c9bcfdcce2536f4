"""Port fused message passing and its VJP (the plain versions the CUDA
kernels are held to) against the JAX package at the shapes the kernels
treat apart: latent width 20, above the 16 lanes a row takes at the model's
width 10, and a graph with isolated nodes, rows of degree 0, a node of
degree 40 and self-loops.  The JAX side runs its Pallas kernels in
interpret mode and its XLA oracle ``mp_from_blocks``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_mlp_params
from psignn_tpu.kernels import fused_message_passing as pallas_mp
from psignn_tpu.kernels import pack_mp_blocks
from psignn_tpu.kernels.fused_mp import _fused_mp_bwd_kernel, mp_from_blocks
from psignn_tpu_torch.kernels import fused_mp as tmp

N, N_CAP, N_LINKED = 200, 256, 190   # nodes N_LINKED..N-1 are isolated
EDGE_DIM = 3
# the tolerances of tests/test_torch_fused_mp.py (forward) and
# tests/test_torch_fused_mp_bwd.py (VJP): f32 sums in other orders
TOL = 1e-5
TOL_VJP = 2e-4


@pytest.fixture(scope="module")
def graph():
    """Random edges among the first N_LINKED nodes, node 0 receiving and
    node 1 sending 40 edges, padded to N_CAP nodes for the JAX packing."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, N_LINKED, 1200)
    r = rng.integers(0, N_LINKED, 1200)
    r[:40], s[40:80] = 0, 1
    ea = rng.normal(size=(1200, EDGE_DIM)).astype(np.float32)
    return s, r, ea


def _case(graph, direction, width, seed):
    s, r, ea = graph
    rng = np.random.default_rng(seed)
    params = jax_mlp_params(rng, [2 * width + EDGE_DIM, width, width])
    h = np.zeros((N_CAP, width), np.float32)
    g = np.zeros((N_CAP, width), np.float32)
    h[:N] = rng.normal(size=(N, width))
    g[:N] = rng.normal(size=(N, width))
    blocks = pack_mp_blocks(s, r, ea, np.ones(len(s), bool), N_CAP, direction)
    csr = tmp.pack_csr(s, r, ea, N, direction)
    targs = (torch.from_numpy(params[0]["w"].T.copy()),
             torch.from_numpy(params[0]["b"]),
             torch.from_numpy(params[1]["w"].T.copy()),
             torch.from_numpy(params[1]["b"]), torch.from_numpy(h[:N]), csr)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    return jp, blocks, h, g, targs


@pytest.mark.parametrize("width", [10, 20])
@pytest.mark.parametrize("direction", ["to", "from"])
def test_forward_matches_jax(graph, direction, width):
    jp, blocks, h, _, targs = _case(graph, direction, width, 40 + width)
    csr = targs[5]
    got = tmp.fused_message_passing(*targs).numpy()
    pallas = np.asarray(pallas_mp(jp, jnp.asarray(h), blocks, width,
                                  interpret=True))
    oracle = np.asarray(mp_from_blocks(jp, jnp.asarray(h), blocks))
    np.testing.assert_allclose(got, pallas[:N], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle[:N], rtol=TOL, atol=TOL)
    deg = np.diff(csr.row_ptr.numpy())
    assert (deg[N_LINKED:] == 0).all() and deg.max() >= 40
    assert not got[N_LINKED:].any()      # no edges, no message


@pytest.mark.parametrize("width", [10, 20])
@pytest.mark.parametrize("direction", ["to", "from"])
def test_vjp_matches_jax(graph, direction, width):
    jp, blocks, h, g, targs = _case(graph, direction, width, 50 + width)
    got = tmp.fused_mp_vjp(*targs, torch.from_numpy(g[:N]))
    (p1, p2), dh = _fused_mp_bwd_kernel(jp, jnp.asarray(h), blocks,
                                        jnp.asarray(g), width, interpret=True)
    _, vjp_fn = jax.vjp(lambda p, x: mp_from_blocks(p, x, blocks), jp,
                        jnp.asarray(h))
    (o1, o2), odh = vjp_fn(jnp.asarray(g))
    for (q1, q2), qdh in (((p1, p2), dh), ((o1, o2), odh)):
        want = (np.asarray(q1["w"]).T, np.asarray(q1["b"]),
                np.asarray(q2["w"]).T, np.asarray(q2["b"]),
                np.asarray(qdh)[:N])
        for name, a, b in zip(("dw1", "db1", "dw2", "db2", "dh"), got, want):
            np.testing.assert_allclose(a.numpy(), b, rtol=TOL_VJP,
                                       atol=TOL_VJP, err_msg=name)
    # an isolated node sends and receives nothing, so its dh is zero
    assert not got[4][N_LINKED:].any()
