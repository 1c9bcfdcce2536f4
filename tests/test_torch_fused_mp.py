"""Port fused message passing (CSR packing + plain version + the wrapper's
device dispatch) against the JAX ops path and the Pallas kernel run in
interpret mode, both directions, edge_dim 3 (Ψ-GNN) and 1 (DSS)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import fem_sample, jax_mlp_params
from psignn_tpu import ops as jops
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.kernels import fused_message_passing as pallas_mp
from psignn_tpu.kernels import pack_mp_blocks
from psignn_tpu.kernels.fused_mp import mp_from_blocks
from psignn_tpu_torch import ops
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.kernels import fused_mp as tmp
from psignn_tpu_torch.nn import MLP

D = 10
# f32 sums in another order (segment_sum vs index_add_, MXU dots vs BLAS)
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def graphs():
    samples = [fem_sample(s) for s in (3, 4)]
    return samples, jax_batch_graphs(samples), batch_graphs(samples,
                                                            device="cpu")


def _inputs(seed, n_pad, n, edge_dim):
    rng = np.random.default_rng(seed)
    params = jax_mlp_params(rng, [2 * D + edge_dim, D, D])
    h = np.zeros((n_pad, D), np.float32)
    h[:n] = rng.normal(size=(n, D))
    return params, h


def _torch_args(params, h, n):
    w = [torch.from_numpy(p["w"].T.copy()) for p in params]
    b = [torch.from_numpy(p["b"]) for p in params]
    return w[0], b[0], w[1], b[1], torch.from_numpy(h[:n])


def _edge_feature(samples, edge_dim):
    key, width = ("edge_attr", 3) if edge_dim == 3 else ("a_ij", 1)
    return np.concatenate([s[key].reshape(-1, width) for s in samples])


@pytest.mark.parametrize("edge_dim", [3, 1])
@pytest.mark.parametrize("direction", ["to", "from"])
def test_plain_matches_jax(graphs, direction, edge_dim):
    samples, jg, tg = graphs
    n = tg.total_nodes
    params, h = _inputs(7 + edge_dim, jg.n_node_cap, n, edge_dim)
    ea = _edge_feature(samples, edge_dim)
    csr = tmp.pack_csr(tg.senders.numpy(), tg.receivers.numpy(), ea, n,
                       direction)
    got = tmp.mp_from_csr(*_torch_args(params, h, n), csr).numpy()

    e = tg.senders.shape[0]
    ea_pad = np.zeros((jg.n_edge_cap, edge_dim), np.float32)
    ea_pad[:e] = ea
    blocks = pack_mp_blocks(np.asarray(jg.senders), np.asarray(jg.receivers),
                            ea_pad, np.asarray(jg.edge_mask), jg.n_node_cap,
                            direction)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    pallas = np.asarray(pallas_mp(jp, jnp.asarray(h), blocks, D,
                                  interpret=True))
    oracle = np.asarray(mp_from_blocks(jp, jnp.asarray(h), blocks))
    np.testing.assert_allclose(got, pallas[:n], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle[:n], rtol=RTOL, atol=ATOL)
    if edge_dim == 3:   # the ops path reads the graph's 3-dim edge_attr
        want = np.asarray(jops.message_passing(jp, jnp.asarray(h), jg,
                                               direction))
        np.testing.assert_allclose(got, want[:n], rtol=RTOL, atol=ATOL)
    # the packing keeps exactly the edges the TPU packing keeps
    assert csr.n_edges == int(np.asarray(blocks.mask).sum())


@pytest.mark.parametrize("direction", ["to", "from"])
def test_message_passing_dispatches_plain_on_cpu(graphs, direction):
    _, _, tg = graphs
    gen = torch.Generator().manual_seed(0)
    mlp = MLP([2 * D + 3, D, D], generator=gen)
    h = torch.randn(tg.total_nodes, D, generator=gen)
    csr = tg.mp_to if direction == "to" else tg.mp_from
    before = tmp.LAUNCHES
    got = ops.message_passing(mlp, h, tg, direction)
    l1, l2 = mlp.layers
    want = tmp.mp_from_csr(l1.weight, l1.bias, l2.weight, l2.bias, h, csr)
    assert torch.equal(got, want)
    assert tmp.LAUNCHES == before     # the CPU path launches no kernel


def test_csr_packing_structure(graphs):
    _, _, tg = graphs
    s, r = tg.senders.numpy(), tg.receivers.numpy()
    keep = s != r
    for direction, agg_src, oth_src in (("to", r, s), ("from", s, r)):
        csr = tg.mp_to if direction == "to" else tg.mp_from
        np.testing.assert_array_equal(
            np.diff(csr.row_ptr.numpy()),
            np.bincount(agg_src[keep], minlength=tg.total_nodes))
        # each row holds its edges' other endpoints in COO order
        order = np.argsort(agg_src[keep], kind="stable")
        np.testing.assert_array_equal(csr.oth.numpy(), oth_src[keep][order])
        assert csr.row_ptr.dtype == torch.int32 and csr.oth.dtype == torch.int32
    # A is not symmetric (Dirichlet rows), so the two packings differ
    assert not torch.equal(tg.mp_to.row_ptr, tg.mp_from.row_ptr)


def test_pack_csr_drops_masked_edges_and_self_loops():
    s = np.array([0, 1, 2, 2, 1, 0])
    r = np.array([1, 0, 2, 1, 2, 2])
    ea = np.arange(6, dtype=np.float32).reshape(6, 1)
    mask = np.array([True, True, True, True, False, True])
    csr = tmp.pack_csr(s, r, ea, 3, "to", edge_mask=mask)
    # kept: 0->1, 1->0, 2->1, 0->2 ; grouped by receiver, COO order inside
    np.testing.assert_array_equal(csr.row_ptr.numpy(), [0, 1, 3, 4])
    np.testing.assert_array_equal(csr.oth.numpy(), [1, 0, 2, 0])
    np.testing.assert_array_equal(csr.edge_attr.numpy()[:, 0], [1, 0, 3, 5])
    with pytest.raises(ValueError):
        tmp.pack_csr(s, r, ea, 3, "sideways")


def test_wrapper_refuses_other_devices(graphs):
    """No fallback: a tensor that is neither on the CPU nor on a CUDA device
    raises instead of taking the plain path."""
    _, _, tg = graphs
    mlp = MLP([2 * D + 3, D, D])
    l1, l2 = mlp.layers
    h = torch.zeros(tg.total_nodes, D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tmp.fused_message_passing(l1.weight, l1.bias, l2.weight, l2.bias, h,
                                  tg.mp_to)
