"""The port's single-graph partition pieces against the JAX package
(``psignn_tpu/dist/partition.py``, ``partitioned.py`` and the RCM helpers
of ``kernels/fused_mp.py``) on the CPU: the RCM order and the partition
arrays, exactly; the window CSRs' edge sets, exactly; and, on a spawned
gloo world of 4 ranks (``_torch_dist``), the edge-sharded message passing
and SpMV against ``ops`` and JAX's ``partition_message_passing`` /
``partition_spmv`` on 4 virtual devices, and the halo message passing
against ``ops`` — values within 1e-5 · max(1, max|out|) (f32 sums in
another order), gradients of a seeded projection within 1e-5 relative
and 1e-6 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from _torch_parity import fem_sample, jax_mlp_params, mixed_sample
from psignn_tpu.dist import make_mesh as jax_make_mesh
from psignn_tpu.dist import partition_message_passing as jax_partition_mp
from psignn_tpu.dist import partition_spmv as jax_partition_spmv
from psignn_tpu.dist.partition import \
    build_halo_partition as jax_build_halo_partition
from psignn_tpu.dist.partition import \
    pad_edges_for_sharding as jax_pad_edges
from psignn_tpu.dist.partitioned import \
    build_partitioned_graph as jax_build_partitioned_graph
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.kernels import rcm_permutation as jax_rcm_permutation
from psignn_tpu.kernels.fused_mp import \
    apply_node_permutation as jax_apply_node_permutation
from psignn_tpu_torch import ops
from psignn_tpu_torch.dist.partition import (apply_node_permutation,
                                             build_halo_partition,
                                             pad_edges_for_sharding,
                                             rcm_permutation, window_csr)
from psignn_tpu_torch.dist.partitioned import (build_partitioned_graph,
                                               partition_arrays)
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.nn import MLP
from psignn_tpu_torch.weights import _ToTorch

D = 6
REL = 1e-5
PARTS = 4


def _rcm(s):
    perm = rcm_permutation(s["senders"], s["receivers"], s["x"].shape[0])
    return apply_node_permutation(s, perm)


@pytest.fixture(scope="module")
def dsample():
    return _rcm(fem_sample(7, hsize=0.11))


@pytest.fixture(scope="module")
def msample():
    return _rcm(mixed_sample(3, hsize=0.15))


def _equal_trees(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _equal_trees(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("kind", ["dirichlet", "mixed"])
def test_rcm_order_and_permutation_match_jax(kind):
    s = fem_sample(7, hsize=0.11) if kind == "dirichlet" \
        else mixed_sample(3, hsize=0.15)
    perm = rcm_permutation(s["senders"], s["receivers"], s["x"].shape[0])
    want = jax_rcm_permutation(s["senders"], s["receivers"], s["x"].shape[0])
    np.testing.assert_array_equal(perm, want)
    got = apply_node_permutation(s, perm)
    _equal_trees(got, jax_apply_node_permutation(s, want))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("parts", [2, 4, 8])
def test_halo_partition_matches_jax(dsample, parts, split):
    """``build_halo_partition``'s packs, ``n_loc`` and ``halo`` equal
    JAX's array for array (the packing is vectorised here)."""
    s = dsample
    args = (s["senders"], s["receivers"], s["edge_attr"], s["x"].shape[0],
            parts)
    _equal_trees(build_halo_partition(*args, split_interior=split),
                 jax_build_halo_partition(*args, split_interior=split))


@pytest.mark.parametrize("kind,parts", [("dirichlet", 2), ("dirichlet", 4),
                                        ("mixed", 2)])
def test_partitioned_graph_arrays_match_jax(dsample, msample, kind, parts):
    """``partition_arrays`` equals every field of JAX's
    ``build_partitioned_graph`` exactly, and each rank's
    ``PartitionedGraph`` holds its part of them."""
    s = dsample if kind == "dirichlet" else msample
    got = partition_arrays(s, parts)
    want = jax_build_partitioned_graph(s, n_parts=parts)
    for k in ("x", "b", "sol", "prb_data", "dir_mask", "node_mask", "diag",
              "mp_to", "mp_from", "spmv", "unit_normal_vector", "neu_mask"):
        w = getattr(want, k)
        if w is None:
            assert k not in got, k
            continue
        _equal_trees(got[k], jax.tree.map(np.asarray, w), k)
    assert (got["n_loc"], got["halo"], got["n_parts"]) == \
        (want.n_loc, want.halo, want.n_parts)
    for p in range(parts):
        pg = build_partitioned_graph(s, parts, p, device="cpu")
        for k in ("x", "b", "prb_data", "dir_mask", "diag"):
            np.testing.assert_array_equal(getattr(pg, k).numpy(),
                                          got[k][p], err_msg=k)
        m = got["spmv"]["mask"][p] > 0
        np.testing.assert_array_equal(pg.spmv_col.numpy(),
                                      got["spmv"]["oth_local"][p][m])


def _csr_edges(csr, halo):
    """{(aggregation row, other endpoint): edge_attr} of a window CSR, the
    rows as part-local indices."""
    rows = np.repeat(np.arange(csr.n_rows), np.diff(csr.row_ptr.numpy()))
    return {(int(r) - halo, int(o)): tuple(e) for r, o, e in
            zip(rows, csr.oth.numpy(), csr.edge_attr.numpy())}


@pytest.mark.parametrize("direction", ["to", "from"])
def test_window_csr_holds_the_jax_packs_edges(dsample, direction):
    """Each part's window CSR (the kernels' packing) holds exactly the
    edges of JAX's interior and boundary packs, in window coordinates, and
    its ``reverse()`` the same edges by source."""
    s, parts = dsample, 4
    arr = partition_arrays(s, parts)
    n_loc, halo = arr["n_loc"], arr["halo"]
    for p in range(parts):
        csr = window_csr(s["senders"], s["receivers"], s["edge_attr"], p,
                         n_loc, halo, direction)
        assert csr.n_rows == n_loc + 2 * halo
        want = {}
        for kind, shift in (("int", halo), ("bnd", 0)):
            pk = arr[f"mp_{direction}"][kind]
            m = pk["mask"][p] > 0
            for a, o, e in zip(pk["agg_local"][p][m], pk["oth_local"][p][m],
                               pk["edge_attr"][p][m]):
                want[(int(a), int(o) + shift)] = tuple(e)
        assert _csr_edges(csr, halo) == want
        assert _csr_edges(csr.reverse().reverse(), halo) == want


def test_pad_edges_for_sharding_matches_jax():
    arrs = dict(senders=np.arange(10, dtype=np.int32),
                receivers=np.arange(10, dtype=np.int32),
                a_ij=np.ones((10, 1), np.float32),
                edge_mask=np.ones(10, bool))
    for n in (4, 5, 8):
        _equal_trees(pad_edges_for_sharding(dict(arrs), n),
                     jax_pad_edges(dict(arrs), n))


def test_halo_partition_refuses_a_halo_wider_than_a_part(dsample):
    s = dsample
    with pytest.raises(ValueError, match="exceeds partition size"):
        build_halo_partition(s["senders"], s["receivers"], s["edge_attr"],
                             s["x"].shape[0], 64)


# ------------------------------------------------- on 4 gloo ranks

def _mlp(params):
    conv = _ToTorch()
    conv.mlp("m", params)
    mlp = MLP([2 * D + 3, D, D])
    mlp.load_state_dict({k[2:]: v for k, v in conv.sd.items()})
    return mlp


@pytest.fixture(scope="module")
def ranked(dsample, tmp_path_factory):
    """The edge-sharded ops and the halo message passing on 4 ranks."""
    rng = np.random.default_rng(5)
    g = fem_sample(3, hsize=0.2)
    params = jax_mlp_params(rng, [2 * D + 3, D, D])
    arrs = pad_edges_for_sharding(dict(
        senders=g["senders"], receivers=g["receivers"],
        edge_attr=g["edge_attr"].astype(np.float32), a_ij=g["a_ij"],
        edge_mask=np.ones(len(g["senders"]), bool)), PARTS)
    n = g["x"].shape[0]
    h = rng.normal(size=(n, D)).astype(np.float32)
    u = rng.normal(size=(n, 1)).astype(np.float32)
    part = build_halo_partition(dsample["senders"], dsample["receivers"],
                                dsample["edge_attr"], dsample["x"].shape[0],
                                PARTS)
    h_parts = rng.normal(size=(PARTS, part["n_loc"], D)).astype(np.float32)
    h_parts.reshape(-1, D)[dsample["x"].shape[0]:] = 0.0
    jobs = [("edge_sharded", dict(h=h, mlp_params=params, u=u, dp=1,
                                  parts=PARTS, **arrs)),
            ("halo_mp", dict(h_parts=h_parts, mlp_params=params, part=part,
                             parts=PARTS))]
    out = _torch_dist.spawn(tmp_path_factory.mktemp("rdv"), PARTS, jobs)
    return dict(g=g, params=params, arrs=arrs, h=h, u=u, part=part,
                h_parts=h_parts, out=out)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("direction", ["to", "from"])
def test_edge_sharded_mp_matches_ops_and_jax(ranked, direction):
    """Every rank holds the full aggregation of ``ops.message_passing``
    and of JAX's ``partition_message_passing``; its gradient w.r.t. h and
    the first weight (summed over the ranks by the op's backward) is the
    plain path's."""
    r = ranked
    mlp = _mlp(r["params"])
    ht = torch.from_numpy(r["h"]).requires_grad_()
    tg = batch_graphs([r["g"]], device="cpu")
    want = ops.message_passing(mlp, ht, tg, direction)
    proj = torch.from_numpy(np.cos(np.arange(r["h"].size, dtype=np.float32))
                            .reshape(r["h"].shape))
    torch.sum(want * proj).backward()
    jg = jax_batch_graphs([r["g"]])
    jh = jnp.zeros((jg.n_node_cap, D)).at[:len(r["h"])].set(r["h"])
    jwant = jax_partition_mp(jax_make_mesh(PARTS, axis="x"), axis="x")(
        jax.tree.map(jnp.asarray, r["params"]), jh,
        *(jnp.asarray(r["arrs"][k]) for k in
          ("senders", "receivers", "edge_attr", "edge_mask")), direction)
    for got, dh, dw in (rank[0][direction] for rank in r["out"]):
        _close(got, want.detach().numpy())
        _close(got, np.asarray(jwant)[:len(r["h"])])
        np.testing.assert_allclose(dh, ht.grad.numpy(), rtol=REL, atol=1e-6)
        np.testing.assert_allclose(dw, mlp.layers[0].weight.grad.numpy(),
                                   rtol=REL, atol=1e-6)


def test_edge_sharded_spmv_matches_ops_and_jax(ranked):
    r = ranked
    tg = batch_graphs([r["g"]], device="cpu")
    want = ops.spmv(tg, torch.from_numpy(r["u"])).numpy()
    jg = jax_batch_graphs([r["g"]])
    ju = jnp.zeros((jg.n_node_cap, 1)).at[:len(r["u"])].set(r["u"])
    jwant = jax_partition_spmv(jax_make_mesh(PARTS, axis="x"), axis="x")(
        ju, *(jnp.asarray(r["arrs"][k]) for k in
              ("senders", "receivers", "a_ij", "edge_mask")))
    for rank in r["out"]:
        _close(rank[0]["spmv"], want)
        _close(rank[0]["spmv"], np.asarray(jwant)[:len(r["u"])])


@pytest.mark.parametrize("direction", ["to", "from"])
def test_halo_mp_matches_ops(ranked, dsample, direction):
    """Each rank's rows of ``halo_message_passing`` (one strip exchange)
    are the rows of ``ops.message_passing`` on the whole mesh, and the
    gradient w.r.t. each rank's rows — halo rows' cotangents returned to
    their owners by the exchange's backward — is the whole mesh's."""
    r = ranked
    n = dsample["x"].shape[0]
    mlp = _mlp(r["params"])
    h = torch.from_numpy(r["h_parts"].reshape(-1, D)[:n]).requires_grad_()
    tg = batch_graphs([dsample], device="cpu")
    want = ops.message_passing(mlp, h, tg, direction)
    n_loc = r["part"]["n_loc"]
    proj = np.concatenate([np.sin(np.arange(n_loc * D, dtype=np.float32)
                                  .reshape(n_loc, D) + p)
                           for p in range(PARTS)])[:n]
    torch.sum(want * torch.from_numpy(proj)).backward()
    got = np.concatenate([rank[1][direction][0] for rank in r["out"]])[:n]
    dh = np.concatenate([rank[1][direction][1] for rank in r["out"]])[:n]
    _close(got, want.detach().numpy())
    np.testing.assert_allclose(dh, h.grad.numpy(), rtol=REL, atol=1e-6)
