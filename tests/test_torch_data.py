"""Port data path (meshgen, FEM, sample conversion, batching) against the
JAX package on the same seeds."""

import numpy as np
import pytest
import torch

from psignn_tpu.data import fem as jfem
from psignn_tpu.data import meshgen as jmesh
from psignn_tpu.data import reader as jreader
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu_torch.data import fem, meshgen, reader
from psignn_tpu_torch.graphs import batch_graphs

SEEDS = (0, 1, 2)


def _both(seed, radius=1.0, hsize=0.2):
    """(JAX mesh, FEM dict), (port mesh, FEM dict) from one seed."""
    out = []
    for mg, fe in ((jmesh, jfem), (meshgen, fem)):
        rng = np.random.default_rng(seed)
        m = mg.blob_mesh(radius=radius, hsize=hsize, rng=rng)
        out.append((m, fe.solve_poisson(m, radius, rng)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_blob_mesh_identical(seed):
    (jm, _), (tm, _) = _both(seed, radius=1.0 + 0.5 * seed, hsize=0.25)
    np.testing.assert_array_equal(tm.points, jm.points)
    np.testing.assert_array_equal(tm.triangles, jm.triangles)
    np.testing.assert_array_equal(tm.boundary_mask, jm.boundary_mask)
    np.testing.assert_array_equal(tm.boundary_loop, jm.boundary_loop)


def test_points_in_polygon_matches_matplotlib():
    from matplotlib.path import Path
    rng = np.random.default_rng(5)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 40))
    poly = (1 + 0.4 * rng.uniform(-1, 1, 40))[:, None] * np.stack(
        [np.cos(ang), np.sin(ang)], axis=1)
    pts = rng.uniform(-1.6, 1.6, (5000, 2))
    np.testing.assert_array_equal(meshgen.points_in_polygon(poly, pts, 512),
                                  Path(poly).contains_points(pts))


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_poisson_matches(seed):
    (_, js), (_, ts) = _both(seed)
    # identical meshes and arithmetic: the system agrees to round-off
    np.testing.assert_allclose(ts["A"].toarray(), js["A"].toarray(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts["b"], js["b"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts["sol"], js["sol"], rtol=0, atol=1e-12)
    for k in ("prb_data", "tags", "distance", "coordinates"):
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=1e-12)
    # Dirichlet rows are identity rows with their columns kept: A is not
    # symmetric, so the two message-passing directions differ
    A = ts["A"]
    assert abs(A - A.T).max() > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_psignn_sample_from_fem_matches(seed):
    (_, js), (_, ts) = _both(seed)
    jsam = jreader.psignn_sample_from_fem(js)
    tsam = reader.psignn_sample_from_fem(ts)
    assert set(tsam) == set(jsam)
    for k in jsam:
        assert tsam[k].dtype == jsam[k].dtype, k
        np.testing.assert_array_equal(tsam[k], jsam[k], err_msg=k)
    assert reader.REF_STATS == jreader.REF_STATS


def test_batch_graphs_matches_real_rows():
    samples = [reader.psignn_sample_from_fem(_both(s)[1][1]) for s in (0, 1)]
    jg = jax_batch_graphs(samples)
    tg = batch_graphs(samples, device="cpu")
    n = tg.total_nodes
    e = tg.senders.shape[0]
    assert n == int(np.asarray(jg.n_nodes).sum()) and tg.num_graphs == 2
    for k in ("x", "b", "sol", "prb_data", "tags", "pos"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k))[:n], k)
    for k in ("senders", "receivers"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k))[:e], k)
    np.testing.assert_array_equal(tg.a_ij.numpy(), np.asarray(jg.a_ij)[:e])
    np.testing.assert_array_equal(tg.edge_attr.numpy(),
                                  np.asarray(jg.edge_attr)[:e])
    np.testing.assert_array_equal(tg.dirichlet_mask.numpy(),
                                  np.asarray(jg.dirichlet_mask)[:n])
    np.testing.assert_array_equal(tg.fnode_mask.numpy(),
                                  np.asarray(jg.fnode_mask)[:n])
    np.testing.assert_array_equal(tg.graph_id.numpy(),
                                  np.asarray(jg.graph_id)[:n])
    np.testing.assert_array_equal(tg.mp_edge_mask.numpy(),
                                  np.asarray(jg.mp_edge_mask)[:e])
    np.testing.assert_array_equal(tg.n_nodes.numpy(), np.asarray(jg.n_nodes))
    np.testing.assert_array_equal(tg.n_edges.numpy(), np.asarray(jg.n_edges))
    assert tg.x.dtype == torch.float32 and tg.senders.dtype == torch.int64
