"""Port mixed Dirichlet+Neumann data path (meshes, normals, FEM, the dataset
factory, ``load_dataset``, the shuffled ``split_dataset`` and the batch
masks) against the JAX package at the same seeds
(``tests/test_mixed_data.py`` mirrored).  Every array is compared exactly:
both packages run the same numpy and scipy arithmetic."""

import os

import numpy as np
import pytest

from psignn_tpu.data import fem as jfem
from psignn_tpu.data import generate as jgenerate
from psignn_tpu.data import meshgen as jmeshgen
from psignn_tpu.data import reader as jreader
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu_torch.data import fem, generate, meshgen, reader
from psignn_tpu_torch.graphs import batch_graphs

KEYS = ("A_sparse_matrix", "b_matrix", "sol", "prb_data", "tags",
        "coordinates", "distance", "unit_normal_vector")


@pytest.mark.parametrize("seed,hsize", [(3, 0.12), (5, 0.15), (7, 0.2)])
def test_mixed_mesh_normals_and_fem_match_jax(seed, hsize):
    want = jmeshgen.mixed_blob_mesh(radius=1.0, hsize=hsize, seed=seed)
    got = meshgen.mixed_blob_mesh(radius=1.0, hsize=hsize, seed=seed)
    for k in ("points", "triangles", "boundary_mask", "boundary_tag",
              "boundary_loop"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    tags = got.boundary_tag[got.boundary_loop]
    assert set(np.unique(tags)) == {101, 303}
    # contiguous arcs: at most 4 Dirichlet/Neumann interfaces, 8 switches
    assert int((tags != np.roll(tags, 1)).sum()) <= 8
    np.testing.assert_array_equal(fem.vertex_unit_normals(got),
                                  jfem.vertex_unit_normals(want))

    w = jfem.solve_poisson_mixed(want, 1.0, np.random.default_rng(seed))
    g = fem.solve_poisson_mixed(got, 1.0, np.random.default_rng(seed))
    assert set(g) == set(w)
    for k in w:
        a, b = (g[k].toarray(), w[k].toarray()) if k == "A" else (g[k], w[k])
        np.testing.assert_array_equal(a, b, err_msg=k)
    # one-hot [interior, dirichlet, neumann]; problem data [f, g, f_neumann]
    t, prb = g["tags"], g["prb_data"]
    np.testing.assert_array_equal(t.sum(axis=1), 1.0)
    didx, nidx = np.where(t[:, 1] == 1)[0], np.where(t[:, 2] == 1)[0]
    assert len(didx) and len(nidx)
    assert np.all(prb[didx][:, [0, 2]] == 0) and np.all(prb[nidx, :2] == 0)
    np.testing.assert_array_equal(g["b"][didx, 0], prb[didx, 1])
    nz = np.linalg.norm(g["unit_normal_vector"], axis=1) > 0
    np.testing.assert_array_equal(nz, got.boundary_mask)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same small mixed dataset written by both factories."""
    out = []
    for mod in (jgenerate, generate):
        path = str(tmp_path_factory.mktemp("mixed"))
        mod.generate_data(path, n_mesh=3, n_samples=4, hsize=0.3, seed=9,
                          variant="mixed", verbose=False)
        out.append(path)
    return out


def test_generate_mixed_matches_jax(datasets):
    jpath, tpath = datasets
    for k in KEYS:
        want = np.load(os.path.join(jpath, k + ".npy"), allow_pickle=True)
        got = np.load(os.path.join(tpath, k + ".npy"), allow_pickle=True)
        assert got.dtype == object and len(got) == len(want) == 12, k
        for a, b in zip(got, want):
            if k == "A_sparse_matrix":
                a, b = a.toarray(), b.toarray()
            np.testing.assert_array_equal(a, b, err_msg=k)
    with open(os.path.join(jpath, "dataset_info.csv")) as f:
        want = f.read()
    with open(os.path.join(tpath, "dataset_info.csv")) as f:
        assert f.read() == want


@pytest.mark.parametrize("stats", ["reference", "auto"])
def test_load_mixed_dataset_matches_jax(datasets, stats):
    jpath, _ = datasets
    want = jreader.load_dataset(jpath, family="psignn", variant="mixed",
                                stats=stats)
    got = reader.load_dataset(jpath, variant="mixed", stats=stats)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert set(g) == set(w) and "unit_normal_vector" in g
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the initial condition is b on the Dirichlet rows (one-hot column 1)
    s = got[0]
    d = s["tags"][:, 1] == 1
    np.testing.assert_array_equal(s["x"][d], s["b"][d])
    assert not s["x"][~d].any()


@pytest.mark.parametrize("n,seed", [(5, 1234), (12, 1234), (23, 1234),
                                    (50, 7)])
def test_mixed_split_membership_matches_jax(n, seed):
    items = list(range(n))
    got = reader.split_dataset(items, variant="mixed", seed=seed)
    want = jreader.split_dataset(items, family="psignn", variant="mixed",
                                 seed=seed)
    assert [list(p) for p in got] == [list(p) for p in want]
    # shuffled, and each sample in exactly one part
    assert sorted(sum(map(list, got), [])) == items
    if n >= 12:
        assert list(got[0]) != items[:len(got[0])]


def test_mixed_batch_masks_match_jax(datasets):
    jpath, _ = datasets
    samples = reader.load_dataset(jpath, variant="mixed")[:3]
    jg = jax_batch_graphs(samples)
    tg = batch_graphs(samples, device="cpu")
    n = tg.total_nodes
    assert tg.tags.shape == (n, 3) and tg.prb_data.shape == (n, 3)
    for k in ("dirichlet_mask", "neumann_mask", "x", "prb_data",
              "unit_normal_vector", "tags"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k))[:n],
                                      err_msg=k)
    # Dirichlet and Neumann rows are disjoint and only on the boundary
    d, nm = tg.dirichlet_mask[:, 0] > 0, tg.neumann_mask[:, 0] > 0
    assert d.any() and nm.any() and not (d & nm).any()
    assert not (tg.tags[:, 0][d | nm]).any()


def test_dirichlet_batch_has_no_mixed_fields():
    from _torch_parity import fem_sample
    tg = batch_graphs([fem_sample(0, hsize=0.3)], device="cpu")
    assert tg.neumann_mask is None and tg.unit_normal_vector is None
    assert tg.tags.shape[1] == 1 and tg.prb_data.shape[1] == 2


def test_unknown_variant_refused(datasets, tmp_path):
    jpath, _ = datasets
    with pytest.raises(ValueError):
        reader.load_dataset(jpath, variant="neumann")
    with pytest.raises(ValueError):
        reader.split_dataset([1, 2], variant="neumann")
    with pytest.raises(ValueError):
        generate.generate_data(str(tmp_path), n_mesh=1, n_samples=1,
                               variant="neumann", verbose=False)
