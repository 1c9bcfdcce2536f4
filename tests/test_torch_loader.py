"""Port dataset factory, ``load_dataset``, ``split_dataset`` and
``GraphLoader`` against the JAX package at the same seeds."""

import os

import numpy as np
import pytest
import torch

from psignn_tpu.data import generate as jgenerate
from psignn_tpu.data import reader as jreader
from psignn_tpu_torch.data import generate, reader

KEYS = ("A_sparse_matrix", "b_matrix", "sol", "prb_data", "tags",
        "coordinates", "distance")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same small dataset written by both factories."""
    out = []
    for mod in (jgenerate, generate):
        path = str(tmp_path_factory.mktemp("data"))
        mod.generate_data(path, n_mesh=3, n_samples=4, hsize=0.3, seed=21,
                          verbose=False)
        out.append(path)
    return out


def test_generate_data_matches_jax(datasets):
    jpath, tpath = datasets
    for k in KEYS:
        want = np.load(os.path.join(jpath, k + ".npy"), allow_pickle=True)
        got = np.load(os.path.join(tpath, k + ".npy"), allow_pickle=True)
        assert got.dtype == object and len(got) == len(want) == 12, k
        for a, b in zip(got, want):
            if k == "A_sparse_matrix":
                a, b = a.toarray(), b.toarray()
            # identical meshes and arithmetic (tests/test_torch_data.py)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=k)
    with open(os.path.join(jpath, "dataset_info.csv")) as f:
        want = f.read()
    with open(os.path.join(tpath, "dataset_info.csv")) as f:
        assert f.read() == want


@pytest.mark.parametrize("stats", ["reference", "auto"])
def test_load_dataset_matches_jax(datasets, stats):
    jpath, _ = datasets
    want = jreader.load_dataset(jpath, family="psignn", stats=stats)
    got = reader.load_dataset(jpath, stats=stats)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_load_dataset_refuses_unported(datasets):
    """Every family is ported now; an unknown family, a DSS mixed dataset
    (the reference has none) and unknown statistics are refused."""
    jpath, _ = datasets
    with pytest.raises(ValueError, match="family"):
        reader.load_dataset(jpath, family="gnn")
    with pytest.raises(ValueError, match="Dirichlet variant only"):
        reader.load_dataset(jpath, family="dss", variant="mixed")
    with pytest.raises(ValueError):
        reader.load_dataset(jpath, stats="dataset-mean")


@pytest.mark.parametrize("n", [5, 10, 12, 20, 23])
def test_split_dataset_matches_jax(n):
    items = list(range(n))
    assert reader.split_dataset(items) == tuple(
        jreader.split_dataset(items, family="psignn"))


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True)])
def test_loader_batches_match_jax(datasets, shuffle, drop_last):
    """Two epochs: the same samples in the same batches, node for node."""
    jpath, _ = datasets
    samples = reader.load_dataset(jpath)
    train, _, _ = reader.split_dataset(samples)
    jl = jreader.GraphLoader(train, batch_size=3, shuffle=shuffle, seed=4,
                             drop_last=drop_last)
    tl = reader.GraphLoader(train, batch_size=3, shuffle=shuffle, seed=4,
                            drop_last=drop_last, device="cpu")
    assert len(tl) == len(jl)
    for _ in range(2):
        jbatches, tbatches = list(jl), list(tl)
        assert len(tbatches) == len(jbatches) == len(tl)
        for jg, tg in zip(jbatches, tbatches):
            n = tg.total_nodes
            np.testing.assert_array_equal(tg.n_nodes.numpy(),
                                          np.asarray(jg.n_nodes))
            np.testing.assert_array_equal(tg.x.numpy(),
                                          np.asarray(jg.x)[:n])
            np.testing.assert_array_equal(tg.prb_data.numpy(),
                                          np.asarray(jg.prb_data)[:n])
            assert tg.device == torch.device("cpu")


def test_loader_shuffles_by_epoch(datasets):
    jpath, _ = datasets
    samples = reader.load_dataset(jpath)
    tl = reader.GraphLoader(samples, batch_size=5, shuffle=True, seed=2,
                            device="cpu")
    first, second = tl.batch_order(0), tl.batch_order(1)
    assert [len(b) for b in first] == [5, 5, 2]
    order = np.arange(12)
    np.random.RandomState(3).shuffle(order)
    np.testing.assert_array_equal(np.concatenate(second), order)
    assert not np.array_equal(np.concatenate(first), order)
