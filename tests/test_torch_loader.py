"""Port dataset factory, ``load_dataset``, ``split_dataset`` and
``GraphLoader`` (its RCM order and cached batches too) against the JAX
package at the same seeds."""

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


# ------------------------------------------------ node order, cached batches

def _real_rows(jg, name: str, shard=None):
    """The real rows of a JAX batch's node (or edge) array ``name``:
    a plain batch's leading rows, a shard's, or a stack's graphs' own
    rows one after another."""
    a = np.asarray(getattr(jg, name))
    counts = np.asarray(jg.n_edges if name in ("senders", "receivers",
                                               "edge_attr", "a_ij")
                        else jg.n_nodes)
    if shard is not None:
        a, counts = a[shard], counts[shard]
    if a.ndim > 1 and counts.ndim == 2:       # stacked: (G, cap, ...)
        return np.concatenate([a[i][:int(counts[i].sum())]
                               for i in range(a.shape[0])])
    return a[:int(counts.sum())]


def _same_batch(tg, jg, samples, sel, shard=None):
    """The port's batch ``tg`` holds ``samples[sel]`` in order and equals
    the JAX batch ``jg`` (or its shard) array for array."""
    if shard is None:
        want_x = np.concatenate([samples[j]["x"] for j in sel])
        np.testing.assert_array_equal(tg.x.numpy(), want_x)
    for k in ("x", "sol", "prb_data", "pos", "edge_attr"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      _real_rows(jg, k, shard), err_msg=k)
    if jg.n_nodes.ndim == 1 or shard is not None:
        # a stack's graphs number their nodes from 0 each
        for k in ("senders", "receivers"):
            np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                          _real_rows(jg, k, shard), k)


def test_loader_rcm_samples_match_jax(datasets):
    """``rcm=True`` puts each sample in JAX's RCM order: the loader's
    samples equal the JAX loader's array for array, and their bandwidth
    is below the mesh order's."""
    jpath, _ = datasets
    samples = reader.load_dataset(jpath)
    got = reader.GraphLoader(samples, rcm=True, device="cpu").samples
    want = jreader.GraphLoader(samples, rcm=True).samples
    assert len(got) == len(want) == len(samples)
    for g, w, s in zip(got, want, samples):
        assert set(g) == set(w) == set(s)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        band = [int(np.abs(d["senders"] - d["receivers"]).max())
                for d in (s, g)]
        assert band[1] < band[0]


@pytest.mark.parametrize("kw", [dict(), dict(n_devices=2),
                                dict(stacked=True), dict(drop_last=True)],
                         ids=["plain", "dp2", "stacked", "drop_last"])
def test_cached_batches_match_jax(datasets, kw):
    """``cache_batches`` with ``shuffle`` and ``rcm`` over 4 epochs
    against the JAX loader on the CPU: each batch (each data-parallel
    rank's shard of it, each stack) holds the samples ``batch_order``
    names and equals JAX's array for array; the membership is epoch 0's
    in every epoch, later epochs reorder the batches; every epoch yields
    the same stored graph objects."""
    jpath, _ = datasets
    samples = reader.load_dataset(jpath)
    train, _, _ = reader.split_dataset(samples)
    common = dict(batch_size=3, shuffle=True, seed=4, rcm=True,
                  cache_batches=True)
    jl = jreader.GraphLoader(train, **common, **kw)
    n_dev = kw.get("n_devices", 1)
    loaders = [reader.GraphLoader(train, **common, **kw, device="cpu",
                                  **(dict(rank=r) if n_dev > 1 else {}))
               for r in range(n_dev)]
    ordered = loaders[0].samples
    sets, ids = [], []
    for epoch in range(4):
        jbatches = list(jl)
        for r, tl in enumerate(loaders):
            tbatches = list(tl)
            order = tl.batch_order(epoch)
            assert len(tbatches) == len(jbatches) == len(order) == len(tl)
            for tg, jg, sel in zip(tbatches, jbatches, order):
                _same_batch(tg, jg, ordered, sel,
                            r if n_dev > 1 else None)
            if r == 0:
                sets.append(sorted(tuple(sorted(set(sel))) for sel in order))
                ids.append([id(g) for g in tbatches])
    assert all(s == sets[0] for s in sets)
    assert all(sorted(i) == sorted(ids[0]) for i in ids)
    assert any(i != ids[0] for i in ids[1:])


def test_uncached_batches_redeal_every_epoch(datasets):
    """Without the cache the batches are dealt anew each epoch (the
    reference's semantics), so the membership moves."""
    jpath, _ = datasets
    tl = reader.GraphLoader(reader.load_dataset(jpath), batch_size=3,
                            shuffle=True, seed=4, device="cpu")
    sets = [sorted(tuple(sorted(sel)) for sel in tl.batch_order(e))
            for e in range(3)]
    assert sets[1] != sets[0] and sets[2] != sets[0]
