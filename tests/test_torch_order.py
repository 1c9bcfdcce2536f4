"""The JAX package's node order and device-resident batches in the port,
against the JAX package on the CPU:

* ``eval.sweep.build_data(pallas=True)`` and the samples of
  ``eval.nstep_study.eval_mesh(pallas=True)`` equal JAX's array for array
  (each package's blob mesh from the same seed, which
  ``test_torch_data.py`` holds equal);
* the plain forward message passing on an RCM-ordered batch of the
  port's loader against JAX's ``ops.message_passing`` on JAX's loader's
  batch, within ``tests/test_kernels.py``'s 2e-4;
* ``run_eval --pallas`` and ``parity --pallas`` pass the order to the
  sweep and the zoo (-1: on for a card, off on the CPU), and a sweep
  answered in RCM order equals the mesh-order answer (DSS is
  permutation-equivariant; only f32 sums move);
* a cached loader's tensors come back unchanged after the trainer's
  epochs over them, for every family, per mesh and in bfloat16 data, and
  every epoch yields the same stored graphs;
* a CLI run with ``--rcm --cache_batches 1`` against JAX's CLI with the
  same flags on the same tiny dataset (JAX on XLA message passing): two
  DS-GPS epochs at k = 3, both resumed from the trained JAX checkpoint so
  that they start from the same weights and Adam state, within
  ``test_torch_unrolled_train.py``'s 2e-4;
* the bookkeeping of ``chip_smoke.py``'s ``order`` phase: the batch
  permutation, the sample ids of a batch, the bytes of a batch.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import DSGPS_CKPT, DSS_CKPT, jax_mlp_params
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu import ops as jops
from psignn_tpu.cli.main import main as jax_main
from psignn_tpu.data import meshgen as jmeshgen
from psignn_tpu.data import reader as jreader
from psignn_tpu.eval import nstep_study as jnstep
from psignn_tpu.eval import sweep as jsweep
from psignn_tpu_torch import ops
from psignn_tpu_torch.cli.main import main
from psignn_tpu_torch.data import meshgen
from psignn_tpu_torch.data.generate import generate_data
from psignn_tpu_torch.data.reader import (GraphLoader, load_dataset,
                                          split_dataset)
from psignn_tpu_torch.eval import nstep_study, parity, run_eval, sweep
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import DsgpsConfig, DssConfig, PsignnConfig
from psignn_tpu_torch.nn import MLP
from psignn_tpu_torch.train import TrainConfig, Trainer
from psignn_tpu_torch.weights import load_jax_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 10
# tests/test_kernels.py's tolerance for message passing on other sums
MP_TOL = 2e-4
# test_torch_unrolled_train.py's tolerance for unrolled losses and answers
UNROLLED_RTOL = 2e-4
FAST = dict(fw_tol=1e-3, fw_thres=25, bw_tol=1e-5, bw_thres=25)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data"))
    generate_data(path, n_mesh=3, n_samples=5, hsize=0.3, seed=21,
                  verbose=False)
    return path


def _equal_samples(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("families", [("psignn",), ("psignn", "dss")])
def test_build_data_rcm_matches_jax(families):
    """Each sample form of one fresh mesh, RCM-ordered, equals JAX's."""
    mesh = meshgen.blob_mesh(radius=1.0, hsize=0.25,
                             rng=np.random.default_rng(3))
    jmesh = jmeshgen.blob_mesh(radius=1.0, hsize=0.25,
                               rng=np.random.default_rng(3))
    got = sweep.build_data(mesh, 1.0, np.random.default_rng(4), families,
                           pallas=True)
    want = jsweep.build_data(jmesh, 1.0, np.random.default_rng(4), families,
                             pallas=True)
    plain = sweep.build_data(mesh, 1.0, np.random.default_rng(4), families)
    assert set(got) == set(want) == set(families)
    for form in families:
        _equal_samples(got[form], want[form])
        assert not np.array_equal(got[form]["senders"],
                                  plain[form]["senders"])


def test_eval_mesh_rcm_samples_match_jax():
    """``eval_mesh(pallas=True)`` asks its predictor about JAX's samples:
    each request's graph holds the arrays JAX's request holds."""
    seen = {"jax": [], "torch": []}

    def recorder(name, to_numpy):
        def predict(g):
            seen[name].append({k: to_numpy(getattr(g, k), g)
                               for k in ("x", "b", "pos", "senders",
                                         "receivers", "edge_attr")})
            return g.x, 1, 1.0
        return predict

    def jax_rows(a, g):
        a = np.asarray(a)
        n = int(np.asarray(g.n_nodes).sum())
        e = int(np.asarray(g.n_edges).sum())
        return a[:n] if a.shape[0] == g.n_node_cap else a[:e]

    mesh = meshgen.blob_mesh(radius=1.0, hsize=0.3,
                             rng=np.random.default_rng(1))
    jmesh = jmeshgen.blob_mesh(radius=1.0, hsize=0.3,
                               rng=np.random.default_rng(1))
    got = nstep_study.eval_mesh(recorder("torch", lambda a, g: a.numpy()),
                                mesh, 1.0, 2, seed=10, device="cpu",
                                pallas=True)
    want = jnstep.eval_mesh(recorder("jax", jax_rows), jmesh, 1.0, 2,
                            seed=10, pallas=True)
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    for g, w in zip(seen["torch"], seen["jax"]):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got["a_std"] == want["a_std"]
    assert got["n_nodes"] == want["n_nodes"]


@pytest.mark.parametrize("direction", ["to", "from"])
def test_message_passing_on_rcm_batch_matches_jax(data_dir, direction):
    """The plain forward message passing on the port loader's first
    RCM-ordered batch against JAX's ``ops.message_passing`` (XLA) on the
    JAX loader's batch of the same samples."""
    train, _, _ = split_dataset(load_dataset(data_dir))
    tg = next(iter(GraphLoader(train, batch_size=3, rcm=True,
                               device="cpu")))
    jg = next(iter(jreader.GraphLoader(train, batch_size=3, rcm=True)))
    n = tg.total_nodes
    rng = np.random.default_rng(7)
    params = jax_mlp_params(rng, [2 * D + 3, D, D])
    h = np.zeros((jg.n_node_cap, D), np.float32)
    h[:n] = rng.normal(size=(n, D))
    mlp = MLP([2 * D + 3, D, D])
    with torch.no_grad():
        for layer, p in zip(mlp.layers, params):
            layer.weight.copy_(torch.from_numpy(p["w"].T.copy()))
            layer.bias.copy_(torch.from_numpy(p["b"]))
        got = ops.message_passing(mlp, torch.from_numpy(h[:n]), tg,
                                  direction).numpy()
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    want = np.asarray(jops.message_passing(jp, jnp.asarray(h), jg,
                                           direction))
    np.testing.assert_allclose(got, want[:n], rtol=MP_TOL, atol=MP_TOL)


@pytest.mark.parametrize("flag,device,want", [
    (-1, "cpu", False), (-1, "cuda", True), (-1, "cuda:1", True),
    (0, "cuda", False), (1, "cpu", True)])
def test_pallas_order_follows_the_device(flag, device, want):
    assert run_eval.pallas_order(flag, device) is want


def _spy_build_data(monkeypatch) -> list:
    asked = []
    real = sweep.build_data

    def spy(*a, **k):
        asked.append(a[4] if len(a) > 4 else k.get("pallas", False))
        return real(*a, **k)

    monkeypatch.setattr(sweep, "build_data", spy)
    return asked


@pytest.mark.parametrize("flag,want", [("-1", False), ("0", False),
                                       ("1", True)])
def test_run_eval_passes_the_order_to_sweep_and_zoo(flag, want, capsys,
                                                   monkeypatch):
    """``run_eval --sweep --zoo --pallas`` on the CPU: every sample of
    the sweep and the zoo is built in the order the flag gives."""
    from psignn_tpu_torch.eval import geometries
    asked = _spy_build_data(monkeypatch)
    monkeypatch.setattr(geometries, "GEOMETRY_BUILDERS",
                        {"heart": geometries.GEOMETRY_BUILDERS["heart"]})
    run_eval.main(["--ckpt", DSS_CKPT, "--sweep", "--zoo", "--radii", "1.0",
                   "--n_meshes", "1", "--device", "cpu", "--pallas", flag])
    capsys.readouterr()
    assert asked == [want, want]


def test_parity_report_names_the_order(tmp_path, monkeypatch, capsys):
    """``parity --pallas 1`` sweeps in RCM order and says ``pallas=1``."""
    dss = run_eval.load_predictor(DSS_CKPT, "cpu")[0]
    monkeypatch.setattr(parity, "build_predictors",
                        lambda *a, **k: {"dss": dss})
    asked = _spy_build_data(monkeypatch)
    out = tmp_path / "p.md"
    parity.main(["--radii", "1.0", "--n_meshes", "1", "--families", "dss",
                 "--device", "cpu", "--pallas", "1", "--out", str(out)])
    capsys.readouterr()
    assert asked == [True]
    assert "pallas=1" in out.read_text()


def test_sweep_in_rcm_order_answers_as_mesh_order():
    """The trained DSS answers a radius-1 sweep request alike in both
    orders: its layers commute with a permutation of the nodes, so the
    metrics differ only by f32 sums in another order."""
    predict = run_eval.load_predictor(DSS_CKPT, "cpu")[0]
    runs = [sweep.growing_geometry_sweep(
        {"dss": predict}, radii=(1.0,), n_meshes=1, hsize=0.25, seed=2,
        device="cpu", warmup=False, pallas=p)["dss"][1.0]
        for p in (False, True)]
    assert runs[0]["n_nodes"] == runs[1]["n_nodes"]
    for k in ("mse", "res", "rel"):
        np.testing.assert_allclose(runs[1][k], runs[0][k],
                                   rtol=UNROLLED_RTOL, err_msg=k)


def _snapshot(graphs) -> list:
    return [{k: t.clone() for k, t in chip_smoke.graph_tensors(g).items()}
            for g in graphs]


@pytest.mark.parametrize("case", ["psignn", "psignn_stacked",
                                  "psignn_bfloat16", "dsgps", "dss"])
def test_cached_batches_survive_training(tmp_path, data_dir, case):
    """Two epochs of the trainer over cached, RCM-ordered loaders: the
    stored graphs are the ones every epoch yields, and each of their
    tensors is bit-equal after the steps to what it was before them (no
    step writes into a batch)."""
    family = case.split("_")[0]
    if family == "dss":
        from psignn_tpu_torch.data.generate import add_dss_variable
        add_dss_variable(data_dir)
    samples = load_dataset(data_dir, family=family,
                           precision=("bfloat16" if case.endswith("bfloat16")
                                      else "float32"))
    train, val, _ = split_dataset(samples, family=family)
    stacked = case.endswith("stacked")
    common = dict(batch_size=3, rcm=True, cache_batches=True,
                  device="cpu", stacked=stacked)
    lt = GraphLoader(train, shuffle=True, seed=1, **common)
    lv = GraphLoader(val, **common)
    before = [_snapshot(list(loader)) for loader in (lt, lv)]
    stored = [[id(g) for g in loader._cached] for loader in (lt, lv)]
    model_cfg = {"psignn": PsignnConfig(**FAST),
                 "dsgps": DsgpsConfig(k=2), "dss": DssConfig(k=2)}[family]
    cfg = TrainConfig(family=family, model_cfg=model_cfg, max_epochs=2,
                      path_results=str(tmp_path), device="cpu",
                      val_sradius=False, stacked_batch=stacked,
                      gradient_clip=0.1 if family == "psignn" else 0.01)
    Trainer(cfg, lt, lv).train_model()
    for loader, snap, ids in zip((lt, lv), before, stored):
        assert [id(g) for g in loader._cached] == ids
        assert sorted(id(g) for g in loader) == sorted(ids)
        for got, want in zip(_snapshot(loader._cached), snap):
            assert set(got) == set(want)
            for k in want:
                assert torch.equal(got[k], want[k]), (case, k)


def test_cli_rcm_cached_epochs_match_jax_cli(tmp_path, data_dir,
                                             monkeypatch):
    """``--rcm --cache_batches 1`` through both CLIs: two DS-GPS epochs at
    k = 3 on the tiny dataset, each resumed from the trained JAX
    checkpoint (the same weights and Adam state, the loader's epochs
    counted from 0 as JAX counts them), so the second epoch reorders the
    frozen batches.  The per-epoch losses and the final weights agree
    within 2e-4 (relative)."""
    n = len(load_jax_checkpoint(DSGPS_CKPT)["hist_val"]["loss"])
    argv = ["--family", "dsgps", "--path_dataset", data_dir, "--k", "3",
            "--batch_size", "3", "--max_epochs", str(n + 2), "--lr", "1e-3",
            "--seed", "7", "--rcm", "--cache_batches", "1", "--resume",
            os.path.join(ROOT, DSGPS_CKPT)]
    # the JAX CLI keeps its compile cache in the working directory
    monkeypatch.chdir(tmp_path)
    jax_main(argv + ["--path_results", str(tmp_path / "jax")])
    main(argv + ["--path_results", str(tmp_path / "torch"), "--device",
                 "cpu"])
    want, got = (load_jax_checkpoint(str(tmp_path / run / "ckpt"
                                         / "final_model.ckpt"))
                 for run in ("jax", "torch"))
    for hist in ("hist_train", "hist_val"):
        for k in ("loss", "residual_loss", "mse_loss"):
            assert len(got[hist][k]) == len(want[hist][k]) == n + 2
            np.testing.assert_allclose(got[hist][k][n:], want[hist][k][n:],
                                       rtol=UNROLLED_RTOL,
                                       err_msg=f"{hist} {k}")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, np.asarray(tree)

    mine = dict(leaves(got["params"]))
    theirs = dict(leaves(want["params"]))
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(mine[k], v, rtol=UNROLLED_RTOL,
                                   atol=UNROLLED_RTOL * np.abs(v).max(),
                                   err_msg=k)


def test_smoke_order_helpers(data_dir):
    """The smoke's ``order`` phase on the CPU side of its bookkeeping:
    ``node_orders``' permutation maps the mesh-ordered batch's rows onto
    the RCM batch's, ``sample_ids`` names a batch's samples from its own
    rows, and ``graph_nbytes`` counts each stored tensor once."""
    samples = load_dataset(data_dir)[:3]
    ordered, perm = chip_smoke.node_orders(samples)
    g, rg = (batch_graphs(s, device="cpu") for s in (samples, ordered))
    assert torch.equal(rg.x, g.x[torch.as_tensor(perm)])
    assert torch.equal(rg.pos, g.pos[torch.as_tensor(perm)])
    assert chip_smoke.bandwidth(rg) < chip_smoke.bandwidth(g)
    index = {s["sol"].tobytes(): i for i, s in enumerate(ordered)}
    two = batch_graphs([ordered[2], ordered[0]], device="cpu")
    assert chip_smoke.sample_ids(two, index) == (2, 0)
    tensors = chip_smoke.graph_tensors(g)
    assert {"x", "senders", "mp_to.row_ptr", "mp_from.oth"} <= set(tensors)
    assert chip_smoke.graph_nbytes(g) == sum(
        t.numel() * t.element_size() for k, t in tensors.items()
        if not k.startswith("mp_from."))
