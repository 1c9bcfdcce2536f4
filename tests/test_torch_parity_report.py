"""The port's parity harness (``eval/parity.py``) against the JAX
package's ``psignn_tpu.eval.parity``:

* ``build_predictors`` runs the configs JAX builds afresh (Broyden at the
  given fw_tol / fw_thres with bw_thres = fw_thres, DS-GPS k = 100, DSS
  k = 30), not the checkpoints', from the trained checkpoints and from
  synthetic reference ``.pt`` files (made as ``tests/test_torch_compat.py``
  makes them): configs equal field for field; the reference models hold
  exactly the weights JAX's ``compat`` converts (tolerance 0);
* a one-mesh radius-0.6 sweep through both packages with the trained
  checkpoints at fw_tol 1e-5 / fw_thres 1500: the same mesh, Ψ-GNN nstep
  within ±2, MSE within 1e-3 relative for DS-GPS and DSS (no solver: the
  same k steps in f32) and within 2e-2 for Ψ-GNN, whose two solves stop at
  different iterates below the tolerance (the nstep study's test shows
  1e-3 once both are solved to 1e-7);
* ``write_report`` of one summary gives JAX's tables line for line; only
  the title and the sentence naming the package and device differ;
* the checkpoints, gmsh meshes and published numbers are JAX's;
* without checkpoints the result is empty and ``main`` prints JAX's skip
  line; with them ``main`` writes the report, the sweep's CSVs and the
  radius figure, ``radius_comparison.png``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu.eval import nstep_study as jax_nstep
from psignn_tpu.eval import parity as jax_parity
from psignn_tpu.eval import registry as jax_registry
from psignn_tpu.eval.sweep import growing_geometry_sweep as jax_sweep
from psignn_tpu_torch.data.fem import solve_poisson
from psignn_tpu_torch.data.meshgen import blob_mesh
from psignn_tpu_torch.eval import nstep_study, parity, registry
from psignn_tpu_torch.eval.vis import load_sweep_csv
from psignn_tpu_torch.eval.sweep import SAMPLE_FORMS, growing_geometry_sweep
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import (dsgps_inference, dss_inference,
                                     psignn_inference)
from psignn_tpu_torch.weights import model_from_jax
from test_torch_compat import reference_state_dict

FAMILY_NAMES = ("psignn", "dsgps", "dss")
INFER = {"psignn": psignn_inference, "dsgps": dsgps_inference,
         "dss": dss_inference}
NSTEP_SLACK = 2
MSE_RTOL = 1e-3
STOP_MSE_RTOL = 2e-2


def _jax_cfg(predict):
    """The config a JAX predictor closes over (``parity.py:92``, ``:98``,
    ``:103``: ``lambda g, p=p, cfg=cfg``)."""
    return predict.__wrapped__.__defaults__[1]


def _same_cfg(got, want):
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture
def reference_pts(tmp_path, monkeypatch):
    """Synthetic reference checkpoints of the three families, named by
    both packages' ``CKPTS``."""
    paths = {}
    for family in FAMILY_NAMES:
        path = str(tmp_path / f"{family}.pt")
        torch.save({"state_dict": reference_state_dict(family, seed=5),
                    "hyperparameters": {"latent_dim": 10, "n_layers": 1,
                                        "k": 30, "fw_tol": 1e-6}}, path)
        paths[family] = path
    monkeypatch.setattr(jax_parity, "CKPTS", paths)
    monkeypatch.setattr(parity, "CKPTS", paths)
    return paths


@pytest.fixture
def no_checkpoints(tmp_path, monkeypatch):
    for mod in (parity, jax_parity):
        monkeypatch.setattr(mod, "CKPTS", {
            k: str(tmp_path / "none" / f"{k}.pt") for k in mod.CKPTS})
        monkeypatch.setattr(mod, "TRAINED_CKPTS", {
            k: str(tmp_path / "none" / f"{k}.ckpt") for k in mod.CKPTS})


def test_trained_predictors_run_jax_configs():
    want = jax_parity.build_predictors(1500, 1e-5, source="trained")
    got = parity.build_predictors(1500, 1e-5, source="trained",
                                  device="cpu")
    assert set(got) == set(want) == set(FAMILY_NAMES)
    for family in FAMILY_NAMES:
        _same_cfg(got[family].cfg, _jax_cfg(want[family]))
        _same_cfg(got[family].cfg, parity.predictor_configs(1500,
                                                            1e-5)[family])
    assert got["psignn"].cfg.bw_thres == 1500
    assert (got["dsgps"].cfg.k, got["dss"].cfg.k) == (100, 30)


def test_reference_predictors_from_synthetic_pt(reference_pts):
    from psignn_tpu.compat import convert_reference_checkpoint as jax_convert
    want = jax_parity.build_predictors(30, 1e-5, source="reference")
    got = parity.build_predictors(30, 1e-5, source="reference",
                                  device="cpu")
    assert set(got) == set(want) == set(FAMILY_NAMES)
    rng = np.random.default_rng(0)
    fem = solve_poisson(blob_mesh(radius=0.6, hsize=0.2, rng=rng), 0.6, rng)
    for family in FAMILY_NAMES:
        cfg = got[family].cfg
        _same_cfg(cfg, _jax_cfg(want[family]))
        # the weights JAX's compat converts, in a model of the fresh config
        model = model_from_jax(
            family, jax_convert(reference_pts[family], family)["params"],
            cfg, "cpu")
        graph = batch_graphs(
            [SAMPLE_FORMS["dss" if family == "dss" else "psignn"](fem)],
            device="cpu")
        u, ref = (out[0] if isinstance(out, tuple) else out
                  for out in (got[family](graph),
                              INFER[family](model, graph, cfg)))
        assert torch.equal(u, ref), family


def _sweep_rows(summary):
    return {name: per_radius[0.6] for name, per_radius in summary.items()}


@pytest.fixture(scope="module")
def both_sweeps():
    """One radius-0.6 mesh through each package with the trained
    checkpoints at the published protocol's solver settings."""
    want = jax_sweep(jax_parity.build_predictors(1500, 1e-5,
                                                 source="trained"),
                     radii=[0.6], n_meshes=1, families=("psignn", "dss"))
    got = growing_geometry_sweep(
        parity.build_predictors(1500, 1e-5, source="trained",
                                device="cpu"),
        radii=[0.6], n_meshes=1, families=("psignn", "dss"), device="cpu")
    return got, want


@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_one_mesh_sweep_matches_jax(both_sweeps, family):
    got, want = (_sweep_rows(s)[family] for s in both_sweeps)
    assert got["n_nodes"] == want["n_nodes"]
    rtol = STOP_MSE_RTOL if family == "psignn" else MSE_RTOL
    assert abs(got["mse"] - want["mse"]) <= rtol * want["mse"], (got, want)
    if family == "psignn":
        assert abs(got["nstep"] - want["nstep"]) <= NSTEP_SLACK, (got, want)
        assert got["lowest"] < 1e-5
    else:
        assert got["nstep"] == want["nstep"] == -1


def test_write_report_gives_jax_tables(both_sweeps, tmp_path):
    summary, _ = both_sweeps
    mine = parity.write_report(summary, str(tmp_path / "port.md"),
                               protocol="Protocol: test.", device="cpu")
    theirs = jax_parity.write_report(summary, str(tmp_path / "jax.md"),
                                     protocol="Protocol: test.")
    mine, theirs = (open(p).read().splitlines() for p in (mine, theirs))
    assert len(mine) == len(theirs)
    diff = [i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b]
    assert diff == [0, 2]               # the title and the sentence
    assert "psignn_tpu_torch" in mine[0] and "on CPU" in mine[2]
    assert "TPU" not in "\n".join(mine)
    for family in FAMILY_NAMES:
        assert f"## {family}" in mine


def test_no_checkpoints_means_no_predictors(no_checkpoints, capsys,
                                            tmp_path):
    for source in ("reference", "trained"):
        assert parity.build_predictors(source=source, device="cpu") == {}
        assert jax_parity.build_predictors(source=source) == {}
    out = tmp_path / "PARITY.md"
    parity.main(["--device", "cpu", "--out", str(out)])
    assert capsys.readouterr().out.strip() == (
        "no reference checkpoints found; skipping")
    assert not out.exists()


def test_main_writes_report_and_csvs(reference_pts, tmp_path, capsys):
    out, csv_dir = tmp_path / "PARITY.md", tmp_path / "csv"
    parity.main(["--radii", "0.6", "--n_meshes", "1", "--fw_thres", "20",
                 "--out", str(out), "--csv_dir", str(csv_dir),
                 "--pallas", "1", "--device", "cpu"])
    text = out.read_text()
    assert text.startswith("# PARITY — checkpoints in psignn_tpu_torch")
    assert "fw_thres 20" in text
    for family in FAMILY_NAMES:
        assert f"## {family}" in text
        rows = load_sweep_csv(str(csv_dir / f"{family}_results.csv"))
        assert set(rows) == {0.6}
    assert (csv_dir / "radius_comparison.png").stat().st_size > 0
    assert capsys.readouterr().out.strip() == f"wrote {out}"


def test_tables_and_paths_match_jax():
    """The same checkpoints, meshes and published numbers as JAX's, the
    reference's files below the port's ``REF`` as below JAX's."""
    assert parity.TRAINED_CKPTS == jax_parity.TRAINED_CKPTS
    assert parity.BASELINE_MSE == jax_parity.BASELINE_MSE
    assert parity.BASELINE_NSTEP == jax_parity.BASELINE_NSTEP

    def below(root, paths):
        return {k: os.path.relpath(v, root) for k, v in paths.items()}

    assert below(registry.REF, parity.CKPTS) == \
        below(jax_registry.REF, jax_parity.CKPTS)
    assert below(registry.REF, nstep_study.REF_MESHES) == \
        below(jax_registry.REF, jax_nstep.REF_MESHES)