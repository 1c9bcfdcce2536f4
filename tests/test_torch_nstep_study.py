"""The port's nstep study (``eval/nstep_study.py``) and the two mesh sources
it adds to ``data/meshgen.py``, against the JAX package's:

* ``circle_mesh``: points and triangles bit-equal (tolerance 0: the same
  numpy draws and the same Delaunay input);
* ``mesh_from_dolfin_h5``: equal on a DOLFIN-HDF5 file written here, and
  an ``ImportError`` that names h5py where it is missing;
* ``eval_mesh`` with the trained ``psignn_dirichlet`` checkpoint, fed by
  each package's ``build_predictors(source="trained")`` on a radius-0.6
  circle mesh with 2 right-hand sides.  At the protocol's fw_tol 1e-5:
  nstep within ±2 (Broyden's stop test on the f32 residuals of two
  implementations) and MSE within 2e-2 relative: both solves stop at the
  first iterate whose relative residual is below 1e-5, and iterates that
  far apart differ in MSE by up to 0.9 % (measured on these samples).
  Solved to fw_tol 1e-7 (fw_thres 1500), where the answer is the model's
  fixed point and not where a solve stopped: MSE within 1e-3 relative;
  the step counts are not compared there, as near the f32 floor they
  wander (69 against 78 on seed 0);
* radius 1, JAX ``main``'s circle mesh (seed 3) and its 8 right-hand
  sides (seed 20): the step counts of the two packages differ there by up
  to a factor 3.7 on one sample (282 against 76), so they are held by
  what does not depend on where a solve stops: the decoded iterates of
  the first ``EARLY_STEPS`` Broyden steps agree within
  ``EARLY_ITERATE_RTOL`` in ‖·‖₂ relative (measured: at most 3.1e-6;
  the gap then grows, to 4.9e-4 by step 10), and the converged answers
  (fw_tol 1e-7) within ``MSE_RTOL`` (measured: at most 6e-4).
* ``main`` without the reference's checkpoint prints JAX's skip line.

Run as a script from the repository's root, ``JAX_PLATFORMS=cpu
PYTHONPATH=. python tests/test_torch_nstep_study.py`` prints the radius-1
witness (about a minute): per sample, each package's step count at fw_tol 1e-5
and 1e-7, JAX's count from a second program of the same solve (its
iterative inference, which keeps the trace), and how far the two
packages' iterates are apart at steps 1–80, in float32 and float64."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from psignn_tpu.data import meshgen as jax_meshgen
from psignn_tpu.eval import nstep_study as jax_nstep
from psignn_tpu.eval import parity as jax_parity
from psignn_tpu_torch.data import meshgen
from psignn_tpu_torch.eval import nstep_study, parity

NSTEP_SLACK = 2
MSE_RTOL = 1e-3
STOP_MSE_RTOL = 2e-2
EARLY_STEPS = 4
EARLY_ITERATE_RTOL = 1e-5
# JAX main's circle mesh and its right-hand sides
CIRCLE = dict(radius=1.0, hsize=0.08, seed=3)
CIRCLE_RHS_SEED = 20


def _assert_same_mesh(got, want):
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_array_equal(got.boundary_mask, want.boundary_mask)
    np.testing.assert_array_equal(got.boundary_tag, want.boundary_tag)
    if want.boundary_loop is None:
        assert got.boundary_loop is None
    else:
        np.testing.assert_array_equal(got.boundary_loop, want.boundary_loop)
    assert got.points.dtype == want.points.dtype
    assert got.triangles.dtype == want.triangles.dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("radius", [0.6, 1.0])
def test_circle_mesh_matches_jax(radius, seed):
    _assert_same_mesh(meshgen.circle_mesh(radius=radius, hsize=0.08,
                                          seed=seed),
                      jax_meshgen.circle_mesh(radius=radius, hsize=0.08,
                                              seed=seed))


def _write_dolfin_h5(path, mesh, tag=101):
    """A DOLFIN-HDF5 file of ``mesh``: 3-D coordinates, triangles, and the
    boundary edges as facets, tagged ``tag`` except every fifth (303)."""
    h5py = pytest.importorskip("h5py")
    loop = mesh.boundary_loop
    facets = np.stack([loop, np.roll(loop, -1)], axis=1)
    values = np.where(np.arange(len(facets)) % 5 == 0, 303, tag)
    with h5py.File(path, "w") as f:
        f["mesh/coordinates"] = np.concatenate(
            [mesh.points, np.zeros((mesh.n_points, 1))], axis=1)
        f["mesh/topology"] = mesh.triangles.astype(np.int64)
        f["facet/topology"] = facets.astype(np.int64)
        f["facet/values"] = values.astype(np.int64)


def test_mesh_from_dolfin_h5_matches_jax(tmp_path):
    path = str(tmp_path / "mesh.h5")
    _write_dolfin_h5(path, meshgen.blob_mesh(radius=1.0, hsize=0.2, seed=4))
    got = meshgen.mesh_from_dolfin_h5(path)
    _assert_same_mesh(got, jax_meshgen.mesh_from_dolfin_h5(path))
    assert got.boundary_mask.any() and not got.boundary_mask.all()


def test_mesh_from_dolfin_h5_without_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        meshgen.mesh_from_dolfin_h5("mesh.h5")


@pytest.mark.parametrize("fw_thres,fw_tol,nstep_slack,mse_rtol", [
    (600, 1e-5, NSTEP_SLACK, STOP_MSE_RTOL),
    (1500, 1e-7, None, MSE_RTOL)], ids=["protocol", "converged"])
def test_eval_mesh_matches_jax(fw_thres, fw_tol, nstep_slack, mse_rtol):
    mesh = meshgen.circle_mesh(radius=0.6, hsize=0.08, seed=0)
    jmesh = jax_meshgen.circle_mesh(radius=0.6, hsize=0.08, seed=0)
    want = jax_nstep.eval_mesh(
        jax_parity.build_predictors(fw_thres, fw_tol,
                                    source="trained")["psignn"],
        jmesh, 0.6, n_samples=2, seed=0)
    got = nstep_study.eval_mesh(
        parity.build_predictors(fw_thres, fw_tol, source="trained",
                                device="cpu")["psignn"],
        mesh, 0.6, n_samples=2, seed=0, device="cpu")
    assert set(got) == set(want)
    assert got["n_nodes"] == want["n_nodes"]
    assert got["lowest"] < fw_tol and want["lowest"] < fw_tol
    if nstep_slack is not None:
        assert abs(got["nstep"] - want["nstep"]) <= nstep_slack, (got, want)
    assert abs(got["mse"] - want["mse"]) <= mse_rtol * want["mse"], (got,
                                                                     want)
    np.testing.assert_allclose(got["a_std"], want["a_std"], rtol=1e-6)


def _circle_samples(n: int, dtype=np.float32):
    """JAX main's circle mesh, its first ``n`` right-hand sides, and each
    as a graph of the JAX package (padded) and of the port (CPU)."""
    from psignn_tpu.graphs import batch_graphs as jax_batch
    from psignn_tpu_torch.data.fem import solve_poisson
    from psignn_tpu_torch.data.reader import psignn_sample_from_fem
    from psignn_tpu_torch.graphs import batch_graphs
    mesh = meshgen.circle_mesh(**CIRCLE)
    rng = np.random.default_rng(CIRCLE_RHS_SEED)
    samples = [psignn_sample_from_fem(solve_poisson(mesh, 1.0, rng))
               for _ in range(n)]
    return [(jax_batch([s], dtype=dtype),
             batch_graphs([s], device="cpu", dtype=dtype)) for s in samples]


def _trained_psignn(fw_thres: int, fw_tol: float, dtype=np.float32):
    """The trained Ψ-GNN as each package's parity harness configures it:
    (JAX params, JAX config, port model, port config)."""
    import jax
    import jax.numpy as jnp
    from psignn_tpu.models import PsignnConfig
    from psignn_tpu.train.checkpoint import load_checkpoint
    from psignn_tpu_torch.eval.run_eval import load_predictor
    path = parity.TRAINED_CKPTS["psignn"]
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                          load_checkpoint(path)["params"])
    jcfg = PsignnConfig(solver="broyden", fw_tol=fw_tol, fw_thres=fw_thres,
                        bw_thres=fw_thres)
    cfg = parity.predictor_configs(fw_thres, fw_tol)["psignn"]
    _, _, cfg, model = load_predictor(path, "cpu",
                                      overrides=dataclasses.asdict(cfg))
    torch_dtype = {np.float32: torch.float32, np.float64: torch.float64}
    return params, jcfg, model.to(torch_dtype[dtype]), cfg


def _iterate_gaps(params, jcfg, model, cfg, jg, tg) -> np.ndarray:
    """‖u_JAX − u_port‖ / ‖u_JAX‖ of each decoded Broyden iterate of one
    solve, over the steps both packages took."""
    from psignn_tpu.models import psignn_iterative_inference as jax_iter
    from psignn_tpu_torch.models import psignn_iterative_inference
    jo = jax_iter(params, jg, jcfg)
    to = psignn_iterative_inference(model, tg, cfg)
    tu = to["trace"]["u"].numpy()[..., 0]
    ju = np.asarray(jo["trace"]["u"])[:, :tu.shape[1], 0]
    n = min(int(jo["trace_len"]), int(to["trace_len"]))
    return (np.linalg.norm(ju[:n] - tu[:n], axis=1)
            / np.linalg.norm(ju[:n], axis=1))


def test_radius1_early_iterates_match_jax():
    """The same Broyden on the circle's 8 right-hand sides: the two
    packages' iterates agree over the first steps, before the rounding
    that sets their step counts has grown."""
    params, jcfg, model, cfg = _trained_psignn(EARLY_STEPS, 1e-12)
    for i, (jg, tg) in enumerate(_circle_samples(8)):
        gap = _iterate_gaps(params, jcfg, model, cfg, jg, tg)
        assert len(gap) == EARLY_STEPS + 1
        assert gap.max() <= EARLY_ITERATE_RTOL, (i, gap)


def test_radius1_converged_mse_matches_jax():
    """JAX main's circle mesh, 8 right-hand sides solved to fw_tol 1e-7:
    each answer's MSE within ``MSE_RTOL`` of JAX's."""
    from psignn_tpu.eval.metrics import errors_batch as jax_errors
    from psignn_tpu_torch.eval.metrics import errors_batch
    jpred = jax_parity.build_predictors(1500, 1e-7,
                                        source="trained")["psignn"]
    pred = parity.build_predictors(1500, 1e-7, source="trained",
                                   device="cpu")["psignn"]
    for i, (jg, tg) in enumerate(_circle_samples(8)):
        ju, _, jlow = jpred(jg)
        u, _, low = pred(tg)[:3]
        assert low < 1e-7 and float(jlow) < 1e-7, (i, low, float(jlow))
        want = float(np.asarray(jax_errors(ju, jg)["mse"])[0])
        got = float(errors_batch(u, tg)["mse"][0])
        assert abs(got - want) <= MSE_RTOL * want, (i, got, want)


def witness():
    """Print the radius-1 witness of the module docstring."""
    import jax
    from psignn_tpu.models import psignn_inference as jax_inference
    from psignn_tpu.models import psignn_iterative_inference as jax_iter
    from psignn_tpu_torch.models import psignn_inference
    marks = (1, 2, 5, 10, 20, 30, 40, 60, 80)
    for fw_thres, fw_tol in ((600, 1e-5), (1500, 1e-7)):
        params, jcfg, model, cfg = _trained_psignn(fw_thres, fw_tol)
        solve = jax.jit(lambda g: jax_inference(params, g, jcfg))
        print(f"float32, fw_tol {fw_tol}, fw_thres {fw_thres}")
        for i, (jg, tg) in enumerate(_circle_samples(8)):
            jn = int(solve(jg)[1])
            jn_iter = int(jax_iter(params, jg, jcfg)["nstep"])
            tn = int(psignn_inference(model, tg, cfg)[1])
            print(f"  sample {i}: nstep JAX {jn} (iterative program "
                  f"{jn_iter}), port {tn}")
    jax.config.update("jax_enable_x64", True)
    for dtype in (np.float32, np.float64):
        params, jcfg, model, cfg = _trained_psignn(600, 1e-5, dtype)
        print(f"{np.dtype(dtype).name}, fw_tol 1e-05: ‖du‖ / ‖u‖ "
              "between the packages' iterates at step k")
        for i, (jg, tg) in enumerate(_circle_samples(8, dtype)):
            gap = _iterate_gaps(params, jcfg, model, cfg, jg, tg)
            print(f"  sample {i}: " + ", ".join(
                f"{k}: {gap[k]:.1e}" for k in marks if k < len(gap)))


def test_main_skips_without_reference_checkpoint(monkeypatch, tmp_path,
                                                 capsys):
    monkeypatch.setattr(parity, "CKPTS",
                        {k: str(tmp_path / f"{k}.pt") for k in parity.CKPTS})
    out = tmp_path / "nstep_gap.md"
    nstep_study.main(["--device", "cpu", "--out", str(out)])
    assert capsys.readouterr().out.strip() == (
        "reference psignn checkpoint not found; skipping")
    assert not out.exists()


if __name__ == "__main__":
    witness()
