"""The evaluation paths of this slice against the JAX package on the CPU:
the out-of-distribution geometry zoo (its 12 meshes array for array, and
``geometry_zoo_eval``), ``test_several_init``, ``run_eval --zoo`` and
``psignn_iterative_inference``.

Meshes are compared exactly.  Answers of the trained Ψ-GNN are compared
at fw_tol 1e-4, which both packages reach before f32 order matters: the
same steps, metrics within 1e-3 relative (u within 1e-4 of max|u|)."""

import json

import jax
import numpy as np
import pytest

from _torch_parity import CKPT, fem_sample, load_trained
from psignn_tpu.eval import geometries as jgeo
from psignn_tpu.eval.sweep import geometry_zoo_eval as jax_zoo_eval
from psignn_tpu.eval.sweep import test_several_init as jax_several_init
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models import psignn_inference as jax_psignn_inference
from psignn_tpu.models import \
    psignn_iterative_inference as jax_iterative_inference
from psignn_tpu_torch.eval import geometries, run_eval
from psignn_tpu_torch.eval.run_eval import load_predictor
from psignn_tpu_torch.eval.sweep import geometry_zoo_eval
from psignn_tpu_torch.eval.sweep import test_several_init as several_init
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import PsignnConfig, psignn_iterative_inference
from psignn_tpu_torch.weights import psignn_from_jax

REACH = dict(fw_tol=1e-4, fw_thres=200)
METRICS = ("mse", "res", "rel")
MESH_FIELDS = ("points", "triangles", "boundary_mask", "boundary_tag")


def _assert_same_mesh(got, want):
    for k in MESH_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", sorted(jgeo.GEOMETRY_BUILDERS))
def test_zoo_mesh_matches_jax(name):
    """Each shape at a coarse hsize: points, triangles, boundary mask and
    tags equal to JAX's (matplotlib's point-in-path replaced by
    ``points_in_polygon``), every node used, the boundary tagged 101."""
    got = geometries.build_geometry(name, hsize=0.15)
    _assert_same_mesh(got, jgeo.build_geometry(name, hsize=0.15))
    used = np.zeros(got.n_points, bool)
    used[got.triangles.ravel()] = True
    assert used.all() and got.boundary_mask.sum() >= 8
    assert set(np.unique(got.boundary_tag)) == {0, 101}


def test_polygon_mesh_with_holes_matches_jax():
    """``polygon_mesh`` directly, holes and a jitter seed, at the zoo's
    default hsize."""
    outer = np.array([[-1.0, -1.0], [1.2, -1.0], [1.0, 1.0], [-1.0, 0.8]])
    holes = [geometries._circle((-0.4, -0.3), 0.25),
             geometries._circle((0.4, 0.35), 0.2)]
    _assert_same_mesh(geometries.polygon_mesh(outer, holes, seed=3),
                      jgeo.polygon_mesh(outer, holes, seed=3))
    assert set(geometries.GEOMETRY_BUILDERS) == set(jgeo.GEOMETRY_BUILDERS)


@pytest.fixture(scope="module")
def trained():
    params, hp = load_trained()
    jcfg = JaxPsignnConfig(**{**hp, **REACH})
    jpredict = jax.jit(lambda g: jax_psignn_inference(params, g, jcfg))
    predict = load_predictor(CKPT, "cpu", REACH)[0]
    return params, hp, jpredict, predict


def test_geometry_zoo_eval_matches_jax(trained):
    """Two shapes through ``geometry_zoo_eval`` with an oracle predictor
    (u = the FEM solution) and the trained Ψ-GNN: the same FEM solves (the
    oracle's metrics agree to 1e-6 of the residual scale) and the same
    answers at fw_tol 1e-4."""
    _, _, jpredict, predict = trained
    shapes = ["heart", "donut"]
    want = jax_zoo_eval({"oracle": lambda g: g.sol, "psignn": jpredict},
                        hsize=0.2, shapes=shapes, families=("psignn",))
    got = geometry_zoo_eval({"oracle": lambda g: g.sol, "psignn": predict},
                            hsize=0.2, shapes=shapes, device="cpu",
                            warmup=False)
    assert list(got) == shapes
    for shape in shapes:
        g, w = got[shape], want[shape]
        assert g["oracle"]["mse"] < 1e-10 and g["oracle"]["res"] < 1e-6
        assert g["psignn"]["nstep"] == w["psignn"]["nstep"] > 0
        assert g["psignn"]["n_nodes"] == w["psignn"]["n_nodes"]
        for k in METRICS:
            np.testing.assert_allclose(g["psignn"][k], w["psignn"][k],
                                       rtol=1e-3, err_msg=(shape, k))


def test_several_init_matches_jax(trained):
    """The four starting points: the same uniform [−10, 10] draw as JAX's
    (a predictor answering x itself shows it exactly), and the trained
    Ψ-GNN's answers from each."""
    _, _, jpredict, predict = trained
    s = fem_sample(5, hsize=0.25)
    mine = several_init(lambda g: g.x, s, device="cpu")
    theirs = jax_several_init(lambda g: g.x, s)
    assert list(mine) == ["zero", "default", "random", "solution"]
    for k in mine:
        np.testing.assert_allclose(mine[k]["mse"], theirs[k]["mse"],
                                   rtol=1e-5, err_msg=k)
    assert mine["solution"]["mse"] == 0.0 and mine["random"]["mse"] > 10
    got = several_init(predict, s, device="cpu")
    want = jax_several_init(jpredict, s)
    for init in got:
        for k in ("mse", "res"):
            np.testing.assert_allclose(got[init][k], want[init][k],
                                       rtol=1e-3, err_msg=(init, k))


def test_run_eval_zoo_writes_geometry_zoo_json(tmp_path, capsys,
                                               monkeypatch):
    """``run_eval --zoo`` (cut here to two shapes, meshed coarser) prints
    the table and writes ``geometry_zoo.json``; a mixed checkpoint is
    refused."""
    monkeypatch.setattr(geometries, "GEOMETRY_BUILDERS", {
        k: (lambda hsize, b=geometries.GEOMETRY_BUILDERS[k]: b(hsize=0.25))
        for k in ("heart", "donut")})
    run_eval.main(["--ckpt", CKPT, "--zoo", "--out", str(tmp_path),
                   "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    saved = json.loads((tmp_path / "geometry_zoo.json").read_text())
    assert list(saved) == ["donut", "heart"] == list(printed)
    for shape in saved.values():
        m = shape["psignn"]
        assert m["nstep"] > 0 and np.isfinite(m["res"]) and m["n_nodes"] > 0
    with pytest.raises(SystemExit):
        run_eval.main(["--ckpt", "results/psignn_mixed/ckpt/best_model.ckpt",
                       "--zoo", "--device", "cpu"])


@pytest.mark.parametrize("solver", ["forward_iteration", "broyden"])
def test_iterative_inference_matches_jax(solver):
    """The decoded iterate trace of the trained Ψ-GNN on a small mesh:
    iterate 0 is the raw x; every trace entry (unvisited ones too, as JAX
    returns them) decoded, with its residual, MSE, Dirichlet and interior
    MSE, against JAX's."""
    params, hp = load_trained()
    over = dict(solver=solver, fw_tol=1e-4, fw_thres=40)
    s = fem_sample(0, hsize=0.25)
    jg = jax_batch_graphs([s])
    want = jax.jit(lambda g: jax_iterative_inference(
        params, g, JaxPsignnConfig(**{**hp, **over})))(jg)
    cfg = PsignnConfig.from_hyperparameters(hp, **over)
    got = psignn_iterative_inference(psignn_from_jax(params, cfg, "cpu"),
                                     batch_graphs([s], device="cpu"), cfg)
    n = len(s["x"])
    assert got["nstep"] == int(want["nstep"]) > 0
    assert got["trace_len"] == int(want["trace_len"])
    assert got["trace"]["res"].shape == want["trace"]["res"].shape
    assert got["trace"]["res"].shape[0] == (42 if solver != "broyden"
                                            else 41)
    for part in ("initial", "trace"):
        for k in ("res", "mse", "bound_mse", "inter_mse"):
            np.testing.assert_allclose(np.asarray(got[part][k]),
                                       np.asarray(want[part][k]), rtol=1e-3,
                                       atol=1e-9, err_msg=(part, k))
    u, ju = got["trace"]["u"].numpy(), np.asarray(want["trace"]["u"])[:, :n]
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-4 * np.abs(ju).max())
    np.testing.assert_array_equal(got["initial"]["u"].numpy(), s["x"])
