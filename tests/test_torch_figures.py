"""The figure path of the port (``eval/figures.py``, the trainer's plots)
against the JAX package's ``tools/make_figures.py`` and trainer, on the
CPU, with the trained checkpoints in ``results/``:

* each package's data factory makes a tiny dataset (2 meshes × 5
  samples) at one seed and at the checkpoints' own mesh size (radius 1,
  hsize 0.08, about 500 nodes: on coarser meshes the trained DS-GPS
  recurrence diverges, to max|u| = 476 at hsize 0.25, where f32 rounding
  is amplified with it); the first validation sample of each is the same
  in both packages;
* DS-GPS traces (Dirichlet and mixed, k = 30) agree over every iterate
  within 1e-4 · max(1, max|u|); the Ψ-GNN trace (fw_thres 300 at the
  checkpoint's fw_tol 1e-5) over its first 4 iterates within 1e-5
  (‖·‖₂ relative).  Later Broyden iterates part with f32 rounding
  (``tests/test_torch_nstep_study.py``), and at fw_tol 1e-5 both solves
  stop in a tail whose MSE still moves: on this sample the packages' last
  iterates are 7 % apart in MSE (0.0342 against 0.0368, 74 and 81 steps;
  each package's own last 5 iterates span 2–6 %).  The final MSE is held
  where both solves converge, at fw_tol 1e-7, within 1e-3 (the nstep
  study's rule there; 2.2e-4 apart);
* on the CUDA route's wiring (the kernel replaced by its plain version)
  the Ψ-GNN trace launches the forward kernel 2 × its f_θ calls, a DS-GPS
  trace exactly 2k (Dirichlet) or 3k (mixed) times;
* ``figures.main`` writes every file ``tools/make_figures.py`` writes,
  under the same names;
* the trainer draws ``track_losses.png`` and ``gradients.png`` every
  ``plot_every`` epochs, logs once and goes on without matplotlib, and
  its ``_last_grad_norms`` has JAX's keys and values (1e-3 relative) for
  the same parameters and batch, for each family."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import (CKPT, DSGPS_CKPT, DSGPS_MIXED_CKPT, dss_sample,
                           fem_sample, jax_dsgps_params, jax_dss_params,
                           kernel_route, load_trained, mixed_sample)
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu.data.generate import generate_data as jax_generate_data
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import DsgpsConfig as JaxDsgpsConfig
from psignn_tpu.models import DssConfig as JaxDssConfig
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models import dsgps_forward as jax_dsgps_forward
from psignn_tpu.models import dss_forward as jax_dss_forward
from psignn_tpu.models import psignn_forward as jax_psignn_forward
from psignn_tpu.models.dsgps import dsgps_iterative_inference as jax_dsgps_it
from psignn_tpu.models.psignn import \
    psignn_iterative_inference as jax_psignn_it
from psignn_tpu.train.checkpoint import load_checkpoint as jax_load_ckpt
from psignn_tpu.train.optim import clip_by_global_norm
from psignn_tpu.train.trainer import _flatten_with_paths
from psignn_tpu_torch import weights
from psignn_tpu_torch.cli.main import main as cli_main
from psignn_tpu_torch.data.generate import generate_data
from psignn_tpu_torch.data.reader import GraphLoader
from psignn_tpu_torch.eval import figures
from psignn_tpu_torch.models import DsgpsConfig, DssConfig, PsignnConfig
from psignn_tpu_torch.train import TrainConfig, Trainer
from psignn_tpu_torch.train import plots as port_plots

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX's figure script, for its load_val_sample
_spec = importlib.util.spec_from_file_location(
    "make_figures", os.path.join(ROOT, "tools", "make_figures.py"))
make_figures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_figures)

VARIANTS = ("dirichlet", "mixed")
# the files tools/make_figures.py writes (psignn_figures, dsgps_figures,
# comparison_figures)
JAX_FILES = {"psignn_iter_montage.png", "psignn_paper.png",
             "dsgps_iter_montage.png", "dsgps_paper.png",
             "training_comparison.png", "training_comparison_mse.png"}
EARLY_STEPS = 4
EARLY_RTOL = 1e-5
CONVERGED_TOL = 1e-7
MSE_RTOL = 1e-3
DSGPS_UTOL = 1e-4
GRAD_RTOL = 1e-3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{package: root holding dirichlet/ and mixed/}: 2 meshes × 5
    samples of about 500 nodes, each package's factory at seed 3."""
    roots = {}
    for pkg, gen in (("jax", jax_generate_data), ("port", generate_data)):
        root = tmp_path_factory.mktemp(pkg)
        for variant in VARIANTS:
            gen(str(root / variant), n_mesh=2, n_samples=5, hsize=0.08,
                seed=3, variant=variant, verbose=False)
        roots[pkg] = str(root)
    return roots


@pytest.fixture(scope="module")
def samples(data):
    """{variant: (JAX's sample, the port's)}, each package's reader."""
    return {v: (make_figures.load_val_sample(
                    os.path.join(data["jax"], v), "dsgps", v),
                figures.load_val_sample(
                    os.path.join(data["port"], v), "dsgps", v))
            for v in VARIANTS}


def _jax_psignn_trace(s, **overrides):
    """``make_figures.psignn_figures``'s trace of sample ``s``."""
    ck = jax_load_ckpt(CKPT)
    params = jax.tree.map(jnp.asarray, ck["params"])
    cfg = JaxPsignnConfig(**{**ck["hyperparameters"], "fw_thres": 300,
                             **overrides})
    out = jax_psignn_it(params, jax_batch_graphs([s]), cfg)
    nstep, n = int(out["nstep"]), s["x"].shape[0]
    return (np.asarray(out["trace"]["u"])[:nstep, :n],
            np.asarray(out["trace"]["mse"])[:nstep], nstep)


def _jax_dsgps_trace(ckpt, s):
    """``make_figures.dsgps_figures``'s trace of sample ``s``."""
    ck = jax_load_ckpt(ckpt)
    params = jax.tree.map(jnp.asarray, ck["params"])
    tr = jax_dsgps_it(params, jax_batch_graphs([s]),
                      JaxDsgpsConfig(**ck["hyperparameters"]))
    n = s["x"].shape[0]
    return np.asarray(tr["u_trace"])[:, :n], np.asarray(tr["res"])


def test_factories_give_the_same_sample(samples):
    for variant, (js, ts) in samples.items():
        assert set(ts) >= set(js), variant
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def test_psignn_trace_matches_jax(samples):
    """JAX's trace at fw_tol 1e-7 holds the iterates of its 1e-5 trace
    (the tolerance only moves the stop)."""
    js, ts = samples["dirichlet"]
    ju, jmse, jn = _jax_psignn_trace(js, fw_tol=CONVERGED_TOL)
    got = figures.psignn_trace(CKPT, ts, "cpu")
    tu = got["u_trace"]
    assert tu.shape[1:] == ju.shape[1:] == (ts["x"].shape[0], 1)
    assert got["nstep"] == len(tu) == len(got["res_trace"]) > EARLY_STEPS
    assert got["epoch"] == jax_load_ckpt(CKPT)["epoch"]
    gap = (np.linalg.norm((tu - ju[:len(tu)])[:EARLY_STEPS, :, 0], axis=1)
           / np.linalg.norm(ju[:EARLY_STEPS, :, 0], axis=1))
    assert gap.max() <= EARLY_RTOL, gap
    mse = figures.psignn_trace(CKPT, ts, "cpu",
                               fw_tol=CONVERGED_TOL)["mse_trace"]
    assert abs(mse[-1] - jmse[-1]) <= MSE_RTOL * jmse[-1], (mse[-1],
                                                             jmse[-1])


@pytest.mark.parametrize("variant,ckpt", [("dirichlet", DSGPS_CKPT),
                                          ("mixed", DSGPS_MIXED_CKPT)])
def test_dsgps_trace_matches_jax(samples, variant, ckpt):
    js, ts = samples[variant]
    ju, jres = _jax_dsgps_trace(ckpt, js)
    got = figures.dsgps_trace(ckpt, ts, "cpu")
    assert got["variant"] == variant
    assert got["u_trace"].shape == ju.shape == (30, ts["x"].shape[0], 1)
    tol = DSGPS_UTOL * max(1.0, float(np.abs(ju).max()))
    np.testing.assert_allclose(got["u_trace"], ju, rtol=0, atol=tol)
    np.testing.assert_allclose(got["res"], jres, rtol=1e-3)


def test_traces_launch_the_forward_kernel(monkeypatch):
    """The smoke's launch rules, on the CUDA route's wiring."""
    fm = kernel_route(monkeypatch)
    out = chip_smoke.figure_traces(torch.device("cpu"),
                                   fem_sample(0, hsize=0.25),
                                   mixed_sample(0, hsize=0.25))
    for name, rec in out.items():
        assert rec["launches"] == rec["expected_launches"] > 0, name
    assert out["psignn"]["launches"] == 2 * out["psignn"]["f_calls"]
    assert out["dsgps_dirichlet"]["launches"] == 60
    assert out["dsgps_mixed"]["launches"] == 90
    assert fm.LAUNCHES == out["dsgps_mixed"]["launches"]   # the last trace


def test_main_writes_the_files_of_make_figures(data, tmp_path, capsys):
    out = tmp_path / "fig"
    figures.main(["--device", "cpu", "--out", str(out), "--path_data",
                  data["port"]])
    files = {p.name for p in out.iterdir()}
    assert files == JAX_FILES | {"dsgps_mixed_iter_montage.png",
                                 "dsgps_mixed_paper.png"}
    assert all((out / f).stat().st_size > 0 for f in files)
    printed = capsys.readouterr().out
    assert "validation split of " + os.path.join(data["port"], "mixed") \
        in printed
    assert "figures done" in printed


def test_figure_sample_falls_back_to_the_factory(tmp_path, capsys):
    s = figures.figure_sample(str(tmp_path), "psignn", "mixed")
    assert "fresh factory sample" in capsys.readouterr().out
    want = figures.factory_sample("mixed")
    for k in want:
        np.testing.assert_array_equal(s[k], want[k])
    assert s["tags"].shape[1] == 3 and "unit_normal_vector" in s


def test_cli_epoch_draws_the_plots(tmp_path):
    res, data = tmp_path / "run", str(tmp_path / "data")
    generate_data(data, n_mesh=2, n_samples=5, hsize=0.3, seed=3,
                  verbose=False)
    cli_main(["--path_dataset", data,
              "--path_results", str(res), "--max_epochs", "1",
              "--batch_size", "4", "--fw_tol", "1e-3", "--fw_thres", "25",
              "--bw_tol", "1e-5", "--bw_thres", "25", "--device", "cpu"])
    for name in ("track_losses.png", "gradients.png"):
        assert (res / "logs" / name).stat().st_size > 0


def _one_batch_trainer(tmp_path, family, model, cfg, samples, **over):
    loader = GraphLoader(samples, batch_size=len(samples), device="cpu")
    conf = TrainConfig(family=family, model_cfg=cfg, max_epochs=2,
                       path_results=str(tmp_path), device="cpu", **over)
    return Trainer(conf, loader, loader, model=model)


def test_trainer_plots_every_epoch_and_without_matplotlib(tmp_path,
                                                          monkeypatch):
    """``plot_every=1`` draws at each epoch; without matplotlib one log
    line says so and training goes on; any other fault of a plot
    surfaces."""
    s = [fem_sample(0, hsize=0.3)]
    cfg = PsignnConfig(fw_tol=1e-3, fw_thres=25, bw_tol=1e-5, bw_thres=25)
    drawn = []
    monkeypatch.setattr(Trainer, "_plot",
                        lambda self, epoch: drawn.append(epoch))
    _one_batch_trainer(tmp_path / "a", "psignn", None, cfg, s,
                       plot_every=1).train_model()
    assert drawn == [0, 1]
    monkeypatch.undo()

    def missing():
        raise ImportError("no matplotlib", name="matplotlib")

    monkeypatch.setattr(port_plots, "load_pyplot", missing)
    tr = _one_batch_trainer(tmp_path / "b", "psignn", None, cfg, s,
                            plot_every=1)
    tr.train_model()
    log = (tmp_path / "b" / "logs" / "train_metrics.csv").read_text()
    assert log.count("Plots not drawn") == 1
    assert "Training Epoch 1 finished" in log

    def broken():
        raise ImportError("something else", name="other")

    monkeypatch.setattr(port_plots, "load_pyplot", broken)
    with pytest.raises(ImportError, match="something else"):
        _one_batch_trainer(tmp_path / "c", "psignn", None, cfg, s,
                           plot_every=1).train_model()


def _jax_norms(loss_fn, params, clip):
    grads = jax.jit(jax.grad(loss_fn))(params)
    grads, _ = clip_by_global_norm(grads, clip)
    return {"/".join(str(p) for p in path):
            float(jnp.linalg.norm(g.reshape(-1)))
            for path, g in _flatten_with_paths(grads)}


def _psignn_case():
    params, hp = load_trained()
    # solves to tolerances both packages reach; the Hutchinson term,
    # a draw of each package's own, weighs 0
    tight = dict(fw_tol=1e-6, fw_thres=300, bw_tol=1e-8, bw_thres=300)
    jcfg = JaxPsignnConfig(**{**hp, **tight})
    cfg = PsignnConfig.from_hyperparameters(hp, **tight)

    def loss(p, g):
        l = jax_psignn_forward(p, g, jcfg, jax.random.PRNGKey(0),
                               training=True).losses
        return (l["residual_loss"] + l["encoder_loss"]
                + l["autoencoder_loss"])

    return (params, cfg, loss, [fem_sample(0, hsize=0.25)],
            dict(jac_weight=0.0))


def _unrolled_case(family):
    if family == "dss":
        tree = jax_dss_params(np.random.default_rng(11), 3)
        jcfg, cfg, fwd = JaxDssConfig(k=3), DssConfig(k=3), jax_dss_forward
        batch = [dss_sample(0, hsize=0.25)]
    else:
        tree = jax_dsgps_params(np.random.default_rng(11), False)
        jcfg, cfg = JaxDsgpsConfig(k=3), DsgpsConfig(k=3)
        fwd, batch = jax_dsgps_forward, [fem_sample(0, hsize=0.25)]
    return (tree, cfg,
            lambda p, g: fwd(p, g, jcfg).losses["train_loss"], batch,
            dict(gradient_clip=0.01))


@pytest.mark.parametrize("family", ["psignn", "dsgps", "dss"])
def test_last_grad_norms_match_jax(tmp_path, family):
    """One epoch of one batch from the same parameters: the port trainer's
    ``_last_grad_norms`` against the norms of JAX's clipped gradient,
    keyed as ``trainer.py:372-374`` keys them."""
    tree, cfg, loss, batch, over = (_psignn_case() if family == "psignn"
                                    else _unrolled_case(family))
    model = weights.model_from_jax(family, tree, cfg, "cpu").train()
    tr = _one_batch_trainer(tmp_path, family, model, cfg, batch, **over)
    tr.train_loop(0)
    got = tr._last_grad_norms
    jg = jax_batch_graphs(batch)
    want = _jax_norms(lambda p: loss(p, jg), jax.tree.map(jnp.asarray, tree),
                      tr.c.gradient_clip)
    assert list(got) == list(want)
    assert any(v > 0 for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   err_msg=k)
