"""Port training of the unrolled families, DSS and DS-GPS (Dirichlet and
mixed): ``unrolled_train_step`` against the JAX trainer's step (gradient,
joint clip, one Adam), its kernel launches on the CUDA route's wiring, one
CLI epoch per family with its logs, checkpoints and resume, port-written
checkpoints answering in the JAX package's ``run_eval.load_predictor``,
the per-family clip default, and ``run_eval`` of the trained DSS (sweep
and test-split table)."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import (DSS_CKPT, dss_sample, fem_sample,
                           jax_dsgps_params, jax_dss_params, kernel_route,
                           mixed_sample)
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu.data import reader as jreader
from psignn_tpu.eval.metrics import evaluate_dataset as jax_evaluate_dataset
from psignn_tpu.eval.run_eval import load_predictor as jax_load_predictor
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import DsgpsConfig as JaxDsgpsConfig
from psignn_tpu.models import DssConfig as JaxDssConfig
from psignn_tpu.models import dsgps_forward as jax_dsgps_forward
from psignn_tpu.models import dss_forward as jax_dss_forward
from psignn_tpu.train.optim import adam_update, clip_by_global_norm, init_adam
from psignn_tpu_torch import weights
from psignn_tpu_torch.cli.main import get_parser, gradient_clip, main
from psignn_tpu_torch.data.generate import add_dss_variable, generate_data
from psignn_tpu_torch.eval import run_eval
from psignn_tpu_torch.eval.run_eval import load_predictor
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import DsgpsConfig, DssConfig
from psignn_tpu_torch.train import load_checkpoint, make_adam
from psignn_tpu_torch.train import unrolled_train_step
from psignn_tpu_torch.train.step import unrolled_forward

K = 3
CLIP = 0.01
# (family, variant, JAX config, port config, seeded JAX-layout tree,
#  JAX forward, lr)
STEP_CASES = {
    "dss": ("dss", "dirichlet", JaxDssConfig(k=K, alpha=0.5),
            DssConfig(k=K, alpha=0.5),
            lambda rng: jax_dss_params(rng, K), jax_dss_forward, 0.01),
    "dsgps": ("dsgps", "dirichlet", JaxDsgpsConfig(k=K), DsgpsConfig(k=K),
              lambda rng: jax_dsgps_params(rng, False), jax_dsgps_forward,
              1e-3),
    "dsgps_mixed": ("dsgps", "mixed", JaxDsgpsConfig(k=K, bc_mode="mixed"),
                    DsgpsConfig(k=K, bc_mode="mixed"),
                    lambda rng: jax_dsgps_params(rng, True),
                    jax_dsgps_forward, 1e-3),
}


def _sample(case):
    family, variant = STEP_CASES[case][:2]
    if family == "dss":
        return dss_sample(0, hsize=0.25)
    return (mixed_sample if variant == "mixed" else fem_sample)(0, hsize=0.25)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_unrolled_train_step_matches_jax(case):
    """One step from the same parameters: the JAX trainer's non-Ψ-GNN step
    (``value_and_grad`` of ``train_loss``, ``clip_by_global_norm``,
    ``adam_update``, ``trainer.py:288-296``) against
    ``unrolled_train_step``.  Loss and pre-clip norm within 2e-4; every
    parameter after the step within 1e-5 relative and 1e-2·lr absolute:
    Adam's first step moves a weight by lr·g/(|g| + 1e-8), and where the
    clipped gradient g is near 1e-8 a rounding of g at the 1 % level moves
    the step by up to 1 % of lr."""
    family, _, jcfg, cfg, tree, jforward, lr = STEP_CASES[case]
    s = _sample(case)
    jg, tg = jax_batch_graphs([s]), batch_graphs([s], device="cpu")
    params = jax.tree.map(jnp.asarray, tree(np.random.default_rng(11)))

    @jax.jit
    def jax_step(p):
        loss, grads = jax.value_and_grad(
            lambda q: jforward(q, jg, jcfg).losses["train_loss"])(p)
        grads, total = clip_by_global_norm(grads, CLIP)
        new, _ = adam_update(grads, init_adam(p), p, lr)
        return loss, total, new

    jloss, jtotal, jnew = jax_step(params)
    model = weights.model_from_jax(family, jax.tree.map(np.asarray, params),
                                   cfg, "cpu")
    res = unrolled_train_step(model, make_adam(model, lr), tg, cfg, lr, CLIP)
    np.testing.assert_allclose(res.loss, float(jloss), rtol=2e-4)
    np.testing.assert_allclose(res.grad_norm, float(jtotal), rtol=2e-4)
    assert res.fw is None and res.bw is None
    assert "train_loss" in res.losses and "res_per_iter" not in res.losses
    got = weights.FAMILIES[family][3](model.state_dict())
    assert jax.tree.structure(got) == jax.tree.structure(jnew)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                   atol=1e-2 * lr)


@pytest.mark.parametrize("case", ["dss", "dsgps_mixed"])
def test_unrolled_step_kernel_route_matches_plain(case, monkeypatch):
    """A step on the CUDA route's autograd wiring (kernels replaced by their
    plain versions) launches the forward and the backward kernel once per
    message passing, 2k each (3k mixed), and gives the plain step."""
    family, variant, _, cfg, _, _, lr = STEP_CASES[case]
    tg = batch_graphs([_sample(case)], device="cpu")

    def run():
        model = weights.FAMILIES[family][0](
            cfg, generator=torch.Generator().manual_seed(6))
        res = unrolled_train_step(model, make_adam(model, lr), tg, cfg, lr,
                                  CLIP)
        return res, model.state_dict()

    plain, plain_sd = run()
    fm = kernel_route(monkeypatch)
    routed, routed_sd = run()
    want = chip_smoke.mp_per_step(cfg) * K
    assert want == (3 if variant == "mixed" else 2) * K
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == (want, want)
    for k, v in plain.losses.items():
        np.testing.assert_allclose(routed.losses[k], v, rtol=1e-5, err_msg=k)
    for k, v in plain_sd.items():
        np.testing.assert_allclose(routed_sd[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("family,want", [("psignn", 0.1), ("dsgps", 0.01),
                                         ("dss", 0.01)])
def test_gradient_clip_default_per_family(family, want):
    args = get_parser().parse_args(["--family", family])
    assert gradient_clip(args) == want
    args = get_parser().parse_args(["--family", family,
                                    "--gradient_clip", "0.5"])
    assert gradient_clip(args) == 0.5


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """A small Dirichlet dataset with DSS's encoding and a small mixed
    one (10 samples each: 6/2/2)."""
    out = {}
    for variant in ("dirichlet", "mixed"):
        path = str(tmp_path_factory.mktemp(variant))
        generate_data(path, n_mesh=2, n_samples=5, hsize=0.25, seed=21,
                      variant=variant, verbose=False)
        if variant == "dirichlet":
            add_dss_variable(path)
        out[variant] = path
    return out


def _lines(path):
    with open(path) as f:
        return f.read().strip().splitlines()


@pytest.mark.parametrize("family,variant", [("dss", "dirichlet"),
                                            ("dsgps", "dirichlet"),
                                            ("dsgps", "mixed")])
def test_cli_epoch_checkpoint_and_jax_load(tmp_path, datasets, family,
                                           variant, capsys):
    """One CLI epoch and a resume per family: its logs (no solver rows),
    its checkpoints (one Adam, no schedulers, the canonical clip), and its
    best checkpoint answering the same u in the port's and in the JAX
    package's ``load_predictor`` (2e-4)."""
    out = str(tmp_path / "run")
    argv = ["--family", family, "--variant", variant, "--path_dataset",
            datasets[variant], "--path_results", out, "--batch_size", "3",
            "--k", str(K), "--neumann_init_scale", "0.5", "--device", "cpu"]
    main(argv + ["--max_epochs", "1"])
    assert "Training finished" in capsys.readouterr().out
    logs = os.path.join(out, "logs")
    for name in ("forward_iteration.csv", "backward_iteration.csv",
                 "spectral_radius.csv"):
        assert len(_lines(os.path.join(logs, name))) == 1, name
    cfg_txt = "\n".join(_lines(os.path.join(logs, "model_config.csv")))
    assert "'gradient_clip':'0.01'" in cfg_txt and f"'k':'{K}'" in cfg_txt
    metrics = "\n".join(_lines(os.path.join(logs, "train_metrics.csv")))
    assert "Validation Epoch 0" in metrics and "Learning rate" not in metrics
    ck = load_checkpoint(os.path.join(out, "ckpt", "best_model.ckpt"))
    assert ck["family"] == family and ck["hyperparameters"]["k"] == K
    assert set(ck["torch_optim"]) == {"adam"}
    assert all(np.isfinite(v) for v in ck["hist_val"]["loss"])
    main(argv + ["--max_epochs", "2", "--resume",
                 os.path.join(out, "ckpt", "running_model.ckpt")])
    assert "Validation Epoch 1" in "\n".join(
        _lines(os.path.join(logs, "train_metrics.csv")))

    best = os.path.join(out, "ckpt", "best_model.ckpt")
    s = (dss_sample if family == "dss" else
         mixed_sample if variant == "mixed" else fem_sample)(3, hsize=0.25)
    jpredict, jfamily, _, _ = jax_load_predictor(best)
    predict, tfamily, _, _ = load_predictor(best, "cpu")
    assert jfamily == tfamily == family
    want = np.asarray(jpredict(jax_batch_graphs([s])))
    got = predict(batch_graphs([s], device="cpu")).numpy()
    np.testing.assert_allclose(got, want[:len(got)], rtol=2e-4,
                               atol=2e-4 * max(1.0, np.abs(want).max()))


def test_cli_spike_guard_unrolled(tmp_path, datasets):
    """The spike guard halves the single Adam's effective lr as for Ψ-GNN
    (a never-improving run: min_loss_save 0)."""
    out = str(tmp_path / "guarded")
    main(["--family", "dss", "--path_dataset", datasets["dirichlet"],
          "--path_results", out, "--max_epochs", "2", "--batch_size", "3",
          "--k", "2", "--min_loss_save", "0", "--spike_guard",
          "--spike_factor", "1e-6", "--spike_patience", "1",
          "--device", "cpu"])
    log = "\n".join(_lines(os.path.join(out, "logs", "train_metrics.csv")))
    scales = re.findall(r"lr scale now ([0-9.e-]+)", log)
    assert "SPIKE GUARD" in log and float(scales[-1]) == 0.25


def test_cli_refuses_dss_mixed(tmp_path, datasets, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--family", "dss", "--variant", "mixed", "--path_dataset",
              datasets["mixed"], "--path_results", str(tmp_path / "x"),
              "--device", "cpu"])
    assert e.value.code == 2
    assert "Dirichlet variant only" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


def test_unrolled_forward_picks_the_family():
    tg = batch_graphs([dss_sample(1, hsize=0.3)], device="cpu")
    model = weights.FAMILIES["dss"][0](DssConfig(k=2))
    out = unrolled_forward(model, tg, DssConfig(k=2))
    assert set(out.losses) == {"train_loss", "residual_loss", "residual_0",
                               "mse_loss", "mse_0", "res_per_iter",
                               "mse_per_iter"}


def test_run_eval_trained_dss(tmp_path, datasets, capsys):
    """``run_eval`` of the trained DSS: a sweep request, and the test-split
    table of a DSS dataset (A′ form, DSS split order) against the JAX
    package's table on the same split (2e-4)."""
    run_eval.main(["--ckpt", DSS_CKPT, "--sweep", "--radii", "1.0",
                   "--n_meshes", "1", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out)
    assert np.isfinite(summary["dss"]["1.0"]["res"])
    out = tmp_path / "eval"
    run_eval.main(["--ckpt", DSS_CKPT, "--path_dataset",
                   datasets["dirichlet"], "--out", str(out), "--device",
                   "cpu"])
    got = json.loads((out / "test_metrics.json").read_text())
    jpredict = jax_load_predictor(DSS_CKPT)[0]
    _, _, test = jreader.split_dataset(
        jreader.load_dataset(datasets["dirichlet"], family="dss"),
        family="dss")
    want = jax_evaluate_dataset(jpredict, jreader.GraphLoader(
        test, batch_size=50), verbose=False)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=1e-7,
                                   err_msg=k)
