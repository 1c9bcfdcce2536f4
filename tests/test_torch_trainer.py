"""Port trainer and training CLI on the CPU: two epochs and a resume with
their logs and checkpoints, a checkpoint the port trained answering a
sweep request, the CLI's help, a tiny run, a mixed run and runs with the
other solvers (Newton's included), the spike guard, and the JAX CLI's
node-order, batch-cache and comment flags (``tests/test_trainer.py``
mirrored).  Data-parallel runs
(``--num_devices``) are in ``tests/test_torch_dist.py``.  The per-graph solves, Broyden's
rank memory, bfloat16 data and resuming from a JAX checkpoint are in
``tests/test_torch_stacked.py``, ``test_torch_lowrank.py`` and
``test_torch_resume.py``.  DSS and DS-GPS runs are in
``tests/test_torch_unrolled_train.py``."""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models import psignn_init
from psignn_tpu.train.trainer import count_params
from psignn_tpu_torch.cli.main import main
from psignn_tpu_torch.data.generate import generate_data
from psignn_tpu_torch.data.reader import (GraphLoader, load_dataset,
                                          split_dataset)
from psignn_tpu_torch.eval import run_eval
from psignn_tpu_torch.eval.run_eval import load_predictor
from psignn_tpu_torch.eval.sweep import growing_geometry_sweep
from psignn_tpu_torch.models import PsignnConfig
from psignn_tpu_torch.train import TrainConfig, Trainer, load_checkpoint

FAST = dict(fw_tol=1e-3, fw_thres=25, bw_tol=1e-5, bw_thres=25)
FAST_FLAGS = ["--fw_tol", "1e-3", "--fw_thres", "25", "--bw_tol", "1e-5",
              "--bw_thres", "25", "--device", "cpu"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data"))
    generate_data(path, n_mesh=2, n_samples=5, hsize=0.25, seed=21,
                  verbose=False)
    return path


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """Meshes of 16 nodes, for dense Newton: each of its steps takes one
    JVP per entry of the state."""
    path = str(tmp_path_factory.mktemp("tiny"))
    generate_data(path, n_mesh=2, n_samples=5, hsize=0.6, seed=21,
                  verbose=False)
    return path


def _loaders(data_dir):
    train, val, _ = split_dataset(load_dataset(data_dir))
    return (GraphLoader(train, batch_size=3, shuffle=True, seed=0,
                        device="cpu"),
            GraphLoader(val, batch_size=3, device="cpu"))


def _lines(path):
    with open(path) as f:
        return f.read().strip().splitlines()


def test_trainer_two_epochs_logs_checkpoints_and_resume(tmp_path, data_dir):
    lt, lv = _loaders(data_dir)
    cfg = TrainConfig(model_cfg=PsignnConfig(**FAST), max_epochs=2,
                      path_results=str(tmp_path), device="cpu")
    tr = Trainer(cfg, lt, lv)
    tr.train_model()
    assert len(tr.hist_train["loss"]) == len(tr.hist_val["loss"]) == 2
    assert all(np.isfinite(v) for v in tr.hist_val["loss"])
    logs = os.path.join(str(tmp_path), "logs")
    # header + one line per train step (2 batches x 2 epochs)
    assert len(_lines(os.path.join(logs, "forward_iteration.csv"))) == 5
    assert len(_lines(os.path.join(logs, "backward_iteration.csv"))) == 5
    # header + one power-method estimate per validation batch and epoch
    assert len(_lines(os.path.join(logs, "spectral_radius.csv"))) == 3
    metrics = "\n".join(_lines(os.path.join(logs, "train_metrics.csv")))
    assert "Epoch 0, 50%" in metrics and "Validation Epoch 1" in metrics
    assert "Current Learning rate DEQ : 0.01" in metrics
    # the JAX trainer's count for the same model
    n_params = count_params(psignn_init(jax.random.PRNGKey(0),
                                        JaxPsignnConfig(**FAST)))
    with open(os.path.join(logs, "model_config.csv")) as f:
        assert f"Number of parameters : {n_params} " in f.read()
    ckpts = os.path.join(str(tmp_path), "ckpt")
    for name in ("running_model", "best_model", "final_model"):
        assert os.path.exists(os.path.join(ckpts, name + ".ckpt")), name

    final = os.path.join(ckpts, "final_model.ckpt")
    ck = load_checkpoint(final)
    assert ck["family"] == "psignn" and ck["hyperparameters"]["bw_thres"] == 25
    assert set(ck["torch_optim"]) == {"deq", "ae", "sched_deq", "sched_ae"}
    tr2 = Trainer(cfg, lt, lv)
    tr2.load_model(final)
    assert tr2.hist_val == tr.hist_val
    assert tr2.min_loss_save == tr.min_loss_save
    for (k, a), b in zip(tr.model.state_dict().items(),
                         tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(tr.opts, tr2.opts):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert all(torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"])
                   for i in sa)
    # resume continues the epoch numbering up to the absolute budget
    tr2.c.max_epochs = 3
    tr2.train_model()
    assert len(tr2.hist_val["loss"]) == 3
    assert "Validation Epoch 2" in "\n".join(
        _lines(os.path.join(logs, "train_metrics.csv")))


def test_trained_checkpoint_answers_a_sweep_request(tmp_path, data_dir):
    """``load_predictor`` reads a checkpoint the port trained."""
    lt, lv = _loaders(data_dir)
    cfg = TrainConfig(model_cfg=PsignnConfig(**FAST), max_epochs=1,
                      path_results=str(tmp_path), device="cpu",
                      val_sradius=False)
    Trainer(cfg, lt, lv).train_model()
    predict, family, pcfg, _ = load_predictor(
        os.path.join(str(tmp_path), "ckpt", "best_model.ckpt"), "cpu")
    assert family == "psignn" and pcfg.fw_thres == 25
    m = growing_geometry_sweep({family: predict}, radii=(1.0,), n_meshes=1,
                               hsize=0.25, seed=0, device="cpu",
                               warmup=False)[family][1.0]
    assert m["nstep"] > 0 and np.isfinite(m["res"]) and m["n_nodes"] > 0


@pytest.mark.parametrize("over", [
    dict(data_parallel=True, stacked_batch=True),
    dict(family="dsgps", data_parallel=True, stacked_batch=True)])
def test_trainer_refuses_unported_paths(tmp_path, data_dir, over):
    """Data parallelism is ported; per-graph solves stay refused with it,
    as in JAX (and per-graph solves for a family without a solve)."""
    lt, lv = _loaders(data_dir)
    with pytest.raises(ValueError, match="stacked_batch"):
        Trainer(TrainConfig(path_results=str(tmp_path), device="cpu",
                            **over), lt, lv)


def test_cli_help(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out and "--bw_tol" in out and "--resume" in out


def test_cli_tiny_run(tmp_path, data_dir, capsys):
    out = str(tmp_path / "run")
    main(["--path_dataset", data_dir, "--path_results", out,
          "--max_epochs", "1", "--batch_size", "3", *FAST_FLAGS])
    assert "Training finished" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "ckpt", "final_model.ckpt"))
    cfg_txt = open(os.path.join(out, "logs", "model_config.csv")).read()
    assert "'bw_thres':'25'" in cfg_txt and "cpu" in cfg_txt
    # --resume continues from the running checkpoint
    main(["--path_dataset", data_dir, "--path_results", out,
          "--max_epochs", "2", "--batch_size", "3", *FAST_FLAGS,
          "--resume", os.path.join(out, "ckpt", "running_model.ckpt")])
    log = open(os.path.join(out, "logs", "train_metrics.csv")).read()
    assert "Validation Epoch 0" in log and "Validation Epoch 1" in log


@pytest.mark.parametrize("foreign", ["beside", "inside"])
def test_cli_never_deletes_foreign_files(tmp_path, data_dir, monkeypatch,
                                         capsys, foreign):
    """With the default ``--path_results``, a fresh run clears only its
    own earlier ``ckpt/`` and ``logs/``: a checkpoint beside it in
    ``results/`` survives, and a directory holding a file it did not
    write is refused and kept."""
    monkeypatch.chdir(tmp_path)
    parent = ("results/psignn_dirichlet/ckpt" if foreign == "beside"
              else "results/psignn_torch_run")
    os.makedirs(parent)
    kept = os.path.join(parent, "best_model.ckpt")
    with open(kept, "w") as f:
        f.write("not the port's")
    stale = os.path.join("results", "psignn_torch_run", "logs", "old.csv")
    os.makedirs(os.path.dirname(stale))
    open(stale, "w").close()
    argv = ["--path_dataset", data_dir, "--max_epochs", "1",
            "--batch_size", "3", "--val_sradius", "0", *FAST_FLAGS]
    if foreign == "beside":
        main(argv)
        assert os.path.exists(os.path.join(
            "results", "psignn_torch_run", "ckpt", "final_model.ckpt"))
        assert not os.path.exists(stale)
    else:
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        assert "best_model.ckpt" in capsys.readouterr().err
        assert os.path.exists(stale)
    with open(kept) as f:
        assert f.read() == "not the port's"


def test_cli_spike_guard(tmp_path, data_dir):
    """A never-improving run (min_loss_save 0) trips the guard each epoch
    and halves the effective learning rate (tests/test_trainer.py:148)."""
    out = str(tmp_path / "guarded")
    main(["--path_dataset", data_dir, "--path_results", out,
          "--max_epochs", "2", "--batch_size", "3", "--min_loss_save", "0",
          "--spike_guard", "--spike_factor", "1e-6", "--spike_patience", "1",
          "--val_sradius", "0", *FAST_FLAGS])
    log = open(os.path.join(out, "logs", "train_metrics.csv")).read()
    scales = re.findall(r"lr scale now ([0-9.e-]+)", log)
    assert "SPIKE GUARD" in log and float(scales[-1]) == 0.25


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mixed"))
    generate_data(path, n_mesh=2, n_samples=5, hsize=0.25, seed=21,
                  variant="mixed", verbose=False)
    return path


def test_cli_mixed_run_trains_resumes_and_answers_the_table(
        tmp_path, mixed_dir, capsys):
    """``--variant mixed``: a mixed model trains on the shuffled split,
    writes its checkpoints, resumes, and its best checkpoint answers the
    test-split table of ``run_eval --variant mixed``."""
    out = str(tmp_path / "run")
    argv = ["--variant", "mixed", "--path_dataset", mixed_dir,
            "--path_results", out, "--batch_size", "3", *FAST_FLAGS]
    main(argv + ["--max_epochs", "1"])
    assert "Training finished" in capsys.readouterr().out
    ck = load_checkpoint(os.path.join(out, "ckpt", "final_model.ckpt"))
    assert ck["hyperparameters"]["bc_mode"] == "mixed"
    assert {"phi_neumann", "update_neumann"} <= set(ck["params"]["function"])
    logs = os.path.join(out, "logs")
    # header + one line per train step (6 train samples, batches of 3)
    assert len(_lines(os.path.join(logs, "forward_iteration.csv"))) == 3
    assert "'bc_mode':'mixed'" in open(os.path.join(
        logs, "model_config.csv")).read()
    main(argv + ["--max_epochs", "2", "--resume",
                 os.path.join(out, "ckpt", "running_model.ckpt")])
    log = "\n".join(_lines(os.path.join(logs, "train_metrics.csv")))
    assert "Validation Epoch 1" in log
    assert all(np.isfinite(v) for v in load_checkpoint(os.path.join(
        out, "ckpt", "final_model.ckpt"))["hist_val"]["loss"])
    capsys.readouterr()
    run_eval.main(["--ckpt", os.path.join(out, "ckpt", "best_model.ckpt"),
                   "--variant", "mixed", "--path_dataset", mixed_dir,
                   "--out", str(tmp_path / "eval"), "--device", "cpu"])
    assert "ResidualNorm" in capsys.readouterr().out
    table = json.loads((tmp_path / "eval" / "test_metrics.json").read_text())
    assert all(np.isfinite(v) for v in table.values())


@pytest.mark.parametrize("flags", [
    ["--solver", "anderson"], ["--solver", "forward_iteration"],
    ["--solver", "picard"], ["--broyden_ls"]],
    ids=lambda f: "_".join(f).strip("-"))
def test_cli_trains_with_each_solver(tmp_path, data_dir, capsys, flags):
    """One epoch with each solver of the slice: both fixed-point solves
    run it (one log line each per train step) and the losses are
    finite."""
    out = str(tmp_path / "run")
    main(["--path_dataset", data_dir, "--path_results", out,
          "--max_epochs", "1", "--batch_size", "3", "--val_sradius", "0",
          *FAST_FLAGS, *flags])
    assert "Training finished" in capsys.readouterr().out
    logs = os.path.join(out, "logs")
    for name in ("forward_iteration.csv", "backward_iteration.csv"):
        assert len(_lines(os.path.join(logs, name))) == 3, name
    ck = load_checkpoint(os.path.join(out, "ckpt", "final_model.ckpt"))
    hp = ck["hyperparameters"]
    assert hp["solver"] == (flags[1] if flags[0] == "--solver"
                            else "broyden")
    assert hp["ls"] is (flags == ["--broyden_ls"])
    assert all(np.isfinite(v) for v in ck["hist_train"]["loss"])


@pytest.mark.parametrize("flags", [
    ["--solver", "newton"], ["--solver", "newton_krylov"],
    ["--stacked_batch", "--solver", "newton_krylov"],
    ["--family", "dsgps", "--k", "3", "--solver", "newton"],
    ["--num_devices", "2", "--solver", "newton_krylov"]],
    ids=lambda f: "_".join(f).strip("-"))
def test_cli_trains_with_newton(tmp_path, data_dir, tiny_dir, capsys,
                                flags):
    """The Newton flags the CLI refused until they were ported each train
    an epoch on the CPU: alone, per graph, ignored by DS-GPS (as in JAX)
    and on two data-parallel ranks.  Newton converges in a few steps, so
    both solves stop at 6 (dense Newton: 2, on 16-node meshes)."""
    out = str(tmp_path / "run")
    dense = flags == ["--solver", "newton"]
    thres = "2" if dense else "6"
    main(["--path_dataset", tiny_dir if dense else data_dir,
          "--path_results", out, "--max_epochs", "1", "--batch_size", "3",
          "--val_sradius", "0", *FAST_FLAGS, "--fw_thres", thres,
          "--bw_thres", thres, *flags])
    assert "Training finished" in capsys.readouterr().out
    ck = load_checkpoint(os.path.join(out, "ckpt", "final_model.ckpt"))
    if "--family" not in flags:
        assert ck["hyperparameters"]["solver"] == flags[-1]
    assert all(np.isfinite(v) for v in ck["hist_train"]["loss"])


@pytest.mark.parametrize("flags", [
    ["--pallas"], ["--rcm"], ["--cache_batches", "1"], ["--comment", "x"],
    ["--pallas", "--cache_batches", "1", "--comment", "x"]],
    ids=lambda f: "_".join(f).strip("-"))
def test_cli_trains_with_jax_data_flags(tmp_path, data_dir, capsys, flags):
    """The JAX CLI's node-order, batch-cache and comment flags, once
    refused as TPU-only, each train a 2-epoch run to a finite loss; the
    checkpoint keeps the model config alone, as JAX's does."""
    out = str(tmp_path / "run")
    main(["--path_dataset", data_dir, "--path_results", out,
          "--max_epochs", "2", "--batch_size", "3", *FAST_FLAGS, *flags])
    assert "Training finished" in capsys.readouterr().out
    ck = load_checkpoint(os.path.join(out, "ckpt", "final_model.ckpt"))
    assert len(ck["hist_train"]["loss"]) == len(ck["hist_val"]["loss"]) == 2
    assert all(np.isfinite(v) for v in ck["hist_train"]["loss"]
               + ck["hist_val"]["loss"])
    assert not {"rcm", "pallas", "cache_batches", "comment"} \
        & set(ck["hyperparameters"])
