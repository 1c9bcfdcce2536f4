"""Resuming the port's trainer from a JAX checkpoint: its optax
``scale_by_adam`` states (count, mu, nu) become torch Adam's step,
exp_avg and exp_avg_sq, and training goes on from them.

Adam against ``adam_update`` from the same state with the same gradients:
the same formulas in f32, parameters within 1e-5 relative and 1e-6
absolute, moments within 1e-6 relative (1e-9 and 1e-12 absolute, where
a sum of two steps cancels), as ``test_torch_train.py`` holds them: torch
takes √v/√(1−β₂ᵗ) where optax takes √(v/(1−β₂ᵗ)), and mixes the moments
in another order."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CKPT, DSGPS_CKPT, DSS_CKPT
from psignn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from psignn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from psignn_tpu.train.optim import PlateauScheduler as JaxPlateauScheduler
from psignn_tpu.train.optim import adam_update, clip_by_global_norm, init_adam
from psignn_tpu_torch.cli.main import main
from psignn_tpu_torch.data.generate import generate_data
from psignn_tpu_torch.train import TrainConfig, Trainer, load_checkpoint
from psignn_tpu_torch.train.optim import apply_gradients
from psignn_tpu_torch.weights import FAMILIES

CKPTS = {"psignn": CKPT, "dsgps": DSGPS_CKPT, "dss": DSS_CKPT}
LRS = {"psignn": (0.01, 0.05), "dsgps": (1e-3,), "dss": (0.01,)}
CLIPS = {"psignn": 0.1, "dsgps": 0.01, "dss": 0.01}
FAST = dict(fw_tol=1e-3, fw_thres=25, bw_tol=1e-5, bw_thres=25)


class _NoData:
    """The loaders a trainer is built with, when it is only loaded."""
    samples: list = []
    batch_size = 1


def _trainer(family, hp, path):
    cfg = FAMILIES[family][1].from_hyperparameters(hp)
    return Trainer(TrainConfig(family=family, model_cfg=cfg,
                               path_results=str(path), device="cpu"),
                   _NoData(), _NoData())


def _jax_step(family, jparams, jstate, grads_sd, lrs):
    """The JAX trainer's clip and Adam on the port's gradients."""
    jgrads = jax.tree.map(jnp.asarray, FAMILIES[family][3](grads_sd))
    g, _ = clip_by_global_norm(jgrads, CLIPS[family])
    if family != "psignn":
        return adam_update(g, jstate, jparams, lrs[0])
    pf, sd = adam_update(g["function"], jstate["deq"], jparams["function"],
                         lrs[0])
    pa, sa = adam_update(g["autoencoder"], jstate["ae"],
                         jparams["autoencoder"], lrs[1])
    return {"function": pf, "autoencoder": pa}, {"deq": sd, "ae": sa}


def _moments(family, jstate):
    """The JAX states' (count, mu, nu) of each optimizer as port state
    dicts."""
    from_jax = FAMILIES[family][2]
    if family != "psignn":
        return [(int(jstate.count), from_jax(jstate.mu), from_jax(jstate.nu))]
    mu = from_jax({"function": jstate["deq"].mu,
                   "autoencoder": jstate["ae"].mu})
    nu = from_jax({"function": jstate["deq"].nu,
                   "autoencoder": jstate["ae"].nu})
    return [(int(jstate[k].count), mu, nu) for k in ("deq", "ae")]


def _assert_adam_state(trainer, family, jstate):
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for opt, (count, mu, nu) in zip(trainer.opts, _moments(family, jstate)):
        for group in opt.param_groups:
            for p in group["params"]:
                name = names[id(p)]
                if name.startswith("laynorm."):      # DS-GPS's, unused
                    assert p not in opt.state
                    continue
                st = opt.state[p]
                assert int(st["step"]) == count, name
                np.testing.assert_allclose(st["exp_avg"].numpy(),
                                           mu[name].numpy(), rtol=1e-6,
                                           atol=1e-9, err_msg=name)
                np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                           nu[name].numpy(), rtol=1e-6,
                                           atol=1e-12, err_msg=name)


@pytest.mark.parametrize("family", list(CKPTS))
def test_adam_resumed_from_a_trained_checkpoint_matches_optax(family,
                                                              tmp_path):
    """Each family's trained ``results/*`` checkpoint: the port's Adams
    after ``_load_state`` hold its optax counts and moments; then two steps
    with the same seeded gradients (one clipped, one not) in both packages
    give the same parameters and moments.  DS-GPS's unused ``laynorm``
    gets no state and no gradient (JAX's is zero)."""
    jck = jax_load_checkpoint(CKPTS[family])
    ck = load_checkpoint(CKPTS[family])
    tr = _trainer(family, ck["hyperparameters"], tmp_path)
    tr._load_state(ck)
    jparams = jax.tree.map(jnp.asarray, jck["params"])
    jstate = jck["opt_state"]
    _assert_adam_state(tr, family, jstate)

    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-4):
        grads = {}
        for n, p in tr.model.named_parameters():
            g = (scale * rng.normal(size=p.shape)).astype(np.float32)
            if n.startswith("laynorm."):
                g[:] = 0.0
            else:
                p.grad = torch.from_numpy(g.copy())
            grads[n] = torch.from_numpy(g)
        apply_gradients(tr.model.parameters(), tr.opts, LRS[family],
                        CLIPS[family])
        jparams, jstate = _jax_step(family, jparams, jstate, grads,
                                    LRS[family])
        want = FAMILIES[family][2](jparams)
        for n, p in tr.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=n)
    _assert_adam_state(tr, family, jstate)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data"))
    generate_data(path, n_mesh=2, n_samples=5, hsize=0.25, seed=21,
                  verbose=False)
    return path


def _jax_format_checkpoint(family, path):
    """A checkpoint as the JAX trainer writes it after one epoch, built
    with the JAX package's own ``init_adam``, ``adam_update`` and
    ``save_checkpoint`` from the trained parameters: two Adam steps on
    seeded gradients, the schedulers at the top level."""
    ck = jax_load_checkpoint(CKPTS[family])
    params = jax.tree.map(jnp.asarray, ck["params"])
    if family == "psignn":
        state = {"deq": init_adam(params["function"]),
                 "ae": init_adam(params["autoencoder"])}
    else:
        state = init_adam(params)
    rng = np.random.default_rng(3)
    for _ in range(2):
        grads = jax.tree.map(lambda x: jnp.asarray(
            1e-2 * rng.normal(size=x.shape), jnp.float32), params)
        if family == "psignn":
            pf, sd = adam_update(grads["function"], state["deq"],
                                 params["function"], 1e-3)
            pa, sa = adam_update(grads["autoencoder"], state["ae"],
                                 params["autoencoder"], 1e-3)
            params, state = {"function": pf, "autoencoder": pa}, \
                {"deq": sd, "ae": sa}
        else:
            params, state = adam_update(grads, state, params, 1e-3)
    keys = ["loss", "residual_loss", "jacobian_loss", "encoder_loss",
            "autoencoder_loss", "mse_loss"]
    hp = dict(ck["hyperparameters"])
    if family == "psignn":
        hp.update(FAST)
    out = dict(epoch=0, family=family, hyperparameters=hp, params=params,
               opt_state=state, hist_train={k: [1.0] for k in keys},
               hist_val={k: [1.0] for k in keys}, min_loss_save=1.0,
               lr_scale=1.0, training_time=1.0)
    if family == "psignn":
        out["sched_deq"] = JaxPlateauScheduler(0.004, 0.5).state_dict()
        out["sched_ae"] = JaxPlateauScheduler(0.02, 0.5).state_dict()
    return jax_save_checkpoint(out, path, "best_model"), state


@pytest.mark.parametrize("family", ["psignn", "dsgps"])
def test_cli_resumes_a_jax_checkpoint(family, data_dir, tmp_path, capsys):
    """``--resume`` of a JAX-format checkpoint: the trainer picks up its
    parameters, Adam states, histories and (Ψ-GNN) schedulers, then the
    CLI trains epoch 1 on top of them and writes port checkpoints."""
    path, jstate = _jax_format_checkpoint(family, str(tmp_path / "jax"))
    ck = load_checkpoint(path)
    tr = _trainer(family, ck["hyperparameters"], tmp_path / "probe")
    tr.load_model(path)
    _assert_adam_state(tr, family, jstate)
    assert tr.hist_val["loss"] == [1.0] and tr.training_time == 1.0
    if family == "psignn":
        assert (tr.sched_deq.lr, tr.sched_ae.lr) == (0.004, 0.02)

    out = str(tmp_path / "run")
    flags = (["--fw_tol", "1e-3", "--fw_thres", "25", "--bw_tol", "1e-5",
              "--bw_thres", "25", "--val_sradius", "0"] if family == "psignn"
             else ["--family", "dsgps", "--k", "3"])
    main(["--path_dataset", data_dir, "--path_results", out, "--resume",
          path, "--max_epochs", "2", "--batch_size", "3", "--device", "cpu",
          *flags])
    assert "Training finished" in capsys.readouterr().out
    with open(os.path.join(out, "logs", "train_metrics.csv")) as f:
        log = f.read()
    assert "Training Epoch 1 :" in log and "Training Epoch 0 :" not in log
    final = load_checkpoint(os.path.join(out, "ckpt", "final_model.ckpt"))
    assert len(final["hist_val"]["loss"]) == 2
    assert all(np.isfinite(v) for v in final["hist_train"]["loss"])
    # two steps of the new epoch on top of the two in the checkpoint
    steps = [s["step"] for key in ("deq", "ae", "adam")
             if key in final["torch_optim"]
             for s in final["torch_optim"][key]["state"].values()]
    assert steps and all(int(s) == 4 for s in steps)
    if family == "psignn":
        assert final["torch_optim"]["sched_deq"]["lr"] == 0.004
