"""Port Ψ-GNN training (``psignn_forward`` and its implicit gradient, the
train step's clip and dual Adam, the plateau scheduler, the parameter
layout of checkpoints) against the JAX package, with the trained
``results/psignn_dirichlet`` weights on a small mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import fem_sample, kernel_route, load_trained
from psignn_tpu import deq as jdeq
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models import psignn_forward as jax_psignn_forward
from psignn_tpu.models import psignn_init
from psignn_tpu.models.psignn import encoder_apply, make_function
from psignn_tpu.train.optim import PlateauScheduler as JaxPlateauScheduler
from psignn_tpu.train.optim import adam_update, clip_by_global_norm, init_adam
from psignn_tpu_torch import deq
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import PsignnConfig, psignn_forward
from psignn_tpu_torch.solvers import SolverResult
from psignn_tpu_torch.train import optim, step
from psignn_tpu_torch.train.checkpoint import (load_checkpoint,
                                               optimizer_state_from_numpy,
                                               optimizer_state_to_numpy,
                                               save_checkpoint)
from psignn_tpu_torch.weights import (params_from_jax, params_to_jax,
                                      psignn_from_jax)

D = 10
LRS = (0.01, 0.05)
CLIP = 0.1
# reachable tolerances on the small mesh: both packages stop well before
# their f32 plateau
REACHABLE = dict(fw_tol=1e-4, fw_thres=200, bw_tol=1e-6, bw_thres=300)


@pytest.fixture(scope="module")
def trained():
    params, hp = load_trained()
    return params, hp


@pytest.fixture(scope="module")
def small():
    s = fem_sample(0, hsize=0.2)
    return jax_batch_graphs([s]), batch_graphs([s], device="cpu")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_psignn_forward_matches_jax(trained, small, monkeypatch):
    """The nine losses and the gradient of the training loss, with both
    packages fed the same h* (the JAX forward's, as numpy) and the same
    Hutchinson probe, so that the comparison isolates the adjoint solve
    and the Jacobian loss.  Losses: f32 sums in other orders (1e-4); each
    parameter's gradient as a relative norm within 1e-3 (adjoint solves
    stopped at 1e-6)."""
    params, hp = trained
    jg, tg = small
    n = tg.total_nodes
    jcfg = JaxPsignnConfig(**{**hp, **REACHABLE})
    cfg = PsignnConfig.from_hyperparameters(hp, **REACHABLE)
    jp = jax.tree.map(jnp.asarray, params)

    h0 = encoder_apply(jp["autoencoder"], jg.x) * jg.fnode_mask
    out_fw = jdeq.fixed_point_forward(make_function(jcfg), jp["function"],
                                      h0, jg, jcfg.deq)
    h_star = np.array(out_fw.result)
    v = torch.randn((n, D), generator=torch.Generator().manual_seed(9))
    v_pad = np.zeros_like(h_star)
    v_pad[:n] = v.numpy()

    monkeypatch.setattr(jdeq, "fixed_point_forward",
                        lambda *a, **k: out_fw._replace(
                            result=jnp.asarray(h_star)))
    monkeypatch.setattr(
        jdeq, "jac_loss_estimate",
        lambda f, p, hs, hi, g, rng, vecs=1, denom=None: jdeq.jac_loss_probe(
            f, p, hs, hi, g, jnp.asarray(v_pad), denom))

    def jloss(p):
        l = jax_psignn_forward(p, jg, jcfg, jax.random.PRNGKey(0)).losses
        total = (l["residual_loss"] + l["jacobian_loss"] + l["encoder_loss"]
                 + l["autoencoder_loss"])
        return total, l

    (jtotal, jl), jgrads = jax.jit(jax.value_and_grad(jloss,
                                                      has_aux=True))(jp)

    monkeypatch.setattr(deq, "fixed_point_forward", lambda *a, **k:
                        SolverResult(torch.from_numpy(h_star[:n]),
                                     float(out_fw.lowest),
                                     int(out_fw.nstep), False, None, None,
                                     None, int(out_fw.nstep) + 1,
                                     int(out_fw.nstep) + 1))
    model = psignn_from_jax(params, cfg, "cpu")
    out = psignn_forward(model, tg, cfg, torch.Generator().manual_seed(9))
    total = step.psignn_loss(out.losses, 1.0)
    total.backward()

    assert set(out.losses) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(out.losses[k].detach()),
                                   float(jl[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-4)
    want = params_from_jax(jgrads)
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), want[name].numpy()) < 1e-3, name
    assert out.adjoint.stats.lowest < 1e-6


def test_train_step_kernel_route_matches_plain(trained, small, monkeypatch):
    """A whole train step on the CUDA route's autograd wiring (the kernels
    replaced by their plain versions) gives the plain path's step, and
    launches each kernel as often as ``chip_smoke.expected_launches`` says
    from the solves' call counts."""
    params, hp = trained
    _, tg = small
    cfg = PsignnConfig.from_hyperparameters(hp, **REACHABLE)

    def run():
        model = psignn_from_jax(params, cfg, "cpu")
        opts = optim.make_optimizers(model, *LRS)
        res = step.train_step(model, opts, tg, cfg, LRS, CLIP, 1.0,
                              torch.Generator().manual_seed(3))
        return res, model

    plain, m_plain = run()
    fm = kernel_route(monkeypatch)
    routed, m_routed = run()
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == \
        chip_smoke.expected_launches(routed, cfg)
    assert routed.fw == plain.fw
    assert routed.bw.calls == plain.bw.calls
    for k in plain.losses:
        np.testing.assert_allclose(routed.losses[k], plain.losses[k],
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(routed.grad_norm, plain.grad_norm, rtol=1e-4)
    for (k, a), b in zip(m_plain.state_dict().items(),
                         m_routed.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _jax_apply(jparams, jgrads, states, lrs):
    g, total = clip_by_global_norm(jgrads, CLIP)
    pf, sd = adam_update(g["function"], states["deq"], jparams["function"],
                         lrs[0])
    pa, sa = adam_update(g["autoencoder"], states["ae"],
                         jparams["autoencoder"], lrs[1])
    return {"function": pf, "autoencoder": pa}, {"deq": sd, "ae": sa}, total


def test_train_step_matches_jax_optimizer(trained, small, monkeypatch):
    """One full ``train_step`` and two more optimizer steps, against
    ``clip_by_global_norm`` + two ``adam_update``s of the JAX package given
    the same gradients (the port's, recorded before its clip).  The same
    formulas in f32, 1e-5 relative; 1e-6 absolute, 1e-4 of the step size
    lr: torch takes √v/√(1−β₂ᵗ) where optax takes √(v/(1−β₂ᵗ)), which
    rounds a step differently where v is small."""
    params, hp = trained
    _, tg = small
    cfg = PsignnConfig.from_hyperparameters(hp, **REACHABLE)
    model = psignn_from_jax(params, cfg, "cpu")
    opts = optim.make_optimizers(model, *LRS)
    recorded = []
    real_apply = step.apply_gradients

    def recording(ps, o, lrs, clip):
        ps = list(ps)
        recorded.append({n: p.grad.clone() for n, p in
                         model.named_parameters()})
        return real_apply(ps, o, lrs, clip)

    monkeypatch.setattr(step, "apply_gradients", recording)
    res = step.train_step(model, opts, tg, cfg, LRS, CLIP, 1.0,
                          torch.Generator().manual_seed(1))
    rng = np.random.default_rng(5)
    jparams = jax.tree.map(jnp.asarray, params)
    states = {"deq": init_adam(jparams["function"]),
              "ae": init_adam(jparams["autoencoder"])}
    for i in range(3):
        if i == 0:
            grads = recorded[0]
        else:    # two more steps with seeded gradients, one below the clip
            scale = (1.0, 1e-3)[i - 1]
            grads = {n: torch.from_numpy(
                (scale * rng.normal(size=p.shape)).astype(np.float32))
                for n, p in model.named_parameters()}
            for n, p in model.named_parameters():
                p.grad = grads[n].clone()
            total = optim.apply_gradients(model.parameters(), opts, LRS, CLIP)
        jgrads = jax.tree.map(jnp.asarray, params_to_jax(grads))
        jparams, states, jtotal = _jax_apply(jparams, jgrads, states, LRS)
        got = params_to_jax(model.state_dict())
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(res.grad_norm if i == 0 else float(total),
                                   float(jtotal), rtol=1e-5)
    assert res.bw is not None and np.isfinite(res.loss)


def test_plateau_scheduler_matches_jax():
    """The same lr sequence as the JAX scheduler on a metric with
    improvements, plateaus and cuts far below 1e-8 (torch's
    ReduceLROnPlateau would skip those)."""
    rng = np.random.default_rng(0)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 6), np.full(25, 0.5),
                              0.5 - 1e-6 * rng.random(40), np.full(60, 0.1)])
    ours = optim.PlateauScheduler(1e-9, factor=0.5, patience=3)
    ref = JaxPlateauScheduler(1e-9, factor=0.5, patience=3)
    got = [ours.step(float(m)) for m in metrics]
    want = [ref.step(float(m)) for m in metrics]
    assert got == want and got[-1] < 1e-12
    assert ours.state_dict() == ref.state_dict()
    fresh = optim.PlateauScheduler(1.0)
    fresh.load_state_dict(ref.state_dict())
    assert fresh == ours


def test_params_to_jax_is_the_inverse(trained):
    params, hp = trained
    back = params_to_jax(params_from_jax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    # the layout of a fresh JAX model of two layers
    two = psignn_init(jax.random.PRNGKey(0), JaxPsignnConfig(n_layers=2))
    tree = params_to_jax(params_from_jax(two))
    assert jax.tree.structure(tree) == jax.tree.structure(two)


def test_optimizer_state_round_trips_through_a_checkpoint(trained, small,
                                                          tmp_path):
    params, hp = trained
    _, tg = small
    cfg = PsignnConfig.from_hyperparameters(hp, **REACHABLE)
    model = psignn_from_jax(params, cfg, "cpu")
    opts = optim.make_optimizers(model, *LRS)
    step.train_step(model, opts, tg, cfg, LRS, CLIP, 1.0,
                    torch.Generator().manual_seed(1))
    path = save_checkpoint(
        dict(params=params_to_jax(model.state_dict()),
             opt=optimizer_state_to_numpy(opts[0].state_dict())),
        str(tmp_path), "x")
    ck = load_checkpoint(path)
    fresh = optim.make_optimizers(psignn_from_jax(ck["params"], cfg, "cpu"),
                                  *LRS)[0]
    fresh.load_state_dict(optimizer_state_from_numpy(ck["opt"]))
    a, b = opts[0].state_dict(), fresh.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i in a["state"]:
        for k in a["state"][i]:
            assert torch.equal(a["state"][i][k], b["state"][i][k]), (i, k)
