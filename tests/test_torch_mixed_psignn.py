"""Port mixed Dirichlet+Neumann Ψ-GNN (f_θ with the Neumann branch,
inference by each solver, the training forward and its gradient, the train
step's kernel launches, the test-split table of ``run_eval``) against the
JAX package, with the trained ``results/psignn_mixed`` weights on small
mixed meshes.  The port runs on the CUDA route's autograd wiring with each
kernel replaced by its plain version (``_torch_parity.kernel_route``)
wherever kernels are counted."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import MIXED_CKPT, kernel_route, load_trained, mixed_sample
from psignn_tpu import deq as jdeq
from psignn_tpu.data.reader import GraphLoader as JaxGraphLoader
from psignn_tpu.data.reader import load_dataset as jax_load_dataset
from psignn_tpu.data.reader import split_dataset as jax_split_dataset
from psignn_tpu.eval.metrics import evaluate_dataset as jax_evaluate_dataset
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models import psignn_forward as jax_psignn_forward
from psignn_tpu.models import psignn_inference as jax_psignn_inference
from psignn_tpu.models import psignn_init
from psignn_tpu.models.psignn import encoder_apply, make_function
from psignn_tpu.train.trainer import count_params
from psignn_tpu_torch import deq
from psignn_tpu_torch.data.generate import generate_data
from psignn_tpu_torch.eval import run_eval
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import PsignnConfig, psignn_forward
from psignn_tpu_torch.models import psignn_inference
from psignn_tpu_torch.train import optim, step
from psignn_tpu_torch.weights import (load_psignn_checkpoint,
                                      params_from_jax, params_to_jax,
                                      psignn_from_jax)

D = 10


@pytest.fixture(scope="module")
def trained():
    params, hp = load_trained(MIXED_CKPT)
    return params, hp, jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def small():
    """One small mixed mesh (92 nodes) in both packages' graph forms."""
    s = mixed_sample(0, hsize=0.2)
    return jax_batch_graphs([s]), batch_graphs([s], device="cpu")


def _configs(hp, **over):
    return (JaxPsignnConfig(**{**hp, **over}),
            PsignnConfig.from_hyperparameters(hp, **over))


def _calls(model):
    """A list that grows by one with each call of ``model.function``."""
    calls = []
    model.function.register_forward_hook(lambda *a: calls.append(1))
    return calls


def test_mixed_checkpoint_loads_and_round_trips(trained):
    params, hp, _ = trained
    model, cfg = load_psignn_checkpoint(MIXED_CKPT, "cpu")
    assert cfg.bc_mode == "mixed" and cfg.prb_dim == 3 and not model.training
    # the JAX model's parameter count: phi_neumann and update_neumann added
    n_jax = count_params(psignn_init(jax.random.PRNGKey(0),
                                     JaxPsignnConfig(bc_mode="mixed")))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 2175
    # update_neumann reads [h, mp_neu, prb_data, normal]: 2D + 3 + 2
    assert model.function.update_neumann.layers[0].weight.shape == (D, 25)
    back = params_to_jax(params_from_jax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_mixed_update_function_matches_jax(trained, small, route,
                                           monkeypatch):
    """f_θ on seeded h, 1e-5 (f32 sums in another order); three kernel
    launches a call on the kernel route; Dirichlet rows reset exactly."""
    params, hp, jp = trained
    jg, tg = small
    jcfg, cfg = _configs(hp)
    model = psignn_from_jax(params, cfg, "cpu")
    fm = kernel_route(monkeypatch) if route == "kernel" else None
    n = tg.total_nodes
    h = np.zeros((jg.n_node_cap, D), np.float32)
    h[:n] = np.random.default_rng(11).normal(size=(n, D))
    h0 = np.array(encoder_apply(jp["autoencoder"], jg.x) * jg.fnode_mask)
    want = np.asarray(make_function(jcfg)(jp["function"], jnp.asarray(h),
                                          jnp.asarray(h0), jg))
    with torch.no_grad():
        got = model.function(torch.from_numpy(h[:n]),
                             torch.from_numpy(h0[:n]), tg).numpy()
    np.testing.assert_allclose(got, want[:n], rtol=1e-5, atol=1e-5)
    dmask = tg.dirichlet_mask[:, 0].numpy() > 0
    np.testing.assert_array_equal(got[dmask], h0[:n][dmask])
    if fm is not None:
        assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == (3, 0)


def test_mixed_model_refuses_a_dirichlet_graph(trained):
    from _torch_parity import fem_sample
    params, hp, _ = trained
    model = psignn_from_jax(params, PsignnConfig.from_hyperparameters(hp),
                            "cpu")
    g = batch_graphs([fem_sample(0, hsize=0.3)], device="cpu")
    with pytest.raises(ValueError, match="mixed graph"):
        with torch.no_grad():
            model.function(torch.zeros(g.total_nodes, D),
                           torch.zeros(g.total_nodes, D), g)


@pytest.mark.parametrize("solver,ls,tol", [
    ("broyden", False, 1e-4), ("broyden", True, 1e-4),
    ("anderson", False, 1e-4), ("forward_iteration", False, 1e-3)])
def test_mixed_inference_matches_jax(trained, small, monkeypatch, solver,
                                     ls, tol):
    """Full solves at a tolerance reached before the f32 plateau: nstep
    within 2, lowest within 5 %, u within 1e-3 of its largest value; three
    forward launches per f_θ call."""
    params, hp, jp = trained
    jg, tg = small
    jcfg, cfg = _configs(hp, solver=solver, ls=ls, fw_tol=tol)
    model = psignn_from_jax(params, cfg, "cpu")
    calls = _calls(model)
    fm = kernel_route(monkeypatch)
    u, nstep, lowest, prot = psignn_inference(model, tg, cfg)
    ju, jnstep, jlowest = jax.jit(
        lambda p, g: jax_psignn_inference(p, g, jcfg))(jp, jg)
    n = tg.total_nodes
    assert abs(nstep - int(jnstep)) <= 2 and not prot
    assert lowest <= tol
    np.testing.assert_allclose(lowest, float(jlowest), rtol=0.05)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju)[:n], rtol=0,
                               atol=1e-3 * float(np.abs(np.asarray(ju)).max()))
    assert fm.LAUNCHES == 3 * len(calls) > 0 and fm.BWD_LAUNCHES == 0


# both solves run to their f32 floor
FLOOR = dict(fw_tol=1e-7, fw_thres=600, bw_tol=1e-9, bw_thres=600)


def test_mixed_forward_matches_jax_at_the_floor(trained, small,
                                                monkeypatch):
    """The training forward's losses and every parameter's gradient, each
    package solving its own forward and adjoint fixed points to the f32
    floor, with one shared Hutchinson probe.  Losses within 2e-5 relative;
    gradients within 1e-4 as a relative norm (the packages' f32 floors
    differ, and (I − J)⁻¹ amplifies that).  The forward solve's stats stop
    chaotically at the floor: both lowest values are under 2e-7."""
    params, hp, jp = trained
    jg, tg = small
    n = tg.total_nodes
    jcfg, cfg = _configs(hp, **FLOOR)
    v = torch.randn((n, D), generator=torch.Generator().manual_seed(9))
    v_pad = np.zeros((jg.n_node_cap, D), np.float32)
    v_pad[:n] = v.numpy()
    monkeypatch.setattr(
        jdeq, "jac_loss_estimate",
        lambda f, p, hs, hi, g, rng, vecs=1, denom=None: jdeq.jac_loss_probe(
            f, p, hs, hi, g, jnp.asarray(v_pad), denom))

    def jloss(p):
        l = jax_psignn_forward(p, jg, jcfg, jax.random.PRNGKey(0)).losses
        return (l["residual_loss"] + l["jacobian_loss"] + l["encoder_loss"]
                + l["autoencoder_loss"]), l

    (jtotal, jl), jgrads = jax.jit(jax.value_and_grad(jloss,
                                                      has_aux=True))(jp)

    monkeypatch.setattr(
        deq, "jac_loss_estimate",
        lambda f, hs, hi, g, gen, vecs=1, denom=None: deq.jac_loss_probe(
            f, hs, hi, g, v, denom))
    fm = kernel_route(monkeypatch)
    model = psignn_from_jax(params, cfg, "cpu")
    out = psignn_forward(model, tg, cfg, torch.Generator().manual_seed(9))
    total = step.psignn_loss(out.losses, 1.0)
    total.backward()

    assert set(out.losses) == set(jl)
    for k in set(jl) - {"fw_lowest", "fw_nstep"}:
        np.testing.assert_allclose(float(out.losses[k].detach()),
                                   float(jl[k]), rtol=2e-5, atol=1e-9,
                                   err_msg=k)
    assert max(out.fw.lowest, float(jl["fw_lowest"])) < 2e-7
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=2e-5)
    want = params_from_jax(jgrads)
    assert set(want) == dict(model.named_parameters()).keys()
    for name, p in model.named_parameters():
        rel = float(torch.linalg.vector_norm(p.grad - want[name])
                    / torch.linalg.vector_norm(want[name]))
        assert rel < 1e-4, (name, rel)
    assert out.adjoint.stats.lowest < 1e-7
    assert fm.BWD_LAUNCHES > 0


def test_mixed_train_step_launches_and_matches_plain(trained, small,
                                                     monkeypatch):
    """A mixed train step on the kernel route equals the plain path's and
    launches 3·(fw calls + 2) forward and 3·(bw calls + 3) backward
    kernels (``chip_smoke.expected_launches``)."""
    params, hp, _ = trained
    _, tg = small
    cfg = PsignnConfig.from_hyperparameters(
        hp, fw_tol=1e-4, fw_thres=200, bw_tol=1e-6, bw_thres=300)
    lrs = (0.01, 0.05)

    def run():
        model = psignn_from_jax(params, cfg, "cpu")
        opts = optim.make_optimizers(model, *lrs)
        res = step.train_step(model, opts, tg, cfg, lrs, 0.1, 1.0,
                              torch.Generator().manual_seed(3))
        return res, model

    plain, m_plain = run()
    fm = kernel_route(monkeypatch)
    routed, m_routed = run()
    assert chip_smoke.mp_per_call(cfg) == 3
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == \
        chip_smoke.expected_launches(routed, cfg)
    assert routed.fw == plain.fw and routed.bw.calls == plain.bw.calls
    for k in plain.losses:
        np.testing.assert_allclose(routed.losses[k], plain.losses[k],
                                   rtol=1e-5, err_msg=k)
    for (k, a), b in zip(m_plain.state_dict().items(),
                         m_routed.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mixed_eval"))
    generate_data(path, n_mesh=2, n_samples=5, hsize=0.25, seed=4,
                  variant="mixed", verbose=False)
    return path


def test_mixed_test_split_table_matches_jax(trained, mixed_dir, tmp_path,
                                            capsys):
    """``run_eval --variant mixed`` writes the test split's table within
    2e-4 of JAX ``evaluate_dataset`` on the same checkpoint and data (the
    test split of the shuffled mixed split, in batches of 2)."""
    _, hp, jp = trained
    out = tmp_path / "eval"
    run_eval.main(["--ckpt", MIXED_CKPT, "--variant", "mixed",
                   "--path_dataset", mixed_dir, "--batch_size", "2",
                   "--out", str(out), "--device", "cpu"])
    assert "ResidualNorm" in capsys.readouterr().out
    got = json.loads((out / "test_metrics.json").read_text())
    _, _, test = jax_split_dataset(
        jax_load_dataset(mixed_dir, family="psignn", variant="mixed"),
        family="psignn", variant="mixed")
    jcfg = JaxPsignnConfig(**hp)
    predict = jax.jit(lambda g: jax_psignn_inference(jp, g, jcfg)[0])
    want = jax_evaluate_dataset(predict, JaxGraphLoader(test, batch_size=2),
                                verbose=False)
    assert set(got) == set(want) and len(want) == 10
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("argv", [
    ["--ckpt", MIXED_CKPT, "--sweep"],
    ["--ckpt", MIXED_CKPT, "--variant", "dirichlet", "--path_dataset", "x"],
])
def test_run_eval_refuses_mixed_mismatches(argv, capsys):
    """The sweep builds Dirichlet samples; a mixed checkpoint's table needs
    mixed data."""
    with pytest.raises(SystemExit) as e:
        run_eval.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert "mixed" in capsys.readouterr().err
