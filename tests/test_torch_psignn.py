"""Port Ψ-GNN (update function, inference, metrics, sweep) against the JAX
package, with the trained ``results/psignn_dirichlet`` weights."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CKPT, fem_sample, load_trained
from psignn_tpu.deq import fixed_point_forward as jax_fixed_point_forward
from psignn_tpu.eval.metrics import errors_batch as jax_errors_batch
from psignn_tpu.graphs import batch_graphs as jax_batch_graphs
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models import psignn_inference as jax_psignn_inference
from psignn_tpu.models.psignn import encoder_apply, make_function
from psignn_tpu_torch.deq import fixed_point_forward
from psignn_tpu_torch.eval import run_eval, sweep
from psignn_tpu_torch.eval.metrics import errors_batch
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import Psignn, PsignnConfig, psignn_inference
from psignn_tpu_torch.ops import (mse_per_graph, residual_loss,
                                  residual_per_graph)
from psignn_tpu_torch.weights import psignn_from_jax


@pytest.fixture(scope="module")
def trained():
    params, hp = load_trained()
    return params, hp, jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def small():
    """One small mesh (~90 nodes) in both packages' graph forms."""
    s = fem_sample(0, hsize=0.2)
    return s, jax_batch_graphs([s]), batch_graphs([s], device="cpu")


def _configs(hp, **over):
    return (JaxPsignnConfig(**{**hp, **over}),
            PsignnConfig.from_hyperparameters(hp, **over))


def test_update_function_matches_jax(trained, small):
    params, hp, jp = trained
    s, jg, tg = small
    jcfg, cfg = _configs(hp)
    model = psignn_from_jax(params, cfg, "cpu")
    n = tg.total_nodes
    rng = np.random.default_rng(11)
    h = np.zeros((jg.n_node_cap, 10), np.float32)
    h[:n] = rng.normal(size=(n, 10))
    h0 = np.array(encoder_apply(jp["autoencoder"], jg.x) * jg.fnode_mask)
    want = np.asarray(make_function(jcfg)(jp["function"], jnp.asarray(h),
                                          jnp.asarray(h0), jg))
    with torch.no_grad():
        got = model.function(torch.from_numpy(h[:n]),
                             torch.from_numpy(h0[:n]), tg).numpy()
    np.testing.assert_allclose(got, want[:n], rtol=1e-5, atol=1e-5)
    # Dirichlet rows are reset to h_initial exactly
    dmask = tg.dirichlet_mask[:, 0].numpy() > 0
    np.testing.assert_array_equal(got[dmask], h0[:n][dmask])


def test_first_iterates_match_jax(trained, small):
    """The first 20 Broyden iterates of f_θ, iterate by iterate."""
    params, hp, jp = trained
    _, jg, tg = small
    jcfg, cfg = _configs(hp, fw_tol=0.0, fw_thres=20)
    model = psignn_from_jax(params, cfg, "cpu")
    jh0 = encoder_apply(jp["autoencoder"], jg.x) * jg.fnode_mask
    want = jax_fixed_point_forward(make_function(jcfg), jp["function"], jh0,
                                   jg, jcfg.deq, keep_trace=True)
    with torch.no_grad():
        h0 = model.encoder(tg.x) * tg.fnode_mask
    got = fixed_point_forward(model.function, h0, tg, cfg.deq,
                              keep_trace=True)
    n = tg.total_nodes
    assert got.trace_len == int(want.trace_len) == 21
    # f32 round-off of two summation orders, grown over 20 secant updates
    np.testing.assert_allclose(got.trace.numpy(),
                               np.asarray(want.trace)[:, :n], rtol=0,
                               atol=1e-4)
    # rel = ‖g‖/‖f(x)‖ carries an absolute cancellation floor of a few f32
    # ε (1.2e-7) once the residual is small: atol 1e-6 covers that floor
    np.testing.assert_allclose(got.rel_trace.numpy(),
                               np.asarray(want.rel_trace), rtol=1e-3,
                               atol=1e-6)


def test_inference_matches_jax_at_reachable_tol(trained, small):
    """Full solve at a tolerance the solve reaches before its plateau: the
    stopping step is then well defined (tests/test_halo.py:125-129)."""
    params, hp, jp = trained
    _, jg, tg = small
    jcfg, cfg = _configs(hp, fw_tol=1e-4)
    u, nstep, lowest, prot = psignn_inference(
        psignn_from_jax(params, cfg, "cpu"), tg, cfg)
    ju, jnstep, jlowest = jax.jit(
        lambda p, g: jax_psignn_inference(p, g, jcfg))(jp, jg)
    n = tg.total_nodes
    assert abs(nstep - int(jnstep)) <= 2
    # best relative residual near fw_tol: within 5 % (chaotic last steps)
    np.testing.assert_allclose(lowest, float(jlowest), rtol=0.05)
    assert lowest < 1e-4 and not prot
    np.testing.assert_allclose(u.numpy(), np.asarray(ju)[:n], rtol=0,
                               atol=1e-3 * float(np.abs(np.asarray(ju)).max()))


def test_errors_batch_matches_jax():
    samples = [fem_sample(s, hsize=0.25) for s in (1, 2)]
    jg = jax_batch_graphs(samples)
    tg = batch_graphs(samples, device="cpu")
    n = tg.total_nodes
    rng = np.random.default_rng(4)
    u = np.zeros((jg.n_node_cap, 1), np.float32)
    u[:n] = np.concatenate([s["sol"] for s in samples]) \
        + 0.05 * rng.normal(size=(n, 1)).astype(np.float32)
    want = jax_errors_batch(jnp.asarray(u), jg)
    got = errors_batch(torch.from_numpy(u[:n]), tg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (2,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)
    tu = torch.from_numpy(u[:n])
    np.testing.assert_allclose(residual_per_graph(tu, tg).numpy(),
                               np.asarray(want["res"]), rtol=1e-5)
    np.testing.assert_allclose(mse_per_graph(tu, tg.sol, tg).numpy(),
                               np.asarray(want["mse"]), rtol=1e-5)
    np.testing.assert_allclose(
        float(residual_loss(tu, tg)),
        float(np.asarray(want["res"]) @ tg.n_nodes.numpy() / n), rtol=1e-5)


def test_growing_geometry_sweep_matches_jax(trained, tmp_path):
    """One sweep call on the CPU through the user's entry point, held
    against the JAX sweep on the same seeded meshes."""
    from psignn_tpu.eval.sweep import growing_geometry_sweep as jax_sweep
    params, hp, jp = trained
    jcfg = JaxPsignnConfig(**{**hp, "fw_tol": 1e-4})
    predict, family, cfg, _ = run_eval.load_predictor(
        CKPT, "cpu", overrides=dict(fw_tol=1e-4))
    assert family == "psignn" and cfg.fw_thres == 500
    kw = dict(radii=(0.6, 1.0), n_meshes=1, hsize=0.25, seed=3)
    got = sweep.growing_geometry_sweep({"psignn": predict}, device="cpu",
                                       out_dir=str(tmp_path), **kw)["psignn"]
    want = jax_sweep(
        {"psignn": jax.jit(lambda g: jax_psignn_inference(jp, g, jcfg))},
        families=("psignn",), **kw)["psignn"]
    for r in kw["radii"]:
        assert got[r]["n_nodes"] == want[r]["n_nodes"]
        assert got[r]["n_edges"] > got[r]["n_nodes"]
        assert abs(got[r]["nstep"] - want[r]["nstep"]) <= 2
        for k in ("res", "mse", "rel"):
            assert np.isfinite(got[r][k])
            np.testing.assert_allclose(got[r][k], want[r][k], rtol=0.05,
                                       err_msg=k)
        assert got[r]["prot_break"] == 0.0 and got[r]["time"] > 0
    lines = (tmp_path / "psignn_results.csv").read_text().splitlines()
    assert lines[0] == "metric,0.6,1.0" and len(lines) == 7


def test_run_eval_cli(capsys):
    run_eval.main(["--ckpt", CKPT, "--sweep", "--radii", "0.6",
                   "--n_meshes", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["psignn"]["0.6"]["nstep"] > 0
    with pytest.raises(SystemExit):
        run_eval.main(["--ckpt", CKPT, "--device", "cpu"])


def test_config_refuses_unported_options(trained):
    _, hp, _ = trained
    # Broyden's rank-memory options are ported: they reach the solver
    for over in (dict(lowrank_bf16=True), dict(lowrank_max_rank=64)):
        deq_cfg = PsignnConfig.from_hyperparameters(hp, **over).deq
        assert all(getattr(deq_cfg, k) == v for k, v in over.items())
    with pytest.raises(ValueError):
        PsignnConfig.from_hyperparameters(hp, bc_mode="neumann")
    # the mixed variant and Broyden's line search are ported
    mixed = PsignnConfig.from_hyperparameters(hp, bc_mode="mixed", ls=True)
    assert mixed.prb_dim == 3 and mixed.deq.ls is True
    assert PsignnConfig.from_hyperparameters(hp).prb_dim == 2
    cfg = PsignnConfig.from_hyperparameters(hp)
    # every hyperparameter of the checkpoint round-trips, training knobs too
    assert dataclasses.asdict(cfg) == hp
    assert PsignnConfig.from_hyperparameters(dataclasses.asdict(cfg)) == cfg
    assert cfg.deq.fw_tol == 1e-5 and cfg.deq.fw_thres == 500
    # the adjoint solve's knobs are carried into the DEQ config
    for key in ("bw_tol", "bw_thres", "jac_vecs"):
        assert key in hp
    assert (cfg.deq.bw_tol, cfg.deq.bw_thres) == (hp["bw_tol"],
                                                  hp["bw_thres"])
    assert cfg.jac_vecs == hp["jac_vecs"]
    own = PsignnConfig(bw_tol=1e-6, bw_thres=40, jac_vecs=2)
    assert (own.deq.bw_tol, own.deq.bw_thres, own.jac_vecs) == (1e-6, 40, 2)
    assert PsignnConfig.from_hyperparameters({}, bw_thres=7).deq.bw_thres == 7


def test_seeded_init_is_reproducible():
    cfg = PsignnConfig()
    a = Psignn(cfg, generator=torch.Generator().manual_seed(3))
    b = Psignn(cfg, generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.function.layers[0].phi_to.layers[0].weight.detach()
    lim = np.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    assert float(w.abs().max()) <= lim
    assert not a.function.layers[0].phi_to.layers[0].bias.any()
