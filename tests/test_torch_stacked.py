"""Per-graph DEQ solves over one concatenated batch (``--stacked_batch``):
the solvers' lanes, ``psignn_forward_stacked``, the stacked loader and
train step, and the CLI's newly accepted flags, against the JAX package
(``psignn_forward_stacked``, ``GraphLoader(stacked=True)``) on the CPU.

Lanes against separate solves of each lane: the same arithmetic but for
the summation order of the per-lane products and norms (batched matmuls,
row sums): the same steps, residual traces within 1e-3 (1e-7 absolute,
near eps), best residuals within 5 % (they sit at eps, where f32 order
moves them), iterates within 1e-6.  Against JAX at
reachable tolerances (fw 1e-4, bw 1e-6), as ``test_torch_train.py``: the
same per-graph steps, losses within 1e-3, each parameter's gradient within
1e-2 as a relative norm (each package solves its own fixed point here;
``test_torch_train.py`` shares h* and holds 1e-3)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import fem_sample, grad_rel, kernel_route, load_trained
from psignn_tpu import deq as jdeq
from psignn_tpu.data.reader import GraphLoader as JaxGraphLoader
from psignn_tpu.models import PsignnConfig as JaxPsignnConfig
from psignn_tpu.models.psignn import psignn_forward_stacked as jax_stacked
from psignn_tpu.models.psignn import stack_single_graphs
from psignn_tpu_torch import deq, solvers
from psignn_tpu_torch.cli.main import main
from psignn_tpu_torch.data.generate import generate_data
from psignn_tpu_torch.data.reader import GraphLoader
from psignn_tpu_torch.graphs import batch_graphs
from psignn_tpu_torch.models import PsignnConfig, psignn_forward_stacked
from psignn_tpu_torch.train import (TrainConfig, Trainer, load_checkpoint,
                                    make_optimizers, train_step)
from psignn_tpu_torch.weights import params_from_jax, psignn_from_jax

REACHABLE = dict(fw_tol=1e-4, fw_thres=200, bw_tol=1e-6, bw_thres=300)
LOSSES = ("residual_loss", "jacobian_loss", "encoder_loss",
          "autoencoder_loss", "mse_loss", "mse_dirichlet", "fw_lowest",
          "fw_nstep", "sradius")

# ---------------------------------------------------------------- lanes

COUNTS = (5, 9, 7)
D = 3


def block_problem(kind: str):
    """(f on the concatenated state, [f of each lane alone]): lane g is
    tanh(M_g x + c_g) with its own contraction; for ``overshoot`` lane 0
    is instead the overshooting map of tests/test_solvers.py's line-search
    test, g(x) = −3.5(x − 0.3) − 0.2 sin(x − 0.3)."""
    rng = np.random.default_rng(0)
    fs = []
    for g, n in enumerate(COUNTS):
        if kind == "overshoot" and g == 0:
            fs.append(lambda x: x - 3.5 * (x - 0.3)
                      - 0.2 * torch.sin(x - 0.3))
            continue
        M = rng.normal(size=(n * D, n * D)).astype(np.float32)
        M *= (0.5, 0.9, 0.7)[g] / max(abs(np.linalg.eigvals(M)))
        M, c = torch.from_numpy(M), torch.from_numpy(
            rng.normal(size=(n * D,)).astype(np.float32))
        fs.append(lambda x, M=M, c=c: torch.tanh(
            M @ x.reshape(-1) + c).reshape(-1, D))
    off = np.concatenate([[0], np.cumsum(COUNTS)])

    def f_all(x):
        return torch.cat([f(x[off[g]:off[g + 1]]) for g, f in enumerate(fs)])
    return f_all, fs, off


LANE_CASES = {
    "broyden": ("broyden", {}, "tanh"),
    "broyden_ring": ("broyden", dict(max_rank=4), "tanh"),
    "broyden_bf16": ("broyden", dict(lowrank_dtype=torch.bfloat16), "tanh"),
    "broyden_ls": ("broyden", dict(ls=True), "overshoot"),
    "anderson": ("anderson", {}, "tanh"),
    "picard": ("picard", {}, "tanh"),
}


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_lanes_match_separate_solves(case, monkeypatch):
    """Each lane of one laned solve against the same solver on that lane
    alone: every lane stops at its own step (they differ), keeps its own
    best iterate, traces (padded with its own lowest), and divergence
    flag; Broyden's ring (block 4, cap 4) wraps in every lane, and with
    the line search each lane searches with its own step length."""
    monkeypatch.setattr(solvers, "_LR_BLOCK", 4)
    name, kw, kind = LANE_CASES[case]
    f_all, fs, off = block_problem(kind)
    x0 = torch.zeros(off[-1], D)
    lanes = solvers.Lanes(torch.from_numpy(np.repeat(np.arange(3), COUNTS)),
                          COUNTS)
    solver = getattr(solvers, name)
    got = solver(f_all, x0, threshold=100, eps=1e-6, lanes=lanes, **kw)
    calls = []
    for g, f in enumerate(fs):
        one = solver(f, x0[off[g]:off[g + 1]], threshold=100, eps=1e-6, **kw)
        calls.append(one.calls)
        assert (got.nstep[g], got.trace_len[g]) == (one.nstep, one.trace_len)
        assert got.prot_break[g] == one.prot_break
        np.testing.assert_allclose(got.lowest[g], one.lowest, rtol=5e-2)
        np.testing.assert_allclose(got.result[off[g]:off[g + 1]].numpy(),
                                   one.result.numpy(), rtol=0, atol=1e-6)
        for k in ("rel_trace", "abs_trace"):
            np.testing.assert_allclose(getattr(got, k).numpy()[:, g],
                                       getattr(one, k).numpy(), rtol=1e-3,
                                       atol=1e-7, err_msg=k)
    assert len(set(got.trace_len.tolist())) > 1
    if case == "broyden_ring":
        assert got.trace_len.min() - 1 > 4
    if case == "broyden_ls":      # lane 0 backtracked, the others did not
        assert calls[0] > got.trace_len[0] and calls[1] == got.trace_len[1]
        assert got.calls >= max(calls)
    else:       # f runs once per iteration of the slowest lane
        assert got.calls == max(calls)


def test_lanes_pad_unpad_and_segment_sums():
    counts = (2, 4, 1)
    lanes = solvers.Lanes(torch.tensor([0, 0, 1, 1, 1, 1, 2]), counts)
    x = torch.arange(14.0).reshape(7, 2)
    xp = lanes.pad(x)
    assert xp.shape == (3, 8)
    np.testing.assert_array_equal(xp[2].numpy(), [12, 13, 0, 0, 0, 0, 0, 0])
    assert torch.equal(lanes.unpad(xp, x.shape), x)
    np.testing.assert_array_equal(
        lanes.segment_sum(x.sum(1)).numpy(), [1 + 5, 9 + 13 + 17 + 21, 25])
    with pytest.raises(NotImplementedError, match="keep_trace"):
        solvers.picard(lambda h: h, x, lanes=lanes, keep_trace=True)


def test_lane_power_method_and_jacobian_loss():
    """On h ↦ h·W_g, one W_g per lane, the per-lane power method finds
    each block's spectral radius, and the per-lane Hutchinson loss each
    lane's ‖vᵀJ_g‖² over its own N_g·D."""
    counts = (3, 5)
    lanes = solvers.Lanes(torch.tensor([0] * 3 + [1] * 5), counts)
    rng = np.random.default_rng(1)
    Ws = [torch.from_numpy((rng.normal(size=(4, 4)) * s).astype(np.float32))
          for s in (0.3, 0.8)]
    rows = lanes.row_lane

    def f(h, h0, graph):
        return torch.where(rows[:, None] == 0, h @ Ws[0], h @ Ws[1])

    h = torch.zeros(8, 4)
    gen = torch.Generator().manual_seed(0)
    sr = deq.power_method(f, h, h, None, gen, n_iters=300, lanes=lanes)
    want = [max(abs(np.linalg.eigvals(W.numpy()))) for W in Ws]
    np.testing.assert_allclose(sr.numpy(), want, rtol=1e-3)
    v = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    jac = deq.jac_loss_probe(f, h, h, None, v, deq.lane_sizes(h, lanes),
                             lanes)
    vj = torch.cat([v[:3] @ Ws[0].T, v[3:] @ Ws[1].T])
    np.testing.assert_allclose(
        jac.detach().numpy(),
        [float((vj[:3] ** 2).sum()) / 12, float((vj[3:] ** 2).sum()) / 20],
        rtol=1e-5)

# ------------------------------------------------------- stacked forward


def probe(pos, xp):
    """A Hutchinson probe both packages compute from node positions, so
    that every graph gets the same one on either side: sin(37x + 11y + j)
    for column j."""
    cols = xp.arange(10, dtype=pos.dtype)
    return xp.sin(37.0 * pos[:, :1] + 11.0 * pos[:, 1:2] + cols[None, :])


@pytest.fixture(scope="module")
def trained():
    return load_trained()


def _jax_stacked_step(params, hp, samples):
    """JAX's stacked forward and gradient on ``samples`` with the
    position probe: (loss dict, per-parameter gradients as a port state
    dict)."""
    jcfg = JaxPsignnConfig(**{**hp, **REACHABLE})
    jg = stack_single_graphs(samples)
    real = jdeq.jac_loss_estimate
    jdeq.jac_loss_estimate = (
        lambda f, p, hs, hi, g, rng, vecs=1, denom=None: jdeq.jac_loss_probe(
            f, p, hs, hi, g, probe(g.pos, jnp), denom))
    try:
        def loss(p):
            out = jax_stacked(p, jg, jcfg, jax.random.PRNGKey(0))
            l = out.losses
            return (l["residual_loss"] + l["jacobian_loss"]
                    + l["encoder_loss"] + l["autoencoder_loss"]), l
        (_, losses), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    finally:
        jdeq.jac_loss_estimate = real
    return ({k: np.asarray(v) for k, v in losses.items()},
            params_from_jax(grads))


def _port_stacked_step(params, hp, samples, monkeypatch):
    cfg = PsignnConfig.from_hyperparameters(hp, **REACHABLE)
    monkeypatch.setattr(
        deq, "jac_loss_estimate",
        lambda f, hs, hi, g, gen, vecs=1, denom=None, lanes=None:
        deq.jac_loss_probe(f, hs, hi, g, probe(g.pos, torch), denom, lanes))
    model = psignn_from_jax(params, cfg, "cpu")
    out = psignn_forward_stacked(model, batch_graphs(samples, device="cpu"),
                                 cfg, torch.Generator().manual_seed(0))
    sum(out.losses[k] for k in ("residual_loss", "jacobian_loss",
                                "encoder_loss", "autoencoder_loss")
        ).backward()
    return out, {n: p.grad for n, p in model.named_parameters()}


def _assert_matches_jax(out, grads, jl, jgrads):
    np.testing.assert_array_equal(out.losses["fw_nstep_per_graph"].numpy(),
                                  jl["fw_nstep_per_graph"])
    np.testing.assert_array_equal(out.fw.nstep, jl["fw_nstep_per_graph"])
    for k in LOSSES:
        np.testing.assert_allclose(float(out.losses[k].detach()),
                                   float(jl[k]), rtol=1e-3, atol=1e-8,
                                   err_msg=k)
    for name, g in grads.items():
        assert grad_rel(g.numpy(), jgrads[name].numpy()) < 1e-2, name


def test_stacked_forward_matches_jax(trained, monkeypatch):
    """Three small meshes of different sizes: each graph's own fixed point
    and adjoint, per-graph losses averaged over the graphs, and the
    parameter gradients, against JAX's vmapped ``psignn_forward_stacked``.
    The graphs stop at different steps, and the result is not the joint
    solve's."""
    params, hp = trained
    samples = [fem_sample(s, hsize=0.25) for s in (0, 1, 2)]
    jl, jgrads = _jax_stacked_step(params, hp, samples)
    out, grads = _port_stacked_step(params, hp, samples, monkeypatch)
    _assert_matches_jax(out, grads, jl, jgrads)
    assert len(set(out.fw.nstep.tolist())) > 1
    assert len(out.adjoint.stats.nstep) == 3
    assert out.adjoint.stats.lowest.max() < REACHABLE["bw_tol"]


@pytest.fixture(scope="module")
def five_samples():
    return [fem_sample(s, hsize=0.3) for s in range(10, 15)]


def test_stacked_loader_matches_jax(five_samples):
    """Five samples in batches of 3 over two shuffled epochs: each batch
    holds JAX's stacked batch's graphs in its order, the short last batch
    filled up to 3 graphs with its own samples."""
    ours = GraphLoader(five_samples, batch_size=3, shuffle=True, seed=4,
                       device="cpu", stacked=True)
    theirs = JaxGraphLoader(five_samples, batch_size=3, shuffle=True,
                            seed=4, stacked=True)
    for _ in range(2):
        batches = list(zip(ours, theirs))
        assert len(batches) == 2
        for g, jg in batches:
            n = np.asarray(jg.n_nodes)[:, 0]
            np.testing.assert_array_equal(g.n_nodes.numpy(), n)
            for i in range(3):
                np.testing.assert_array_equal(
                    g.sol[g.graph_id == i].numpy(),
                    np.asarray(jg.sol)[i, :n[i]])
    last = ours.batch_order(0)[-1]
    assert len(last) == 3 and last[2] == last[0]


def test_padded_last_batch_matches_jax(trained, five_samples, monkeypatch):
    """The short last batch of ``test_stacked_loader_matches_jax``'s
    loader (2 samples, the first repeated to make 3) through both stacked
    forwards: the duplicate counts twice in each mean, as in JAX."""
    params, hp = trained
    last = GraphLoader(five_samples, batch_size=3, shuffle=True, seed=4,
                       device="cpu", stacked=True).batch_order(0)[-1]
    samples = [five_samples[i] for i in last]
    jl, jgrads = _jax_stacked_step(params, hp, samples)
    out, grads = _port_stacked_step(params, hp, samples, monkeypatch)
    _assert_matches_jax(out, grads, jl, jgrads)
    assert out.fw.nstep[0] == out.fw.nstep[2]


def test_stacked_train_step_kernel_route(trained, monkeypatch):
    """A stacked train step on the CUDA route's wiring launches the kernels
    as ``chip_smoke.expected_launches`` counts them: f_θ runs on the whole
    batch once per iteration of the slowest graph."""
    params, hp = trained
    cfg = PsignnConfig.from_hyperparameters(hp, **REACHABLE)
    graph = batch_graphs([fem_sample(s, hsize=0.3) for s in (3, 4)],
                         device="cpu")
    fm = kernel_route(monkeypatch)
    model = psignn_from_jax(params, cfg, "cpu")
    res = train_step(model, make_optimizers(model, 0.01, 0.05), graph, cfg,
                     (0.01, 0.05), 0.1, 1.0, torch.Generator().manual_seed(1),
                     stacked=True)
    assert (fm.LAUNCHES, fm.BWD_LAUNCHES) == \
        chip_smoke.expected_launches(res, cfg)
    assert res.fw.calls == max(res.fw.nstep) + 1 or \
        res.fw.calls > max(res.fw.nstep)
    assert "fw_nstep_per_graph" not in res.losses
    assert np.isfinite(res.loss) and res.bw.nstep.shape == (2,)

# ------------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data"))
    generate_data(path, n_mesh=2, n_samples=5, hsize=0.25, seed=21,
                  verbose=False)
    return path


FAST_FLAGS = ["--fw_tol", "1e-3", "--fw_thres", "25", "--bw_tol", "1e-5",
              "--bw_thres", "25", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--stacked_batch"], ["--stacked_batch", "--solver", "anderson"],
    ["--stacked_batch", "--solver", "picard"],
    ["--stacked_batch", "--broyden_ls"],
    ["--stacked_batch", "--lowrank_max_rank", "8", "--lowrank_bf16"],
    ["--lowrank_bf16"], ["--lowrank_max_rank", "8"],
    ["--precision", "bfloat16"]], ids=lambda f: "_".join(f).strip("-"))
def test_cli_trains_with_the_new_flags(tmp_path, data_dir, capsys, flags):
    """One epoch (6 train samples in batches of 4: two steps, the second
    padded when stacked) with each newly accepted flag: one iteration-log
    line per step and solve, finite losses, the flags in the checkpoint's
    hyperparameters and configuration."""
    out = str(tmp_path / "run")
    main(["--path_dataset", data_dir, "--path_results", out,
          "--max_epochs", "1", "--batch_size", "4", "--val_sradius",
          "1" if flags == ["--stacked_batch"] else "0", *FAST_FLAGS, *flags])
    assert "Training finished" in capsys.readouterr().out
    logs = os.path.join(out, "logs")
    for name in ("forward_iteration.csv", "backward_iteration.csv"):
        with open(os.path.join(logs, name)) as f:
            assert len(f.read().strip().splitlines()) == 3, name
    ck = load_checkpoint(os.path.join(out, "ckpt", "final_model.ckpt"))
    hp = ck["hyperparameters"]
    assert hp["lowrank_bf16"] is ("--lowrank_bf16" in flags)
    assert hp["lowrank_max_rank"] == (8 if "--lowrank_max_rank" in flags
                                      else 0)
    assert all(np.isfinite(v) for v in ck["hist_train"]["loss"]
                                        + ck["hist_val"]["loss"])
    conf = open(os.path.join(logs, "model_config.csv")).read()
    assert f"'stacked_batch':'{'--stacked_batch' in flags}'" in conf


def test_trainer_refuses_stacked_unrolled_families(tmp_path, data_dir):
    from psignn_tpu_torch.data.reader import load_dataset, split_dataset
    train, val, _ = split_dataset(load_dataset(data_dir))
    loaders = [GraphLoader(s, batch_size=3, device="cpu", stacked=True)
               for s in (train, val)]
    with pytest.raises(ValueError, match="stacked_batch"):
        Trainer(TrainConfig(family="dsgps", stacked_batch=True,
                            path_results=str(tmp_path), device="cpu"),
                *loaders)
