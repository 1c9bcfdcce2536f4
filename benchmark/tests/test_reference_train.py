"""The plain reference's training step against the program's CPU path,
on a small batch.

``solve_steps`` (the reference solving its own fixed points, as the
control runs it): both sides solve to 1e-7 here.  At the configuration's
1e-5 the first gradient depends on where each Broyden path happens to
stop: on one batch of this pool the program's gradient leaves lie up to
30 % (and the encoder's first bias 7x) from the reference's, while at
1e-7 both agree to 1e-4.  That is why the judge (``judge_steps``) takes
the program's own h* of each step and solves no forward fixed point."""

import os

import numpy as np
import pytest
import torch

from benchmark.benchlib import gen, pool, train
from benchmark.benchlib.train import leaf_name as _leaf
from benchmark.benchlib.spec import ROOT, load_cell
from benchmark.reference import psignn
from benchmark.reference.common import read_checkpoint

SEED = 11


def _batch():
    rng = pool._rng(0)
    mesh = gen.blob_mesh(0.6, 0.08, rng)
    return [gen.psignn_sample_from_fem(gen.solve_poisson(mesh, 0.6, rng))
            for _ in range(2)]


def _generator():
    g = torch.Generator()
    g.manual_seed(SEED)
    return g


@pytest.mark.parametrize("steps", [1, 2])
def test_train_steps_match_program(steps):
    from psignn_tpu_torch.eval.run_eval import load_predictor
    from psignn_tpu_torch.graphs import batch_graphs
    from psignn_tpu_torch.train.optim import make_optimizers
    from psignn_tpu_torch.train.step import train_step
    config = load_cell("psignn_dirichlet.sweep").config
    tight = dict(config["model"], fw_tol=1e-7, fw_thres=2000)
    tcfg = config["train"]
    samples = _batch()

    _, _, cfg, model = load_predictor(
        os.path.join(ROOT, config["checkpoint"]), "cpu",
        {"fw_tol": 1e-7, "fw_thres": 2000})
    opts = make_optimizers(model, tcfg["lr_deq"], tcfg["lr_ae"])
    graph = batch_graphs(samples, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen_p = _generator()
    losses = []
    for t in range(steps):
        losses.append(train_step(model, opts, graph, cfg,
                                 (tcfg["lr_deq"], tcfg["lr_ae"]),
                                 tcfg["gradient_clip"], tcfg["jac_weight"],
                                 gen_p).loss)
        if t == 0:
            state = {p: s for o in opts for p, s in o.state.items()}
            grad = {_leaf(n): state[p]["exp_avg"] / 0.1
                    for n, p in model.named_parameters()}
    change = {_leaf(n): p.detach() - before[n]
              for n, p in model.named_parameters()}

    ref = psignn.Model(read_checkpoint(os.path.join(
        ROOT, config["checkpoint"]))["params"], "cpu")
    gen_r = _generator()
    out = psignn.solve_steps(
        ref, [psignn.Batch(samples, "cpu")] * steps,
        lambda _t, shape: torch.randn(shape, generator=gen_r), tight, tcfg)
    r_losses, r_grad, r_before, r_after = (out["losses"], out["grad"],
                                           out["before"], out["after"])
    assert max(out["residuals"]) < 1e-7

    np.testing.assert_allclose(losses, r_losses, rtol=1e-4)
    g_med = np.median([float(v.norm()) for v in r_grad.values()])
    for k, v in r_grad.items():
        assert abs(float(grad[k].norm()) - float(v.norm())) <= \
            1e-3 * max(float(v.norm()), g_med), k
    for k in r_after:
        ref_change = float((r_after[k] - r_before[k]).norm())
        assert abs(float(change[k].norm()) - ref_change) <= \
            2e-2 * max(ref_change, 1e-3), k


def _judged_run(monkeypatch):
    """A small sound training run, and the arguments its judge got."""
    from _small import run_small
    calls = []
    real = train.judge

    def recording(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(train, "judge", recording)
    run = run_small("psignn_dirichlet.train_b50")
    assert len(calls) == 1
    return run, calls[0]


def test_judge_at_the_programs_equilibrium(monkeypatch):
    """At the program's own h* both sides' first losses agree to f32
    rounding, and the residual the judge measures is the solve's own."""
    run, _ = _judged_run(monkeypatch)
    fw_tol = run.config["model"]["fw_tol"]
    assert run.correct, run.checks
    assert run.checks["first_loss_gap"]["value"] <= 1e-5
    assert run.checks["train_residual"]["value"] <= 1.5 * fw_tol
    assert run.checks["grad_gap"]["value"] <= 1e-2
    assert run.checks["change_gap"]["value"] <= 1e-2


def test_judge_solves_no_forward_fixed_point(monkeypatch):
    """Every Broyden solve of the judge is an adjoint's, at ``bw_tol``."""
    eps = []
    real = psignn.broyden

    def counted(g, x0, threshold, tol):
        eps.append(tol)
        return real(g, x0, threshold, tol)

    monkeypatch.setattr(psignn, "broyden", counted)
    run, _ = _judged_run(monkeypatch)
    assert eps and set(eps) == {run.config["model"]["bw_tol"]}


def test_a_stalling_forward_solve_leaves_the_verdict(monkeypatch):
    """A reference whose forward Broyden stops after 3 steps judges the
    run exactly as before: the judge solves no forward fixed point, while
    the same stall in a reference that solves is far from converged."""
    run, args = _judged_run(monkeypatch)
    ref, config, batches, side, seed, dev = args[:6]
    stalled = dict(config, model=dict(config["model"], fw_thres=3))
    assert train.judge(ref, stalled, batches, side, seed, dev) == \
        run.judged[0]
    own = train.reference_side(ref, stalled, batches[:1], seed, dev)
    assert own["residuals"][0] > 10 * config["limits"]["train_residual"]


@pytest.mark.chip
def test_judge_repeats_bit_for_bit_on_the_card(cuda, monkeypatch):
    """At the cell's size on the card, the judge run once more on the
    same program steps gives the same numbers, bit for bit."""
    import time
    calls = []
    real = train.judge

    def recording(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(train, "judge", recording)
    run = train.run(load_cell("psignn_dirichlet.train_b50"), 1121308703, 2.0,
                    False, str(cuda), time.perf_counter())
    assert run.correct, run.checks
    assert real(*calls[0]) == run.judged[0]
