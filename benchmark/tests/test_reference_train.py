"""The plain reference's training step against the program's CPU path,
on a small batch.

Both sides solve the forward fixed point to 1e-7 here.  At the
configuration's 1e-5 the first gradient depends on where each Broyden
path happens to stop: on one batch of this pool the program's gradient
leaves lie up to 30 % (and the encoder's first bias 7x) from the
reference's, while at 1e-7 both agree to 1e-4."""

import os

import numpy as np
import pytest
import torch

from benchmark.benchlib import gen, pool
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
    r_losses, r_grad, r_before, r_after = psignn.train_steps(
        ref, [psignn.Batch(samples, "cpu")] * steps,
        lambda _t, shape: torch.randn(shape, generator=gen_r), tight, tcfg)

    np.testing.assert_allclose(losses, r_losses, rtol=1e-4)
    g_med = np.median([float(v.norm()) for v in r_grad.values()])
    for k, v in r_grad.items():
        assert abs(float(grad[k].norm()) - float(v.norm())) <= \
            1e-3 * max(float(v.norm()), g_med), k
    for k in r_after:
        ref_change = float((r_after[k] - r_before[k]).norm())
        assert abs(float(change[k].norm()) - ref_change) <= \
            2e-2 * max(ref_change, 1e-3), k
