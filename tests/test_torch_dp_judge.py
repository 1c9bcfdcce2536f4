"""The data-parallel training cell's judge (``benchmark/benchlib/
train_dp.py``, ``benchmark/reference/psignn_dp.py``) on four gloo ranks
on the CPU, at a small size: the program's data-parallel steps (each
rank's shard, one all-reduce of the gradients and losses, the same clip
and Adams on every rank) against the reference's, which deals the same
shards, takes each rank's own h* and combines the ranks' losses and
gradients as ``dist.dp.dp_value_and_grad`` does."""

import time

import numpy as np
import pytest
import torch

from benchmark.benchlib import counted, spec, train_dp
from benchmark.reference import psignn, psignn_dp
from benchmark.reference.common import read_checkpoint

SMALL = dict(radii=[0.6], meshes_per_radius=6, rhs_per_mesh=2, batch_size=4)
CKPT = "results/psignn_dirichlet/ckpt/best_model.ckpt"


@pytest.fixture(scope="module")
def dp_run():
    cell = spec.load_cell("psignn_dirichlet.train_dp4")
    cell.traffic = dict(cell.traffic, **SMALL)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cell, train_dp.run(cell, 4000000011, 0.5, False, "cpu",
                                  time.perf_counter())
    finally:
        torch.set_num_threads(n)


def test_four_ranks_match_the_reference_at_their_own_h_star(dp_run):
    """The first loss, the first clipped gradient and the change after
    three steps agree with the reference's data-parallel steps to f32
    round-off, and every rank's h* is a fixed point within the solve's
    tolerance."""
    cell, run = dp_run
    assert run.steps and run.failed == 0 and run.correct, run.checks
    nums = {k: c["value"] for k, c in run.checks.items()}
    assert nums["first_loss_gap"] < 1e-5, nums
    assert nums["grad_gap"] < 1e-3 and nums["change_gap"] < 1e-3, nums
    assert nums["train_residual"] < 1.5 * cell.config["model"]["fw_tol"]
    assert len(run.judged[1]["losses"]) == train_dp.JUDGED_STEPS


def test_every_rank_counts_its_evaluations(dp_run):
    """Each rank counted f_θ evaluations in every window step; the spread
    metric reads their imbalance, and no traced slice means no all-reduce
    reading."""
    _, run = dp_run
    assert len(run.rank_f_calls) == 4
    assert all(len(c) == len(run.steps) and min(c) > 1
               for c in run.rank_f_calls)
    assert counted.f_calls_spread_per_step(run) >= 0
    assert counted.allreduce_ms_per_step(run) is None


def test_shards_are_dealt_as_the_programs_loader_deals_them():
    """``psignn_dp.deal`` gives each rank the samples the program's
    ``shard_samples`` gives it, the empty pads left out."""
    from psignn_tpu_torch.data.reader import shard_samples
    batch = [{"x": np.full((k + 2, 1), k, np.float32)} for k in range(10)]
    for ranks in (1, 3, 4):
        want = shard_samples(batch, 10, ranks)
        got = psignn_dp.deal(batch, 10, ranks)
        assert [[int(s["x"][0, 0]) for s in shard] for shard in got] == \
            [[int(s["x"][0, 0]) for s in shard if len(s["x"])]
             for shard in want]


def test_one_rank_is_the_single_card_reference():
    """Dealt over one rank, the data-parallel steps are the single-card
    reference's steps (``psignn.judge_steps``) at the same h*: the same
    losses, first gradient and change."""
    from benchmark.benchlib import pool
    tr = dict(radii=[0.6], meshes_per_radius=2, rhs_per_mesh=1, hsize=0.08,
              pool_seed=0)
    samples = [s["sample"] for s in pool.mesh_pool(tr)]
    params = read_checkpoint(CKPT)["params"]
    cfg = dict(fw_tol=1e-5, fw_thres=500, bw_tol=1e-8, bw_thres=60)
    tcfg = dict(jac_weight=1.0, gradient_clip=0.1, lr_deq=0.01, lr_ae=0.05)
    batches = [samples, samples[::-1]]
    shards = [psignn_dp.Shards(psignn_dp.deal(b, 2, 1), "cpu")
              for b in batches]

    def probes():
        g = torch.Generator().manual_seed(3)
        return lambda _t, shape: torch.randn(shape, generator=g)

    solved = psignn_dp.solve_dp_steps(psignn.Model(params, "cpu"), shards,
                                      [probes()], cfg, tcfg)
    h_stars = [zs[0] for zs in solved["h_stars"]]
    single = psignn.judge_steps(psignn.Model(params, "cpu"),
                                [s.whole for s in shards], h_stars,
                                solved["starts"], probes(), cfg, tcfg)
    dp = psignn_dp.judge_dp_steps(psignn.Model(params, "cpu"), shards,
                                  solved["h_stars"], solved["starts"],
                                  [probes()], cfg, tcfg)
    np.testing.assert_allclose(dp["losses"], single["losses"], rtol=1e-6)
    for key in ("grad", "after"):
        for leaf, v in single[key].items():
            np.testing.assert_allclose(dp[key][leaf].detach().numpy(),
                                       v.detach().numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=leaf)
