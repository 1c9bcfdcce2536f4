"""The comparisons of the mixed sweep and the data-parallel training cell
catch a broken timed path: whole runs of each cell's loop on the CPU over
small pools, with the program broken underneath (``faults_mixed_dp``),
come out not correct; sound runs come out correct.  The data-parallel
runs share one spawn of four gloo ranks."""

import time

import pytest

from _small_mixed_dp import run_small, small_cell
from faults_mixed_dp import DP, MIXED, planted
from readings_mixed_dp import dp_runs, failure

MIXED_CELL = "psignn_mixed.sweep"
DP_CELL = "psignn_dirichlet.train_dp4"


def test_sound_mixed_run_is_correct():
    run = run_small(MIXED_CELL)
    assert run.requests and run.failed == 0
    assert all(r.fw_launches == 0 and r.f_calls > 0 for r in run.requests)
    assert run.correct, run.checks


@pytest.mark.parametrize("fault", MIXED)
def test_mixed_fault(fault):
    with planted(fault):
        run = run_small(MIXED_CELL)
    assert run.requests and run.failed == 0
    assert not run.correct, run.checks
    c = run.checks["converged_residual"]
    assert c["value"] > c["limit"]


@pytest.fixture(scope="module")
def dp_readings():
    faults = [f for f in DP if f != "rank_dies"]
    return dp_runs(small_cell(DP_CELL), [1234567890123], faults,
                   [1234567890123], 0.5, "cpu")


def test_sound_dp_run_is_correct(dp_readings):
    (row,) = dp_readings["sound"]
    assert row["steps"] and row["failed"] == 0
    assert row["correct"], row["checks"]


@pytest.mark.parametrize("fault", ["rank_grad_not_reduced", "loss_summed"])
def test_dp_fault(dp_readings, fault):
    (row,) = dp_readings["faults"][fault]
    assert not row["correct"], row["checks"]


def test_a_rank_that_fails_ends_the_run():
    """A rank that raises ends every rank: the run raises within seconds,
    long before the process group's timeout."""
    from benchmark.benchlib import train_dp
    t0 = time.perf_counter()
    got = failure(small_cell(DP_CELL), 0.5, "cpu")
    assert got["raised"], got
    assert got["seconds"] < train_dp.PG_TIMEOUT_S / 2
    assert time.perf_counter() - t0 < train_dp.PG_TIMEOUT_S / 2
