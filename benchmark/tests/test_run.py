"""``run.py`` as the benchmark's command: no result without a card or
without the program, and on the card one result line per run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELLS = ["psignn_dirichlet.sweep", "dsgps_dirichlet.sweep",
         "psignn_dirichlet.train_b50"]


def _run(cwd, *args, timeout=600):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "4294967311", *args], cwd=cwd, capture_output=True,
        text=True, timeout=timeout)


def _result_lines(out):
    return [line for line in out.stdout.splitlines()
            if line.startswith("{")]


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT, "--seconds", "1")
    assert out.returncode == 2 and not _result_lines(out), out.stderr


def test_benchmark_alone_is_no_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(tmp_path, "--seconds", "1")
    assert out.returncode != 0 and not _result_lines(out), out.stderr


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(cuda, cell, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "4294967311", "--seconds", "3", "--trace", trace], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    if trace == "1":
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cuda, cell):
    from control import readings
    from benchmark.benchlib.spec import load_cell
    checks = readings(load_cell(cell), cuda)
    assert any(not c["value"] <= c["limit"] for c in checks.values()), checks


@pytest.mark.chip
@pytest.mark.parametrize("change", ["fw_tol=5e-5", "fw_thres=250"])
def test_stop_changed_fails_at_the_cells_size(cuda, change):
    """The program solving to a looser tolerance, or stopping the large
    meshes' solves at half their steps, is not correct."""
    import time
    from faults import planted
    from benchmark.benchlib import sweep
    from benchmark.benchlib.spec import load_cell
    with planted(change):
        run = sweep.run(load_cell(CELLS[0]), 2718281829, 4.0, False,
                        str(cuda), time.perf_counter())
    assert run.requests and run.failed == 0
    assert not run.correct, run.checks


@pytest.mark.chip
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "leaf_double", "fw_tol=5e-5",
                                   "fw_thres=10@step2"])
def test_training_fault_fails_at_the_cells_size(cuda, fault):
    """Each fault a training step can have, its forward solve stopped at
    a looser tolerance, and its solves cut short from the second step on
    (steps 2 and 3 need 16 to 393 f_θ calls), is not correct at the
    cell's size.  (``fw_tol=5e-5@step2`` is not among them: its step-2
    solve may end under ``fw_tol`` all the same, and the median step's
    residual then sees one step of three.)"""
    import time
    from faults import planted
    from benchmark.benchlib import train
    from benchmark.benchlib.spec import load_cell
    with planted(fault):
        run = train.run(load_cell(CELLS[2]), 2718281829, 2.0, False,
                        str(cuda), time.perf_counter())
    assert run.steps and run.failed == 0
    assert not run.correct, run.checks


@pytest.mark.chip
def test_a_first_solve_that_stalls_is_sound_at_the_cells_size(cuda):
    """On seed 1279946884 the program's first solve, from the checkpoint,
    stalls at 2.2e-4 (its best iterate at step 73): the configured
    Broyden's own stop, one step of three, and the run is correct."""
    import time
    from benchmark.benchlib import train
    from benchmark.benchlib.spec import load_cell
    run = train.run(load_cell(CELLS[2]), 1279946884, 2.0, False,
                    str(cuda), time.perf_counter())
    limit = run.checks["train_residual"]["limit"]
    assert run.judged[1]["residuals"][0] > 10 * limit
    assert run.correct, run.checks
