"""The harness's comparison catches a broken timed path.

Each test drives a whole run of a cell's loop on the CPU over a small
pool (the look for a card skipped), with the program broken underneath,
and sees ``correct`` come out false; a sound run comes out true.  The
faults a single-card request cell can have: a solve or step that returns
its state unchanged, a solve stopped before the configuration's stop
(looser ``fw_tol``, fewer ``fw_thres`` steps), and an answer altered where
it is produced.  (A request answers one mesh, so no half of a batch can
be left out, and one card exchanges nothing.)"""

import numpy as np
import pytest

from _small import run_small
from faults import planted

CELLS = ["psignn_dirichlet.sweep", "dsgps_dirichlet.sweep"]
TRAIN = "psignn_dirichlet.train_b50"


@pytest.mark.parametrize("cell", CELLS + [TRAIN])
def test_sound_run_is_correct(cell):
    run = run_small(cell)
    assert (run.requests or run.steps) and run.failed == 0
    assert run.correct, run.checks


def test_psignn_solve_that_returns_its_state_unchanged(monkeypatch):
    import psignn_tpu_torch.models.psignn as m
    real = m.fixed_point_forward

    def unchanged(f, h_init, graph, cfg, **kw):
        out = real(f, h_init, graph, cfg, **kw)
        return out._replace(result=h_init.detach().clone())

    monkeypatch.setattr(m, "fixed_point_forward", unchanged)
    run = run_small("psignn_dirichlet.sweep")
    assert not run.correct
    checks = run.checks["converged_residual"]
    assert checks["value"] > checks["limit"]


@pytest.mark.parametrize("change", ["fw_tol=5e-5", "fw_thres=25"])
def test_psignn_solve_stopped_early(change):
    """A looser tolerance, or fewer steps than the small pool's meshes
    need (``readings.py`` plants ``fw_thres=250`` at the cell's size on
    the card, where the large meshes need 500)."""
    with planted(change):
        run = run_small("psignn_dirichlet.sweep")
    assert run.requests and run.failed == 0
    assert not run.correct, run.checks
    checks = run.checks["converged_residual"]
    assert checks["value"] > checks["limit"]


def test_dsgps_step_that_returns_its_state_unchanged(monkeypatch):
    from psignn_tpu_torch.models.dsgps import Dsgps
    monkeypatch.setattr(Dsgps, "step", lambda self, h, h0, graph: h)
    run = run_small("dsgps_dirichlet.sweep")
    assert not run.correct


def _altered(predict, model):
    """The answer altered where it is produced: one node's u moved by a
    hundredth of the answer's largest value."""
    def predict_altered(graph):
        out = predict(graph)
        u = (out[0] if isinstance(out, tuple) else out).clone()
        u[len(u) // 2] += 0.01 * float(u.abs().max())
        return out._replace(u=u) if isinstance(out, tuple) else u
    return predict_altered


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell):
    run = run_small(cell, predictor=_altered)
    assert not run.correct
    assert np.isfinite([c["value"] for c in run.checks.values()]).all()


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "leaf_double", "fw_tol=1e-4",
                                   "fw_tol=1e-4@step2"])
def test_training_fault(fault):
    """A training step that leaves its state unchanged, trains on half of
    each batch, moves one leaf double, or stops its forward solve at a
    looser tolerance, from the first step or from the second on (which
    only ``train_residual`` can see: the judge takes the program's h*;
    from the second on, the median step's residual sees it where both
    later solves end above the limit, as they do here).  At the cell's
    size on the card ``fw_tol`` 5e-5 stops a step at 2.0e-5 to 4.9e-5
    (``test_run.py``); on this small pool Broyden's last steps
    fall further (5e-5 stopped the first step at 2.6e-5), so the CPU
    plants 1e-4, clear of the limit."""
    with planted(fault):
        run = run_small(TRAIN)
    assert run.steps and run.failed == 0
    assert not run.correct, run.checks
    if fault.startswith("fw_tol"):
        checks = run.checks["train_residual"]
        assert checks["value"] > checks["limit"]
    if fault.endswith("@step2"):
        assert run.judged[1]["residuals"][0] <= checks["limit"]


def test_one_stalled_solve_is_left_to_the_median():
    """The configured Broyden may end a sound solve above ``fw_tol``, at
    its threshold, on a plateau or by its divergence guard (on the card,
    seeds 1279946884 and 1357913577 stall the first step at 2.2e-4 and
    5.3e-5): ``train_residual``, the median step's, reads the other two
    steps, and the other numbers judge the stalled step at its own h*."""
    with planted("fw_thres=3@step1only"):
        run = run_small(TRAIN)
    limit = run.checks["train_residual"]["limit"]
    residuals = run.judged[1]["residuals"]
    assert residuals[0] > 100 * limit
    assert max(residuals[1:]) <= limit
    assert run.correct, run.checks
