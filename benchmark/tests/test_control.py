"""The control (the reference in TF32 in the program's place) comes out
as not correct, here over a small pool on the CPU (a training cell: over
its first steps); ``control.py`` runs it at the cell's size on the
card."""

import pytest

from _small import small_cell
from control import readings


@pytest.mark.parametrize("cell", ["psignn_dirichlet.sweep",
                                  "dsgps_dirichlet.sweep",
                                  "psignn_dirichlet.train_b50"])
def test_control_fails_a_limit(cell):
    checks = readings(small_cell(cell), "cpu")
    assert any(not c["value"] <= c["limit"] for c in checks.values()), checks
