"""The control (the reference in TF32 in the program's place) comes out
as not correct in the mixed sweep and the data-parallel training cell,
here over small pools on the CPU; ``control_mixed_dp.py`` runs it at the
cells' size on the card."""

import pytest

from _small_mixed_dp import small_cell
from control_mixed_dp import readings


@pytest.mark.parametrize("cell", ["psignn_mixed.sweep",
                                  "psignn_dirichlet.train_dp4"])
def test_control_fails_a_limit(cell):
    checks = readings(small_cell(cell), "cpu")
    assert any(not c["value"] <= c["limit"] for c in checks.values()), checks
