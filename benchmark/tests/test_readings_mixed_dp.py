"""Each limit of the mixed sweep and of the data-parallel training cell
was set from recorded readings (``readings_mixed_dp.RECORDED``) and lies
above the sound runs' largest reading and below the smallest reading of
the control and of each fault the number is held against."""

import pytest

from readings_mixed_dp import RECORDED

from benchmark.benchlib.spec import load_cell

CELLS = ["psignn_mixed.sweep", "psignn_dirichlet.train_dp4"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_limit_has_its_readings(cell):
    from _small_mixed_dp import run_small
    limits = load_cell(cell).config["limits"]
    assert set(RECORDED[cell]) == set(run_small(cell).checks)
    for name, r in RECORDED[cell].items():
        assert r["limit"] == limits[name], name
        upper = min([r["control"], *r["faults"].values()])
        assert r["sound"] < r["limit"] < upper, name
        assert r["seeds"] >= 12, name
