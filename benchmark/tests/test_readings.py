"""Each limit of each cell was set from recorded readings
(``readings.RECORDED``) and lies above the sound runs' largest reading
and below the smallest reading of the control and of each fault the
number is held against."""

import pytest

from readings import RECORDED

from benchmark.benchlib.spec import load_cell

CELLS = ["psignn_dirichlet.sweep", "dsgps_dirichlet.sweep",
         "psignn_dirichlet.train_b50"]


def _numbers(cell):
    """The numbers a cell compares: its reference's."""
    from _small import run_small
    return set(run_small(cell).checks)


@pytest.mark.parametrize("cell", CELLS)
def test_every_limit_has_its_readings(cell):
    limits = load_cell(cell).config["limits"]
    assert set(RECORDED[cell]) == _numbers(cell)
    for name, r in RECORDED[cell].items():
        assert r["limit"] == limits[name], name
        upper = min([r["control"], *r["faults"].values()])
        assert r["sound"] < r["limit"] < upper, name
        assert r["seeds"] >= 12, name
