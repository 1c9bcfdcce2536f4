"""A cell of BENCHMARK.json cut to a pool the CPU runs in seconds."""

import time

from benchmark.benchlib import spec, sweep

SMALL = {"sweep": dict(radii=[0.6, 1.0], meshes_per_radius=1),
         "train": dict(radii=[0.6], meshes_per_radius=3, rhs_per_mesh=2,
                       batch_size=2)}


def small_cell(name: str):
    cell = spec.load_cell(name)
    cell.traffic = dict(cell.traffic, **SMALL[cell.traffic["kind"]])
    return cell


def run_small(name: str, seed: int = 1234567890123, seconds: float = 0.5,
              predictor=None):
    """One run of the cell's loop on the CPU over the small pool;
    ``predictor`` wraps a request cell's predictor."""
    cell = small_cell(name)
    if predictor is not None:
        return sweep.run(cell, seed, seconds, False, "cpu",
                         time.perf_counter(), predictor=predictor)
    return spec.loop_module(cell.traffic).run(cell, seed, seconds, False,
                                              "cpu", time.perf_counter())
