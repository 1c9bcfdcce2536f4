"""The mixed sweep and the data-parallel training cell cut to pools the
CPU runs in seconds (the data-parallel cell's four ranks on gloo)."""

import time

from benchmark.benchlib import spec

SMALL = {"mixed_sweep": dict(radii=[0.6, 1.0], meshes_per_radius=1),
         "train_dp": dict(radii=[0.6], meshes_per_radius=6, rhs_per_mesh=2,
                          batch_size=4)}


def small_cell(name: str):
    cell = spec.load_cell(name)
    cell.traffic = dict(cell.traffic, **SMALL[cell.traffic["kind"]])
    return cell


def run_small(name: str, seed: int = 1234567890123, seconds: float = 0.5):
    """One run of the cell's loop on the CPU over the small pool."""
    cell = small_cell(name)
    return spec.loop_module(cell.traffic).run(cell, seed, seconds, False,
                                              "cpu", time.perf_counter())
