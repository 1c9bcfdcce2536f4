"""mfu.mixed: model operations of the window's requests, from the counted
evaluations of f_θ, as a share of the f32 peak."""

from benchmark.benchlib import counted


def read(run):
    return counted.mfu_pct(run)
