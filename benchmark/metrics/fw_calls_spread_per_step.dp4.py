"""fw_calls_spread_per_step.dp4: the ranks' largest less smallest count
of f_θ evaluations in a step, averaged over the window's steps."""

from benchmark.benchlib import counted


def read(run):
    return counted.f_calls_spread_per_step(run)
