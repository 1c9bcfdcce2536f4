"""fw_calls_per_step.train: evaluations of f_θ a training step (the
forward solve's, and the loss's own few), from the forward-kernel
counter."""

from benchmark.benchlib import readers


def read(run):
    return readers.calls_per_step(run, "fw")
