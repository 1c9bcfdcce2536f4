"""adjoint_calls_per_step.train: VJPs of f_θ a training step (the adjoint
solve's, and the loss's own few), from the backward-kernel counter."""

from benchmark.benchlib import readers


def read(run):
    return readers.calls_per_step(run, "bw")
