"""adjoint_ms_per_step.train: host ms a training step spends in its
adjoint solve (the program's ``deq.adjoint`` spans)."""

from benchmark.benchlib import progspans


def read(run):
    return progspans.per_step(run, "deq.adjoint")
