"""fw_solve_ms_per_step.train: host ms a training step spends in its
forward solve (the program's ``deq.forward`` spans)."""

from benchmark.benchlib import progspans


def read(run):
    return progspans.per_step(run, "deq.forward")
