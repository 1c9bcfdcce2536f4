"""adjoint_host_ms_per_vjp.train: host ms of the adjoint solve, its host
reads left out, per VJP."""

from benchmark.benchlib import progspans


def read(run):
    return progspans.adjoint_host_ms_per_vjp(run)
