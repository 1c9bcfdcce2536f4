"""solve_p95_ms: 95th percentile of the latency of every Ψ-GNN request of
the window."""

from benchmark.benchlib import readers


def read(run):
    return readers.latency_ms(run, 95)
