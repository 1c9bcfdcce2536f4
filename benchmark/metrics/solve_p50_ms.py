"""solve_p50_ms: median latency of every Ψ-GNN request of the window."""

from benchmark.benchlib import readers


def read(run):
    return readers.latency_ms(run, 50)
