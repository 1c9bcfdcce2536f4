"""solve_nodes_per_s: Ψ-GNN requests' mesh nodes completed in the window
over its seconds."""

from benchmark.benchlib import readers


def read(run):
    return readers.nodes_per_s(run)
