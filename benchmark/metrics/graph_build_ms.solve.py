"""graph_build_ms.solve: mean host ms of node order, graph build and copy
to the card a request."""

from benchmark.benchlib import readers


def read(run):
    return readers.graph_build_ms(run)
