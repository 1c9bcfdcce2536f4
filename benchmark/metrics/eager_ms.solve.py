"""eager_ms.solve: host ms a request spends stepping the solve's first
chunk eagerly (the program's ``loop.eager`` spans)."""

from benchmark.benchlib import progspans


def read(run):
    return progspans.per_request(run, "loop.eager")
