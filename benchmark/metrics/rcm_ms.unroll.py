"""rcm_ms.unroll: host ms a request spends putting its nodes in RCM
order (the program's ``graph.rcm`` spans)."""

from benchmark.benchlib import progspans


def read(run):
    return progspans.per_request(run, "graph.rcm")
