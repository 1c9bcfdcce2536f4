"""csr_ms.unroll: host ms a request spends packing its edges as CSR and
copying them to the card (the program's ``graph.csr`` spans)."""

from benchmark.benchlib import progspans


def read(run):
    return progspans.per_request(run, "graph.csr")
