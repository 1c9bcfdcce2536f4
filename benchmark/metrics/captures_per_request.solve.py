"""captures_per_request.solve: CUDA graphs a request captures for the
solve's loop (the number of the program's ``loop.capture`` spans)."""

from benchmark.benchlib import progspans


def read(run):
    return progspans.per_request(run, "loop.capture", count=True)
