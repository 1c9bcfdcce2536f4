"""capture_ms.solve: host ms a request spends capturing CUDA graphs of
the solve's loop (the program's ``loop.capture`` spans)."""

from benchmark.benchlib import progspans


def read(run):
    return progspans.per_request(run, "loop.capture")
