"""unroll_p50_ms: median latency of every DS-GPS request of the window."""

from benchmark.benchlib import readers


def read(run):
    return readers.latency_ms(run, 50)
