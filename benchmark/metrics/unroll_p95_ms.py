"""unroll_p95_ms: 95th percentile of the latency of every DS-GPS request of
the window."""

from benchmark.benchlib import readers


def read(run):
    return readers.latency_ms(run, 95)
