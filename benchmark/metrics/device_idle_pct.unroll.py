"""device_idle_pct.unroll: share of the profiled slice with nothing on the
card."""

from benchmark.benchlib import readers


def read(run):
    return readers.device_idle_pct(run)
