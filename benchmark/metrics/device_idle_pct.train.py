"""device_idle_pct.train: share of the profiled training steps with
nothing on the card."""

from benchmark.benchlib import readers


def read(run):
    return readers.device_idle_pct(run)
