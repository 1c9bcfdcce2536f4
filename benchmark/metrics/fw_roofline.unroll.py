"""fw_roofline.unroll: share of its roofline the forward message-passing
kernel reaches in the profiled slice."""

from benchmark.benchlib import readers


def read(run):
    return readers.fw_roofline_pct(run)
