"""mfu.unroll: model operations of the window's requests as a share of the
f32 peak."""

from benchmark.benchlib import readers


def read(run):
    return readers.mfu_pct(run)
