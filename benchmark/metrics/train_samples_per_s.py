"""train_samples_per_s: samples of the training steps completed in the
window over its seconds."""

from benchmark.benchlib import readers


def read(run):
    return readers.samples_per_s(run)
