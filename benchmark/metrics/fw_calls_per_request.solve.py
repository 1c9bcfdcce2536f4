"""fw_calls_per_request.solve: evaluations of f_θ a request, from the
forward-kernel launch counter."""

from benchmark.benchlib import readers


def read(run):
    return readers.fw_calls_per_request(run)
