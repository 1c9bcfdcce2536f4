"""fw_calls_per_request.mixed: evaluations of f_θ a request, from the
program's count of them."""

from benchmark.benchlib import counted


def read(run):
    return counted.f_calls_per_request(run)
