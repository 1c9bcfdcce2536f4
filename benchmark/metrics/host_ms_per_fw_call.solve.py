"""host_ms_per_fw_call.solve: host ms of the forward solve, its reads of
``done`` left out, per evaluation of f_θ."""

from benchmark.benchlib import progspans


def read(run):
    return progspans.host_ms_per_fw_call(run)
