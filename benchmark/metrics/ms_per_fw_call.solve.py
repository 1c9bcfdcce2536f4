"""ms_per_fw_call.solve: host ms of the solve per evaluation of f_θ."""

from benchmark.benchlib import readers


def read(run):
    return readers.ms_per_fw_call(run)
