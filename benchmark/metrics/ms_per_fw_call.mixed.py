"""ms_per_fw_call.mixed: host ms of the solve per counted evaluation of
f_θ."""

from benchmark.benchlib import counted


def read(run):
    return counted.ms_per_f_call(run)
