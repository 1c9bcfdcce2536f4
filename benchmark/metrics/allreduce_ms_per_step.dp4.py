"""allreduce_ms_per_step.dp4: rank 0's ms in the gradients' all-reduce
and its wait (the program's ``dp.allreduce`` spans) a traced step."""

from benchmark.benchlib import counted


def read(run):
    return counted.allreduce_ms_per_step(run)
