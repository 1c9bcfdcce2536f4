"""adjoint_reads_per_step.train: host reads that steer the adjoint solve
a training step: the ``solver.read`` and ``loop.read`` spans inside the
program's ``deq.adjoint`` spans, at any depth, over the slice's steps."""

from benchmark.benchlib import progspans

READS = ("solver.read", "loop.read")


def read(run):
    spans = progspans.records()
    adjoints = {id(r) for r in spans if r.name == "deq.adjoint"}
    steps = [s for s in run.steps if s.profiled]
    if not adjoints or not steps:
        return None
    reads = sum(1 for r in spans
                if r.name in READS and progspans._inside(r, adjoints))
    return reads / len(steps)
