"""setup_s: process start to the first timed request (host clock): imports,
kernel builds and loads, the checkpoint, the inputs, the warm-up."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
