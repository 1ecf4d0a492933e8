"""Seconds from the process's start to the first timed unit: imports,
inputs and weights made from the seed, kernels loaded (built, on a
checkout's first run), warm-up and the set-up steps."""


def read(run):
    return run.setup_s
