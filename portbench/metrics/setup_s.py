"""The process's start to the first timed request: imports, the kernels'
build or load, weights, inputs and warm requests."""


def read(run):
    return run.setup_s
