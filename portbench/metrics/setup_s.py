"""Seconds from process start to the first timed request: imports, the CUDA
context, loading the cached kernel library, the seed's inputs and the warm
call at the cell's own shape."""


def read(run):
    return run.setup_s
