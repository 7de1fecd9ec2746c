"""Set-up: process start to the end of the warm-up (imports, CUDA
context, kernel build where there is none yet, weights, engine, warm-up)."""


def read(run):
    return run.setup_s
