"""Seconds from the process's start to the window's: kernels, weights,
engine, warm-up."""


def read(run):
    return run.setup_s
