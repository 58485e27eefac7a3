"""Kernels: the least time reckon.py gives the matmuls of the traced slice's
forwards (decode steps and prefill chunks), over the device time of K1, the
kernels named dq_*. Which of bytes and operations bound it: see reckon.py."""

from benchmark.readings import roofline_pct

KERNELS = ("dq_*",)


def read(run):
    return roofline_pct(run, "matmul", KERNELS)
