"""The whole step: the model's operations (reckon.py) in the window's steps
over the window's seconds, against 989 TFLOP/s of dense bf16."""

from benchmark.readings import mfu_pct


def read(run):
    return mfu_pct(run)
