"""Device: the share of the window the host spent stopped for the card (the
program's `wait` spans: blocking copies to the device, reads of sampled
tokens), in %."""

from benchmark.program_spans import time_pct


def read(run):
    return time_pct(run, "wait")
