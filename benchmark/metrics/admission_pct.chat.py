"""Engine: the share of the window the host spent admitting requests (the
program's `admit` spans: tokenizing, placing in a slot, filling the
repeat-penalty window), in %."""

from benchmark.program_spans import time_pct


def read(run):
    return time_pct(run, "admit")
