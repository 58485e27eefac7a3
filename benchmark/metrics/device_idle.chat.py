"""Device: the share of the traced slice in which no device operation ran."""

from benchmark.readings import busy_s, slice_s


def read(run):
    s, b = slice_s(run), busy_s(run)
    return 100.0 * (1.0 - b / s) if s and b else None
