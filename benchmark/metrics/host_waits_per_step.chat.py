"""Model step: the host's waits on the card per engine step in the window
(the program's `wait` spans over its `step` spans)."""

from benchmark.program_spans import waits_per_step


def read(run):
    return waits_per_step(run)
