"""Model step: device operations in the traced slice per decode step of the
slice (a chunk of n counts as n), the step's prefill chunk and sampling
included."""

from benchmark.readings import decode_steps


def read(run):
    if run.trace is None:
        return None
    n = decode_steps(run.slice_steps)
    return len(run.trace.events) / n if n and run.trace.events else None
