"""Engine: mean engine steps from a request's admission to its first
prefill chunk, over the requests admitted in the window (program spans)."""

from benchmark.program_spans import prefill_wait_steps


def read(run):
    return prefill_wait_steps(run)
