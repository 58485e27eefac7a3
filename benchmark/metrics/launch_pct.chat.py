"""Model step: the share of the window the host spent launching device work
(the self time of the program's launch spans: prefill, sample, decode,
decode_chunk, spec, swap, less their waits on the card), in %."""

from benchmark.program_spans import launch_pct


def read(run):
    return launch_pct(run)
