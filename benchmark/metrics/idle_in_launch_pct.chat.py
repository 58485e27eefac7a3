"""Device: the share of the traced slice's idle time inside engine steps
and outside admissions during which the host was launching device work
(the innermost program span a launch span), in %: program spans and
device events on one clock."""

from benchmark.program_spans import idle_in_launch_pct


def read(run):
    return idle_in_launch_pct(run)
