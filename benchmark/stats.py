"""Percentiles and first-token waits, as the benchmark states them."""

from __future__ import annotations

import math


def percentile(values, p: float) -> float:
    """The nearest-rank p-th percentile: the smallest value with at least p%
    of the values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no values")
    return s[max(0, math.ceil(p / 100.0 * len(s)) - 1)]


def first_token_waits(requests, end: float) -> list[float]:
    """Seconds from submission to first token of each request, given as
    (created, first_token_at or None, failed). A request that failed or had
    no first token by `end` ranks above every served one: its wait is
    at least until then, and at least the longest served wait."""
    served = [t - c for c, t, failed in requests if t is not None and not failed]
    top = max(served, default=0.0)
    return served + [max(end - c, top) for c, t, failed in requests
                     if t is None or failed]
