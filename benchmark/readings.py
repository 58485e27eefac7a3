"""What the metric readers share: a step's work by reckon.py, and the traced
slice's busy time and kernel time. Every function returns None where there
is nothing to read (no traced slice, no kernel of the names), never 0."""

from __future__ import annotations

from benchmark import reckon
from benchmark.trace import busy_intervals, kernel_base

SHORT_WINDOW = 32  # queries of a window counted with decode attention


def step_work(dims, step) -> dict:
    """One recorded step's work: "matmul", "attention", and "short_attention"
    (windows of at most SHORT_WINDOW queries: decode steps and short prefill
    chunks), each a reckon.Work."""
    mm = at = short = reckon.Work()
    for n, p0 in step.prefills:
        m, a = reckon.prefill_chunk(dims, n, p0)
        mm, at = mm + m, at + a
        if n <= SHORT_WINDOW:
            short = short + a
    if step.forwards:
        m, a = reckon.decode_forwards(dims, step.positions, step.forwards)
        mm, at, short = mm + m, at + a, short + a
    return {"matmul": mm, "attention": at, "short_attention": short}


def total_work(dims, steps, kind: str) -> reckon.Work:
    w = reckon.Work()
    for st in steps:
        w = w + step_work(dims, st)[kind]
    return w


def slice_s(run) -> float | None:
    return None if run.trace is None else run.trace.t1 - run.trace.t0


def busy_s(run) -> float | None:
    if run.trace is None:
        return None
    return sum(e - s for s, e in busy_intervals(run.trace.events, run.trace.t0, run.trace.t1))


def kernel_s(run, names) -> float | None:
    """Device seconds of the slice's kernels whose base name is in `names`
    (or starts with one that ends in "*")."""
    if run.trace is None:
        return None
    exact = {n for n in names if not n.endswith("*")}
    prefixes = tuple(n[:-1] for n in names if n.endswith("*"))
    t = sum(e - s for name, s, e in run.trace.events
            if (k := kernel_base(name)) in exact or (prefixes and k.startswith(prefixes)))
    return t if t > 0 else None


def roofline_pct(run, kind: str, names) -> float | None:
    """100 * the reckoned least time of the slice's `kind` work over the
    device time of the kernels `names`."""
    t = kernel_s(run, names)
    if t is None:
        return None
    least = total_work(run.dims, run.slice_steps, kind).least_s
    return 100.0 * least / t if least > 0 else None


def mfu_pct(run) -> float | None:
    """100 * the model's operations in the window's steps (reckon.py) over
    the window's seconds and the bf16 dense peak; nothing off the card."""
    from benchmark.peaks import BF16_FLOPS_PER_S

    if not run.on_card or not run.window_s:
        return None
    flops = sum(w.flops for st in run.steps
                for k, w in step_work(run.dims, st).items() if k != "short_attention")
    return 100.0 * flops / run.window_s / BF16_FLOPS_PER_S if flops > 0 else None


def decode_steps(steps) -> int:
    """Decode steps a row ran: a single step 1, a chunk its n."""
    return sum(st.tokens for st in steps)
