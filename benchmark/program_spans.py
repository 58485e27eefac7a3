"""What the readers of the program's own spans share (`"source":
"program_span"`): the spans the port records inside its engine step
(`llamago_tpu_torch/runtime/spans.py`, always on), read after the run.

The program's recorder keeps the last 2^17 spans of the process on the
host's `perf_counter` clock, the clock of the benchmark's own steps
(spans.py) and of the traced slice (trace.py), so the three line up as
they stand. Each function returns None, never 0, where there is nothing
to read: off the card (there host time is the model's own compute), with
no recorder in the program, when the program's ring has dropped part of
the interval, or when it holds no span there.

The yardstick is fixed here, not in the program: the span names below, and
what counts as launch time (a launch span's self time: its length less
its child spans, the host's waits on the card among them).
"""

from __future__ import annotations

# the program's spans in which the host launches device work
LAUNCH = ("prefill", "sample", "decode", "decode_chunk", "spec", "swap")


def _recorder():
    try:
        from llamago_tpu_torch.runtime.spans import SPANS
    except ImportError:  # a program without the recorder
        return None
    return SPANS


def window(run) -> tuple[float, float] | None:
    """The window, from the first step's start to the last step's end."""
    return (run.steps[0].t0, run.steps[-1].t1) if run.steps else None


def spans_between(run, t0: float, t1: float) -> list | None:
    """The program's spans that overlap [t0, t1], in the order they started,
    if its ring still holds all of them and there is one."""
    rec = _recorder()
    if rec is None or not run.on_card:
        return None
    spans, complete = rec.between(t0, t1)
    return spans if complete and spans else None


def window_spans(run):
    """(spans, t0, t1) of the window, or None."""
    w = window(run)
    if w is None:
        return None
    spans = spans_between(run, *w)
    return None if spans is None else (spans, *w)


def _clipped(s, t0: float, t1: float) -> float:
    return max(0.0, min(s.t1, t1) - max(s.t0, t0))


def parents(spans) -> list[int]:
    """The index of each span's innermost enclosing span, or -1 (spans in the
    order they started; the program records them on one thread, so they
    nest)."""
    out, stack = [], []
    for i, s in enumerate(spans):
        while stack and spans[stack[-1]].t1 <= s.t0:
            stack.pop()
        out.append(stack[-1] if stack else -1)
        stack.append(i)
    return out


def self_times(spans) -> list[float]:
    """Each span's length less the part its child spans cover."""
    out = [s.t1 - s.t0 for s in spans]
    for i, p in enumerate(parents(spans)):
        if p >= 0:
            out[p] -= spans[i].t1 - spans[i].t0
    return out


def innermost_marks(spans, opaque: frozenset = frozenset()) -> list[tuple[float, str]]:
    """(time, name) marks in time order: the innermost open span from each
    mark to the next, "outside" where none is open (trace.idle_by_activity's
    marks). A span named in `opaque` takes its children's time as its own."""
    marks, stack = [], []

    def close_until(t: float) -> None:
        while stack and stack[-1].t1 <= t:
            e = stack.pop()
            marks.append((e.t1, stack[-1].name if stack else "outside"))

    for s in spans:
        close_until(s.t0)
        if stack and stack[-1].name in opaque:
            continue
        marks.append((s.t0, s.name))
        stack.append(s)
    close_until(float("inf"))
    return marks


def time_pct(run, name: str) -> float | None:
    """100 * the window's time inside spans named `name` over its length."""
    w = window_spans(run)
    if w is None:
        return None
    spans, t0, t1 = w
    return 100.0 * sum(_clipped(s, t0, t1) for s in spans if s.name == name) / (t1 - t0)


def launch_pct(run) -> float | None:
    """100 * the launch spans' self time in the window over its length."""
    w = window_spans(run)
    if w is None:
        return None
    spans, t0, t1 = w
    own = sum(t for s, t in zip(spans, self_times(spans))
              if s.name in LAUNCH and s.t0 >= t0 and s.t1 <= t1)
    return 100.0 * own / (t1 - t0)


def waits_per_step(run) -> float | None:
    """`wait` spans per `step` span in the window."""
    w = window_spans(run)
    if w is None:
        return None
    spans = w[0]
    steps = sum(1 for s in spans if s.name == "step")
    return sum(1 for s in spans if s.name == "wait") / steps if steps else None


def prefill_wait_steps(run) -> float | None:
    """Mean, over the requests admitted in the window, of the engine steps
    from a request's `admit` span to its first `prefill` span (0 in the same
    step); a request not prefilled when the window closes counts up to the
    window's last step. An admission that failed (`a` = -1) is left out."""
    w = window_spans(run)
    if w is None:
        return None
    spans = w[0]
    steps = [s.step for s in spans if s.name == "step"]
    first: dict = {}
    for s in spans:
        if s.name == "prefill" and s.job is not None:
            first.setdefault(s.job, s.step)
    admits = [s for s in spans if s.name == "admit" and s.a >= 0]
    if not admits or not steps:
        return None
    last = max(steps)
    return sum(first.get(s.job, last) - s.step for s in admits) / len(admits)


def idle_in_launch_pct(run) -> float | None:
    """100 * the traced slice's idle time during which the innermost program
    span was a launch span (its self time), over the slice's idle time inside
    engine steps and outside admissions. The denominator leaves out the
    harness between steps and the admissions, whose share of a 2-s slice
    swings with the requests that happen to arrive in it."""
    from benchmark.trace import busy_intervals, idle_by_activity

    t = run.trace
    if t is None:
        return None
    spans = spans_between(run, t.t0, t.t1)
    if spans is None:
        return None
    idle = idle_by_activity(busy_intervals(t.events, t.t0, t.t1), t.t0, t.t1,
                            innermost_marks(spans, frozenset({"admit"})))
    inside = sum(v for k, v in idle.items() if k not in ("outside", "harness", "admit"))
    return 100.0 * sum(idle.get(n, 0.0) for n in LAUNCH) / inside if inside > 0 else None
