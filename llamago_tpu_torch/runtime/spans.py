"""The engine's spans: what the host did in each step, and when.

One process-wide recorder, `SPANS`, as `ops/launches.py`'s counters are
process-wide: it outlives any Engine, so a caller reads it after the
engine that recorded it is gone. It is always on and has no setting.

  * Clock: `time.perf_counter()` seconds, the clock a device trace's
    marker ties its events to, so spans and device events line up as they
    stand.
  * Spans: a ring of the last CAPACITY spans in the order they started.
    Each holds its name, start and end, the index of the engine step that
    caused it (`step`), the id of the job it concerns (or None) and two
    integer attributes `a` and `b`, whose meaning the span's name fixes
    (runtime/engine.py records them).

Recording never reads a device tensor and never synchronizes: a span is
two clock reads and one slot of the ring. A span is recorded once per
engine step or per event (an admission, a prefill chunk, a host wait),
never per slot or per token. Only the thread inside an engine step
records, so the ring's spans nest: a span started on another thread (an
embedding request served on an HTTP thread) or outside a step (warmup)
is timed but not kept.
"""

from __future__ import annotations

import contextlib
import operator
import threading
import time

_now = time.perf_counter
_thread = threading.get_ident

CAPACITY = 1 << 17  # spans: more than a 45-s window of 128-slot chat steps
_MASK = CAPACITY - 1

# the spans in which the host launches device work; their self time is
# launch time, their `wait` children the host's waits on the card
LAUNCH = frozenset({"prefill", "sample", "decode", "decode_chunk", "spec", "swap"})

# where the host stopped for the card: a `wait` span's `a`
# (a copy to the device, the sampled tokens' read, a decode chunk's tokens'
# read, the speculative chunk's reads)
H2D, READ_TOKENS, READ_CHUNK, READ_SPEC = range(4)


def _field(i: int, doc: str) -> property:
    def put(self, v):
        self[i] = v

    return property(operator.itemgetter(i), put, doc=doc)


class Span(list):
    """One recorded interval, [name, t0, t1, step, job, a, b]; a context
    manager that ends it on exit (a list, so that recording one costs a
    single allocation)."""

    __slots__ = ()
    name = _field(0, "what the host did")
    t0 = _field(1, "start, perf_counter seconds")
    t1 = _field(2, "end; below t0 while the span is open")
    step = _field(3, "index of the engine step that caused it")
    job = _field(4, "id of the job it concerns, or None")
    a = _field(5, "first integer attribute")
    b = _field(6, "second integer attribute")

    def __enter__(self) -> Span:
        return self

    def __exit__(self, *exc) -> None:
        self[2] = _now()


class Recorder:
    def __init__(self):
        self._ring: list[Span | None] = [None] * CAPACITY
        self.n = 0  # spans recorded so far, those the ring dropped included
        self.steps = 0  # engine steps begun
        self.current = -1  # index of the engine step in progress
        self._owner = None  # the thread inside that step

    def span(self, name: str, job=None, a: int = 0, b: int = 0) -> Span:
        """Start a span (end it with `with` or `Span.__exit__`); kept only
        if this thread is inside a step."""
        s = Span((name, _now(), -1.0, self.current, job, a, b))
        if _thread() == self._owner:
            i = self.n
            self._ring[i & _MASK] = s
            self.n = i + 1
        return s

    def wait(self, site: int) -> Span:
        """Start a `wait` span: the host stopped for the card at `site`."""
        return self.span("wait", a=site)

    @contextlib.contextmanager
    def step(self):
        """The `step` span of the next engine step; spans this thread
        records inside it take its index."""
        k = self.steps
        self.steps = k + 1
        self.current, self._owner = k, _thread()
        try:
            with self.span("step", a=k):
                yield
        finally:
            self.current, self._owner = -1, None

    def spans(self) -> list[Span]:
        """The spans the ring holds, in the order they started."""
        if self.n <= CAPACITY:
            return self._ring[:self.n]
        i = self.n & _MASK
        return self._ring[i:] + self._ring[:i]

    def between(self, t0: float, t1: float) -> tuple[list[Span], bool]:
        """The ended spans that overlap [t0, t1], in the order they started,
        and whether the ring still holds every span that started at t0 or
        later (False once it has dropped one of them)."""
        held = self.spans()
        complete = self.n <= CAPACITY or (bool(held) and held[0].t0 < t0)
        return [s for s in held if s.t0 <= t1 and s.t1 >= t0 and s.t1 >= s.t0], complete


def parents(spans: list[Span]) -> list[int]:
    """The index in `spans` of each span's innermost enclosing span, or -1
    (spans in the order they started, as the ring holds them)."""
    out, stack = [], []
    for i, s in enumerate(spans):
        while stack and spans[stack[-1]].t1 <= s.t0:
            stack.pop()
        out.append(stack[-1] if stack else -1)
        stack.append(i)
    return out


def self_times(spans: list[Span]) -> list[float]:
    """Each span's duration less the part of it its child spans cover."""
    out = [s.t1 - s.t0 for s in spans]
    for i, p in enumerate(parents(spans)):
        if p >= 0:
            out[p] -= spans[i].t1 - spans[i].t0
    return out


SPANS = Recorder()
