"""The benchmark's own spans, recorded around its calls into the engine.

`Recorder` wraps four of one Engine instance's methods (on the instance,
not the class; the program's code is unchanged) and keeps, for each engine
step the harness drives:

  * a timeline of what the host was doing, as (time, activity) marks:
    "admission" (`_admit`: tokenizing a job and placing it in a slot),
    "prefill_chunk" (`_prefill`: one chunk's forward into its slot),
    "sample" (the rest of the step before its decode: sampling from the
    pending logits, the host sync that reads the tokens, emitting them),
    "decode_step" (from `_decode_positions` with one write a row to the
    step's end: one batched forward), "decode_chunk" (`_decode_chunked`:
    n forwards with sampling on the device, one host sync) and "harness"
    (between steps: the benchmark's closed loop);
  * the work of the step as host-side knowledge: each prefill chunk's real
    tokens and write position, and each decode's active rows, their next
    cache positions and the number of forwards. Nothing reads a device
    tensor.

The wrapped methods are the engine's own and may change. A method that is
gone, or whose parameters are no longer the ones the hooks pass, leaves
the recorder off; after a window, `disagrees` compares what the hooks saw
with the counts the harness takes from the engine's public state, and
names any gap. Either way the harness drops the spans, so that a reading
made from them is missing rather than wrong. No end-to-end metric reads a
span.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field

# the engine methods the hooks wrap, with the parameters they pass on
HOOKS = {"_admit": ("slot_idx", "job"), "_prefill": ("slot_idx", "ids", "write_pos"),
         "_decode_positions": ("active", "writes"),
         "_decode_chunked": ("active", "n_chunk", "temp", "top_k", "top_p", "rp")}


@dataclass
class Step:
    t0: float
    t1: float = 0.0
    prefills: list = field(default_factory=list)  # (tokens, write_pos)
    positions: list = field(default_factory=list)  # active rows' next cache positions
    tokens: int = 0  # decode steps a row: 1, or a chunk's n
    forwards: int = 0  # decode forwards: 1, or a chunk's n + 1


class Recorder:
    def __init__(self, engine):
        self.engine = engine
        self.marks: list[tuple[float, str]] = []
        self.steps: list[Step] = []
        self._cur: Step | None = None
        self.off = changed_hooks(engine)  # why the recorder is off, or ""
        if not self.off:
            self._wrap("_admit", self._on_admit)
            self._wrap("_prefill", self._on_prefill)
            self._wrap("_decode_positions", self._on_positions)
            self._wrap("_decode_chunked", self._on_chunked)

    def _wrap(self, name, hook):
        inner = getattr(self.engine, name)

        def wrapped(*args, **kw):
            return hook(inner, *args, **kw)

        setattr(self.engine, name, wrapped)

    def disagrees(self, prompt_tokens: int, output_tokens: int) -> str:
        """Why the window's spans cannot be trusted, or "": the recorder is
        off, the hooks saw fewer prompt tokens prefilled than the engine's
        jobs show (a context swap's re-feed only adds), or tokens were
        emitted while no decode forward was seen."""
        if self.off:
            return self.off
        seen = sum(n for st in self.steps for n, _ in st.prefills)
        if seen < prompt_tokens:
            return f"the hooks saw {seen} prompt tokens prefilled, the jobs show {prompt_tokens}"
        if output_tokens > 0 and self.steps and not any(st.forwards for st in self.steps):
            return f"{output_tokens} tokens emitted and no decode forward seen"
        return ""

    def mark(self, label: str) -> None:
        self.marks.append((time.perf_counter(), label))

    def step(self) -> Step:
        """One engine step, recorded."""
        self._cur = st = Step(time.perf_counter())
        self.marks.append((st.t0, "sample"))
        self.engine.step()
        st.t1 = time.perf_counter()
        self.marks.append((st.t1, "harness"))
        self.steps.append(st)
        self._cur = None
        return st

    def _on_admit(self, inner, *args, **kw):
        self.mark("admission")
        out = inner(*args, **kw)
        self.mark("sample")
        return out

    def _on_prefill(self, inner, slot_idx, ids, write_pos):
        self.mark("prefill_chunk")
        out = inner(slot_idx, ids, write_pos=write_pos)
        self.mark("sample")
        if self._cur is not None:
            self._cur.prefills.append((len(ids), int(write_pos)))
        return out

    def _on_positions(self, inner, active, writes):
        pos = inner(active, writes)
        if self._cur is not None:
            rows = [int(pos[i]) for i in range(len(active)) if active[i]]
            self._cur.positions = rows
            if writes == 1:  # a single decode step; a chunk's is set below
                self._cur.tokens = self._cur.forwards = 1
                self.mark("decode_step")
        return pos

    def _on_chunked(self, inner, active, n_chunk, *args, **kw):
        self.mark("decode_chunk")
        out = inner(active, n_chunk, *args, **kw)
        if self._cur is not None:
            self._cur.tokens, self._cur.forwards = n_chunk, n_chunk + 1
        return out


def changed_hooks(engine) -> str:
    """"" if every method in HOOKS is on the engine and takes the parameters
    the hooks pass on, by name and in order; else what changed."""
    for name, params in HOOKS.items():
        fn = getattr(engine, name, None)
        if fn is None:
            return f"the engine has no {name}"
        have = tuple(inspect.signature(fn).parameters)
        if have[:len(params)] != params:
            return f"{name} takes {have}, the hooks pass {params}"
    return ""
