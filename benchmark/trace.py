"""A device trace of a short steady slice of the window, and its reductions.

`Slice` runs whole engine steps under `torch.profiler` (device activity
only) between two device synchronizations, so that the slice holds exactly
the device work its steps launched. Right after the first synchronization,
with the device idle, it launches a marker (a fill of a tensor of its own):
the marker is the trace's first device operation, and its start ties the
trace's clock to the host's, so the benchmark's spans (spans.py) can name
what the host was doing during each idle gap. A trace can come back lossy
(no device events, or far fewer than the steps launched: seen on this card
type, `utils/timing.py:profiled` retries for it); the caller then takes
another slice later in the window.

The reductions (`busy_intervals`, `idle_by_activity`, `time_by_kernel`)
are plain functions of (name, start_s, end_s) tuples, tested on the CPU.
"""

from __future__ import annotations

import re
import time

_ANON = re.compile(r"\(anonymous namespace\)::")
_BASE = re.compile(r"(?:void\s+)?(?:[\w:]*::)?([A-Za-z_]\w*)")


def kernel_base(name: str) -> str:
    """A kernel's name without its return type, namespaces and template
    arguments: "void (anonymous namespace)::dq_tc<1, 2>(...)" -> "dq_tc"."""
    m = _BASE.match(_ANON.sub("", name.strip()))
    return m.group(1) if m else name


def busy_intervals(events, t0: float, t1: float) -> list[tuple[float, float]]:
    """The union of the events' intervals, clipped to [t0, t1], sorted."""
    spans = sorted((max(s, t0), min(e, t1)) for _, s, e in events if e > t0 and s < t1)
    out: list[list[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_by_activity(busy: list[tuple[float, float]], t0: float, t1: float,
                     marks: list[tuple[float, str]]) -> dict[str, float]:
    """Seconds of [t0, t1] outside `busy`, split by the host's activity: marks
    are (time, activity) in time order, each activity lasting until the next
    mark."""
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < t1:
        gaps.append((at, t1))
    # the activity segments covering [t0, t1]
    segs, label = [], "harness"
    for t, lab in marks:
        if t <= t0:
            label = lab
    cur = t0
    for t, lab in marks:
        if t <= t0:
            continue
        if t >= t1:
            break
        segs.append((cur, t, label))
        cur, label = t, lab
    segs.append((cur, t1, label))
    out: dict[str, float] = {}
    i = 0
    for gs, ge in gaps:
        while i < len(segs) and segs[i][1] <= gs:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < ge:
            s, e, lab = segs[j]
            ov = min(e, ge) - max(s, gs)
            if ov > 0:
                out[lab] = out.get(lab, 0.0) + ov
            j += 1
    return out


def time_by_kernel(events) -> dict[str, float]:
    """Device seconds summed by kernel base name."""
    out: dict[str, float] = {}
    for name, s, e in events:
        k = kernel_base(name)
        out[k] = out.get(k, 0.0) + (e - s)
    return out


def top(d: dict[str, float], n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class Slice:
    """One traced slice: `start()`, whole steps, `stop()`; then `events`
    (name, start, end) in host seconds, and `t0`, `t1`."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.marker = torch.zeros(7, device=device)
        self.events: list[tuple[str, float, float]] = []
        self.t0 = self.t1 = 0.0
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        self.marker.fill_(1.0)

    def stop(self) -> None:
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def collect(self) -> int:
        """Read the trace: device events in host seconds, the marker left out.
        Returns how many the trace held."""
        torch = self.torch
        dev = [e for e in self._prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        self._prof = None
        if not dev:
            return 0
        first = min(dev, key=lambda e: e.time_range.start)
        base = first.time_range.start
        self.events = [(e.name, self.t0 + (e.time_range.start - base) / 1e6,
                        self.t0 + (e.time_range.end - base) / 1e6)
                       for e in dev if e is not first]
        return len(dev)


def warm_profiler(device) -> None:
    """Start and stop the profiler once in set-up, so that its first start
    (CUPTI's initialization) does not fall in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(8, device=device)
    with profile(activities=[ProfilerActivity.CUDA]):
        x.add_(1.0)
        torch.cuda.synchronize(device)
