"""Device-side timing, roofline bounds and the card's SM count, shared by
`chip_smoke.py`, the kernel lab and the launch plans of `ops/`.

Times come from the device side of a torch.profiler trace, so the host's
launch cost between small kernels does not count as kernel time. Bounds are
against the H100 SXM data sheet: 3.35 TB/s of device memory, 989 TFLOP/s
dense bf16 and 1,979 TOP/s dense int8 in the tensor cores, 67 TFLOP/s f32
outside them. The launch plans size their waves of blocks for its 132 SMs.
"""

from __future__ import annotations

import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
H100_SMS = 132  # streaming multiprocessors of an H100 SXM


def _device_events(events):
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def device_busy_us(events) -> float:
    """Length of the union of the device-side activity spans in a trace."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in _device_events(events))
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def device_us_by_name(events) -> dict[str, float]:
    """Device time of a trace summed by kernel (or copy) name."""
    by_name: dict[str, float] = {}
    for e in _device_events(events):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return by_name


def profiled(fn, attempts: int = 8, min_events: int = 1):
    """Run fn() under a device-side torch.profiler trace, synchronize, and
    return the trace's events. A trace can lose events: none at all (seen
    once in many, three times in a row once), or most of them (4 of 50
    launches of one small kernel, seen once). A trace that holds fewer than
    `min_events` device events, the least that fn() launches, is taken
    again, after a pause that grows with each attempt, at most `attempts`
    times in all; then it raises. No other clock stands in for the trace's."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        held = len(_device_events(events))
        if held >= min_events and device_busy_us(events) > 0:
            return events
        print(f"[timing] the trace holds {held} device events, fewer than the "
              f"{max(min_events, 1)} launched (attempt {attempt + 1})",
              file=sys.stderr, flush=True)
        time.sleep(0.5 * (attempt + 1))
    raise AssertionError("the profiler recorded too few device events")


def timed(fns, iters: int) -> float:
    """Device time in ms per call over `iters` calls cycling through `fns`,
    after one warm-up pass: the card's busy time in a torch.profiler trace.
    Each call launches at least one device operation, so a trace with fewer
    than `iters` of them lost some and is taken again."""
    for f in fns:
        f()
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fns[i % len(fns)]()

    return device_busy_us(profiled(run, min_events=iters)) / 1e3 / iters


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    """The least time for the work, and which of bytes/operations bound it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
