"""The device-side timing helpers take a trace again when it lost events.

A torch.profiler trace on the card can come back with none of its device
events, or with only some of them. `profiled` retakes a trace that holds
fewer device events than the traced function launches; `timed` asks for at
least one a call. These tests stand a fake profiler in for the real one, so
they run on the CPU.
"""

from __future__ import annotations

import types

import pytest
import torch

from llamago_tpu_torch.utils import timing

CUDA = torch.autograd.DeviceType.CUDA


def _event(start: float, end: float, device_type=CUDA):
    span = types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return types.SimpleNamespace(device_type=device_type, time_range=span, name="k")


def _fake_profiler(monkeypatch, traces):
    """Each `with profile(...)` hands out the next list of `traces`; counts
    the traces taken."""
    taken = []

    class Profile:
        def __init__(self, activities):
            self._events = traces[len(taken)]
            taken.append(self._events)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self._events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing.time, "sleep", lambda s: None)
    return taken


def _calls(n: int, length: float = 2.0):
    return [_event(10.0 * i, 10.0 * i + length) for i in range(n)]


def test_a_trace_that_lost_some_events_is_taken_again(monkeypatch, capsys):
    lossy, whole = _calls(4), _calls(50)
    taken = _fake_profiler(monkeypatch, [lossy, whole])
    got = timing.profiled(lambda: None, min_events=50)
    assert got is whole and len(taken) == 2
    assert "holds 4 device events, fewer than the 50" in capsys.readouterr().err


@pytest.mark.parametrize("events", [[], [_event(0.0, 1.0, torch.autograd.DeviceType.CPU)]])
def test_a_trace_without_device_events_is_taken_again(monkeypatch, events):
    whole = _calls(1)
    taken = _fake_profiler(monkeypatch, [events, whole])
    assert timing.profiled(lambda: None) is whole and len(taken) == 2


def test_a_trace_that_keeps_losing_events_raises(monkeypatch):
    taken = _fake_profiler(monkeypatch, [_calls(3)] * 4)
    with pytest.raises(AssertionError, match="too few device events"):
        timing.profiled(lambda: None, attempts=4, min_events=5)
    assert len(taken) == 4


def test_a_whole_trace_is_taken_once(monkeypatch):
    whole = _calls(5)
    taken = _fake_profiler(monkeypatch, [whole])
    assert timing.profiled(lambda: None, min_events=5) is whole and len(taken) == 1


def test_timed_asks_for_one_device_event_a_call(monkeypatch):
    # 20 calls: a trace of 19 events lost one and is not timed; the whole
    # one is, at 2 us a call.
    taken = _fake_profiler(monkeypatch, [_calls(19), _calls(20)])
    calls = []
    ms = timing.timed([lambda: calls.append(0)], 20)
    assert len(taken) == 2 and ms == pytest.approx(2.0 / 1e3)
    assert len(calls) == 1 + 2 * 20  # the warm-up, then one run per trace
