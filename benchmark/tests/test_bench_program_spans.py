"""The readers of the program's own spans (program_spans.py) on a tiny CPU
run, read as if it had run on the card: each reports a number in its
range, and nothing once the program's ring has lost the window or where
the program has no recorder."""

import importlib.util
import os
import re
import sys
from types import SimpleNamespace

import pytest

from benchmark.tests.conftest import ROOT
from benchmark.tests.tiny import make_root

NEW = {"admission_pct.chat": (0, 100), "admission_pct.longdoc": (0, 100),
       "launch_pct.chat": (0, 100), "host_wait_pct.chat": (0, 100),
       "host_wait_pct.longdoc": (0, 100), "host_waits_per_step.chat": (1, 50),
       "prefill_wait_steps.chat": (0, 1000), "idle_in_launch_pct.chat": (0, 100)}


def reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("m_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny run's Served record, marked as run on the card, with a made-up
    trace over its middle third: a 0.3-ms device operation every ms."""
    import torch

    from benchmark import core
    from benchmark.kinds import serve

    torch.set_num_threads(1)
    root = make_root(tmp_path_factory.mktemp("spans"))
    run = serve.run(core.make_ctx(root, "tiny.chat", 2**31 + 11, 1.0, True,
                                  torch.device("cpu")))
    assert run.spans_ok and len(run.steps) >= 6
    run.on_card = True
    a, b = run.steps[len(run.steps) // 3], run.steps[2 * len(run.steps) // 3]
    n = int((b.t1 - a.t0) / 1e-3)
    run.trace = SimpleNamespace(t0=a.t0, t1=b.t1, events=[
        ("k", a.t0 + 1e-3 * i, a.t0 + 1e-3 * i + 3e-4) for i in range(n)])
    return run


def test_each_reader_reads_a_number_in_range(served):
    got = {name: reader(name)(served) for name in NEW}
    for name, (lo, hi) in NEW.items():
        assert got[name] is not None and lo <= got[name] <= hi, (name, got[name])
    assert got["admission_pct.chat"] > 0 and got["launch_pct.chat"] > 0
    assert got["admission_pct.chat"] + got["launch_pct.chat"] + got["host_wait_pct.chat"] <= 100


def test_program_steps_lie_inside_the_harness_steps(served):
    """One clock: each harness step holds exactly one program `step` span."""
    from llamago_tpu_torch.runtime.spans import SPANS

    spans, complete = SPANS.between(served.steps[0].t0, served.steps[-1].t1)
    steps = [s for s in spans if s.name == "step"]
    assert complete and len(steps) == len(served.steps)
    for mine, theirs in zip(steps, served.steps):
        assert theirs.t0 <= mine.t0 <= mine.t1 <= theirs.t1
    # a prefill the harness saw is one the program recorded, in the same step
    for mine, theirs in zip(steps, served.steps):
        seen = [(s.a, s.b) for s in spans if s.name == "prefill" and s.step == mine.a]
        assert seen == theirs.prefills


def test_off_the_card_or_without_a_recorder_nothing_is_read(served, monkeypatch):
    monkeypatch.setattr(served, "on_card", False)
    assert all(reader(name)(served) is None for name in NEW)
    monkeypatch.setattr(served, "on_card", True)
    monkeypatch.setitem(sys.modules, "llamago_tpu_torch.runtime.spans", None)
    assert all(reader(name)(served) is None for name in NEW)


def test_the_window_split_adds_up(served):
    """scripts/span_split.py: the self times by span name, with the time
    outside the steps, add up to the window."""
    path = os.path.join(ROOT, "scripts", "span_split.py")
    spec = importlib.util.spec_from_file_location("span_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from benchmark.program_spans import window_spans

    out = mod.split(served)
    assert sum(out["self_s_by_name"].values()) == pytest.approx(out["window_s"], rel=1e-9)
    assert out["self_s_by_name"]["outside"] >= 0 and out["spans_per_step"]["max"] <= 50
    waits = sum(1 for s in window_spans(served)[0] if s.name == "wait")
    assert sum(n for n, _ in out["waits_by_parent_site"].values()) == waits
    assert sum(out["slice_idle_by_innermost"].values()) > 0


def test_nothing_is_read_once_the_ring_has_lost_the_window(served):
    from llamago_tpu_torch.runtime.spans import CAPACITY, SPANS

    assert reader("launch_pct.chat")(served) is not None
    with SPANS.step():
        for _ in range(CAPACITY):
            SPANS.span("filler").__exit__()
    assert all(reader(name)(served) is None for name in NEW)


def test_idle_in_launch_leaves_out_admissions_and_the_harness(monkeypatch):
    """The idle share under launch spans is taken over the idle time inside
    steps and outside admissions: a slice that holds a longer admission, or
    more time between steps, reads the same."""
    from benchmark import program_spans as ps
    from llamago_tpu_torch.runtime.spans import Span

    def read(admit_end, slice_end):
        spans = [Span(("step", 0.0, 10.0, 0, None, 0, 0)),
                 Span(("admit", 1.0, admit_end, 0, "j", 0, 4)),
                 Span(("wait", 1.5, 2.0, 0, None, 0, 0)),
                 Span(("prefill", admit_end + 1, admit_end + 5, 0, "j", 4, 0)),
                 Span(("wait", admit_end + 2, admit_end + 4, 0, None, 0, 0))]
        spans[0][2] = admit_end + 7
        rec = SimpleNamespace(between=lambda t0, t1: (spans, True))
        monkeypatch.setattr(ps, "_recorder", lambda: rec)
        busy = [("k", admit_end + 2, admit_end + 4)]  # the card works while the host waits
        run = SimpleNamespace(on_card=True, steps=[], trace=SimpleNamespace(
            t0=0.0, t1=slice_end, events=busy))
        return ps.idle_in_launch_pct(run)

    # idle in the step's self time 1 + 1 + 2 s, in the prefill's self time 2 s
    assert read(3.0, 10.0) == pytest.approx(100 * 2 / 6)
    assert read(6.0, 13.0) == pytest.approx(100 * 2 / 6)
    assert read(3.0, 14.0) == pytest.approx(100 * 2 / 6)
