"""The engine's spans (runtime/spans.py): the recorder's nesting, self
time and ring, and what a tiny Engine run on the CPU records."""

import threading

import numpy as np
import pytest
import torch

from llamago_tpu_torch.checkpoint.params import load_parameters
from llamago_tpu_torch.config import MODEL_PRESETS, GenerateConfig
from llamago_tpu_torch.runtime import spans as sp
from llamago_tpu_torch.runtime.engine import Engine, JobStatus
from llamago_tpu_torch.tokenizer import Vocab

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)


def _span(name, t0, t1, step=0, job=None, a=0, b=0):
    return sp.Span((name, t0, t1, step, job, a, b))


def _engine(slots, **kw):
    """A tiny f32 engine on the CPU, a context of 64."""
    cfg = MODEL_PRESETS["tiny"].replace(dtype="float32", weight_dtype="float32",
                                        max_seq_len=64)
    params = load_parameters(cfg, random_ggjt_tensors(cfg, seed=3), device="cpu")
    return Engine(cfg, params, Vocab(list(make_test_vocab().tokens)), slots=slots,
                  buckets=(16, 32, 64), device="cpu", **kw)


def test_nesting_and_self_time():
    spans = [_span("step", 0.0, 10.0), _span("admit", 1.0, 3.0), _span("wait", 1.5, 2.0),
             _span("prefill", 4.0, 8.0), _span("wait", 5.0, 7.0), _span("wait", 7.0, 7.5),
             _span("emit", 8.5, 9.0)]
    assert sp.parents(spans) == [-1, 0, 1, 0, 3, 3, 0]
    assert sp.self_times(spans) == pytest.approx([3.5, 1.5, 0.5, 1.5, 2.0, 0.5, 0.5])


def test_recorder_spans_steps_and_counters():
    """Spans are kept inside a step, with its index; steps are counted."""
    rec = sp.Recorder()
    with rec.span("admit", "job-0") as outside:  # outside a step: timed, not kept
        pass
    with rec.step():
        with rec.span("admit", "job-1", 2) as admit:
            admit.b = 7
            with rec.wait(sp.H2D):
                pass
        with rec.span("decode", None, 3, 40):
            pass
    with pytest.raises(RuntimeError), rec.step():
        raise RuntimeError("a failed step still ends its span")
    held = rec.spans()
    assert outside.t1 >= outside.t0 and all(s is not outside for s in held)
    assert [s.name for s in held] == ["step", "admit", "wait", "decode", "step"]
    assert [s.step for s in held] == [0, 0, 0, 0, 1] and rec.current == -1
    assert (held[1].job, held[1].a, held[1].b, held[2].a) == ("job-1", 2, 7, sp.H2D)
    assert all(s.t1 >= s.t0 for s in held)
    assert rec.steps == 2 and rec.n == 5


def test_ring_wrap_is_reported_as_an_incomplete_interval():
    rec = sp.Recorder()
    with rec.step():
        first = rec.span("wait")
        first.__exit__()
        for _ in range(sp.CAPACITY):
            rec.span("wait").__exit__()
    held = rec.spans()
    assert len(held) == sp.CAPACITY and all(s is not first for s in held)
    assert all(a.t0 <= b.t0 for a, b in zip(held, held[1:]))
    _, complete = rec.between(first.t0, held[-1].t1)
    assert not complete  # the ring dropped a span that started in the interval
    spans, complete = rec.between(held[1].t0, held[-1].t1)
    assert complete and spans[0] is held[1] and len(spans) == sp.CAPACITY - 1


@pytest.fixture(scope="module")
def tiny_run():
    """A 4-slot engine (decode chunks of 4, a 32-token context for one job
    so that it swaps) serving jobs that share prefixes, with its
    `_decode_positions` calls and the spans it recorded."""
    eng = _engine(4, decode_chunk_size=4)
    eng.warmup(include_embed=False)
    calls = []
    real = eng._decode_positions

    def positions(active, writes):
        calls.append((int(np.sum(active)), writes))
        return real(active, writes)

    eng._decode_positions = positions
    script = [("hello world", 10, 64), ("world hello world", 8, 64), ("hello world hello", 6, 64),
              ("hello", 40, 32), ("hello hello world", 5, 64), ("world", 12, 64),
              ("hello world hello world", 7, 64)]
    n0 = sp.SPANS.n
    jobs = [eng.submit(p, GenerateConfig(max_tokens=n, ctx_size=c, temp=0.0, keep_count=4))
            for p, n, c in script]
    steps = 0
    while any(j.status in (JobStatus.QUEUED, JobStatus.PROCESSING) for j in jobs):
        eng.step()
        steps += 1
    spans = sp.SPANS.spans()[-(sp.SPANS.n - n0):]
    return jobs, steps, calls, spans


def test_counters_count_the_engine_work(tiny_run):
    """The spans' attributes count the engine's work: prompt tokens
    prefilled, rows times the steps they decoded, forwards, steps."""
    jobs, steps, calls, spans = tiny_run
    assert all(j.status == JobStatus.FINISHED for j in jobs)
    assert any(j.reused_tokens for j in jobs)
    parent = sp.parents(spans)
    chunks = [s for s, p in zip(spans, parent)
              if s.name == "prefill" and (p < 0 or spans[p].name != "swap")]
    assert sum(s.a for s in chunks) == sum(j.prompt_tokens - j.reused_tokens for j in jobs)
    assert steps == sum(1 for s in spans if s.name == "step")
    assert sum(1 for s in spans if s.name == "admit") == len(jobs)
    assert any(s.name == "swap" for s in spans)
    # rows times the steps each decode forward ran: a chunk of n counts n
    decode = [s for s in spans if s.name == "decode"]
    chunked = [s for s in spans if s.name == "decode_chunk"]
    assert chunked and any(w > 1 for _, w in calls)
    assert (sum(s.a for s in decode) + sum(s.a * s.b for s in chunked)
            == sum(r * (1 if w == 1 else w - 1) for r, w in calls))
    assert len(decode) + sum(s.b + 1 for s in chunked) == sum(w for _, w in calls)


def test_spans_of_the_run(tiny_run):
    jobs, steps, calls, spans = tiny_run
    assert all(a.t0 <= b.t0 for a, b in zip(spans, spans[1:]))  # in time order
    assert all(s.t1 >= s.t0 for s in spans)
    by_step: dict = {}
    for s in spans:
        by_step.setdefault(s.step, []).append(s)
    assert set(by_step) == set(range(min(by_step), min(by_step) + steps))
    for k, group in by_step.items():
        names = [s.name for s in group]
        assert names[0] == "step" and group[0].a == k
        assert len(group) <= 50  # a 4-slot step
        if {"decode", "decode_chunk"} & set(names):
            assert "wait" in names
        decode = [s for s in group if s.name in ("decode", "decode_chunk")]
        assert all(1 <= s.a <= 4 for s in decode)
    ids = {j.id for j in jobs}
    admits = [s for s in spans if s.name == "admit"]
    assert {s.job for s in admits} == ids and all(s.a >= 0 for s in admits)
    assert {s.job for s in spans if s.name == "prefill"} == ids
    parent = sp.parents(spans)
    for s, p in zip(spans, parent):
        assert (p < 0) == (s.name == "step")
        assert p < 0 or spans[p].t0 <= s.t0 <= s.t1 <= spans[p].t1
        if s.name == "wait":  # every copy and read lies under an admission or a launch
            assert spans[p].name in sp.LAUNCH | {"admit"}
        if s.name == "prefill" and p >= 0 and spans[p].name == "swap":
            assert spans[p].job == s.job
    assert any(spans[p].name == "swap" for s, p in zip(spans, parent) if s.name == "prefill")


def test_a_failed_admission_is_marked_and_counted():
    eng = _engine(1)
    job = eng.generate("hello " * 40, GenerateConfig(max_tokens=4, ctx_size=32, temp=0.0))
    assert job.status == JobStatus.FAILED
    admit = [s for s in sp.SPANS.spans() if s.name == "admit" and s.job == job.id]
    assert len(admit) == 1 and admit[0].a == -1 and admit[0].b == 0


def test_the_speculative_path_records_its_decision(capsys):
    eng = _engine(2, decode_chunk_size=4, speculative=True, draft_len=3)
    n0 = sp.SPANS.n
    job = eng.generate("hello world hello world hello",
                       GenerateConfig(max_tokens=12, ctx_size=64, temp=0.0))
    assert job.status == JobStatus.FINISHED
    spans = sp.SPANS.spans()[-(sp.SPANS.n - n0):]
    spec = [s for s in spans if s.name == "spec"]
    assert spec and all(s.a in eng._halving_rungs() and s.b in (0, 1) for s in spec)
    parent = sp.parents(spans)
    assert any(s.name == "wait" and s.a == sp.READ_SPEC and spans[p].name == "spec"
               for s, p in zip(spans, parent))
    assert capsys.readouterr().out == ""  # the gate prints nothing


def test_the_oneshot_report_reads_the_spans(capsys):
    from llamago_tpu_torch.cli import _report

    eng = _engine(1)
    job = eng.generate("hello world", GenerateConfig(max_tokens=6, ctx_size=64, temp=0.0))
    _report(job)
    line = capsys.readouterr().out.strip()
    head = "[ HALT ] Time per token: "
    assert line.startswith(head) and "tokens 6 |" in line
    per_token, evals, samples = (float(part.split()[-2]) for part in line[len(head):]
                                 .split(" | ")[:3])
    assert evals > 0 and samples > 0
    assert per_token == pytest.approx(evals + samples, abs=0.011)


def test_spans_of_another_thread_are_not_kept():
    """An embedding served on another thread while the engine steps: its
    copies to the device are timed but not kept, so the ring holds exactly
    the engine thread's waits, each nested in its step."""
    eng = _engine(2)
    real, calls = eng._tensor, {}

    def tensor(*args, **kw):
        me = threading.get_ident()
        calls[me] = calls.get(me, 0) + 1
        return real(*args, **kw)

    eng._tensor = tensor
    stop = threading.Event()

    def embed():
        while not stop.is_set():
            eng.embed("hello world")

    n0 = sp.SPANS.n
    other = threading.Thread(target=embed)
    other.start()
    try:
        job = eng.generate("hello world hello", GenerateConfig(max_tokens=24, ctx_size=64,
                                                               temp=0.0))
    finally:
        stop.set()
        other.join()
    assert job.status == JobStatus.FINISHED and calls.get(other.ident, 0) > 0
    spans = sp.SPANS.spans()[-(sp.SPANS.n - n0):]
    waits = [s for s in spans if s.name == "wait" and s.a == sp.H2D]
    assert len(waits) == calls[threading.get_ident()]
    parent = sp.parents(spans)
    assert all(spans[p].t0 <= s.t0 <= s.t1 <= spans[p].t1
               for s, p in zip(spans, parent) if p >= 0)
