"""The harness at a tiny size on the CPU, through the test-only entry, and
the trace's reductions on made-up events."""

import json
import os
import re

import pytest

from benchmark.tests.conftest import ROOT
from benchmark.tests.tiny import make_root, run_tiny


def test_tiny_cell_serves_and_is_correct(tmp_path):
    line = run_tiny(make_root(tmp_path), seed=2**31 + 77)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert line["correct"] is True, line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"output_tok_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["check"]["checked_tokens"]["value"] >= line["check"]["checked_tokens"]["limit"]


def test_trace_run_reports_per_layer_metrics_it_can_read(tmp_path):
    """On the CPU there is no device trace: the host's metrics are there,
    the trace's readers report nothing (never 0)."""
    line = run_tiny(make_root(tmp_path), trace=True)
    assert set(line["metrics"]) == {"decode_rows.chat"}
    assert 1.0 <= line["metrics"]["decode_rows.chat"]["value"] <= 4.0


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """A later change adds files and entries; it edits no file that is there."""
    root = make_root(tmp_path, name="tinier")
    with open(os.path.join(root, "benchmark", "metrics", "prefill_chunks.tinier.py"), "w") as f:
        f.write("def read(run):\n    return sum(len(s.prefills) for s in run.steps) or None\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "prefill_chunks.tinier", "unit": "chunks",
                               "better": "higher", "source": "program_counter",
                               "layer": "engine", "moves": "output_tok_s",
                               "workloads": ["tinier.chat"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    line = run_tiny(root, cell="tinier.chat", trace=True)
    assert line["metrics"]["prefill_chunks.tinier"]["value"] > 0


def test_the_int8_cache_cell_runs(tmp_path):
    line = run_tiny(make_root(tmp_path, name="tiny8", kv_cache="int8", n_kv_heads=4),
                    cell="tiny8.chat", seed=3)
    assert line["correct"] is True, line["check"]


def test_kernel_base_names():
    from benchmark.trace import kernel_base

    assert kernel_base("void dq_tc<1, 2, true>(float const*, int)") == "dq_tc"
    assert kernel_base("dq_decode_tc") == "dq_decode_tc"
    assert kernel_base("void at::native::vectorized_elementwise_kernel<4, X>(int)") == \
        "vectorized_elementwise_kernel"
    assert kernel_base("Memcpy HtoD (Pageable -> Device)") == "Memcpy"


def test_busy_and_idle_by_activity():
    from benchmark.trace import busy_intervals, idle_by_activity, time_by_kernel, top

    ev = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("void dq_tc<1>()", 3.0, 4.0), ("c", 9.0, 11.0)]
    busy = busy_intervals(ev, 0.0, 10.0)
    assert busy == [(0.0, 2.0), (3.0, 4.0), (9.0, 10.0)]
    marks = [(-1.0, "harness"), (1.5, "sample"), (2.5, "decode_step"), (6.0, "prefill_chunk")]
    idle = idle_by_activity(busy, 0.0, 10.0, marks)
    # gaps 2-3 (sample to 2.5, decode_step after) and 4-9 (decode_step to 6)
    assert idle == pytest.approx({"sample": 0.5, "decode_step": 2.5, "prefill_chunk": 3.0})
    assert time_by_kernel(ev)["dq_tc"] == 1.0
    assert top({"x": 1.0, "y": 3.0, "z": 2.0}, 2) == [["y", 3.0], ["z", 2.0]]


def test_trace_readers_on_a_made_up_slice():
    """Roofline shares, idle share, operations a step and mfu from a slice
    whose kernel times are known."""
    import importlib.util
    from types import SimpleNamespace

    from benchmark import reckon
    from benchmark.kinds.serve import Served
    from benchmark.spans import Step
    from benchmark.tests.test_bench_reckon import TINY

    def reader(name):
        path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location("m_" + re.sub(r"\W", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    steps = [Step(0.0, 0.5, prefills=[(20, 0)], positions=[5, 9], tokens=1, forwards=1)]
    ev = [("void dq_tc<1>()", 0.0, 0.1), ("dq_decode_tc", 0.2, 0.3),
          ("attn_decode_tc", 0.3, 0.35), ("elementwise", 0.35, 0.4)]
    run = Served(dims=TINY, mix={}, on_card=True, steps=steps, slice_steps=steps,
                 trace=SimpleNamespace(t0=0.0, t1=1.0, events=ev))
    mm = reckon.prefill_chunk(TINY, 20, 0)[0] + reckon.decode_forwards(TINY, [5, 9], 1)[0]
    assert reader("matmul_roofline.chat")(run) == pytest.approx(100 * mm.least_s / 0.2)
    short = reckon.attention(TINY, [(20, 0)]) + reckon.attention(TINY, [(1, 5), (1, 9)])
    assert reader("attn_roofline.chat")(run) == pytest.approx(100 * short.least_s / 0.05)
    assert reader("device_idle.chat")(run) == pytest.approx(70.0)
    assert reader("device_ops_per_step.chat")(run) == 4.0
    run.window_s = 2.0
    flops = mm.flops + short.flops
    assert reader("mfu.chat")(run) == pytest.approx(100 * flops / 2.0 / 989e12)
    assert reader("decode_rows.chat")(run) == 2.0
    run.trace.events = [("elementwise", 0.0, 0.1)]
    assert reader("matmul_roofline.chat")(run) is None  # no K1 time: nothing, not 0
    run.trace = None
    assert reader("device_idle.chat")(run) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        for d, name in (("traffic", w["traffic"] + ".json"), ("limits", w["name"] + ".json")):
            assert os.path.isfile(os.path.join(ROOT, "benchmark", d, name))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", list(cells))
        assert set(m["workloads"]) <= set(moved)  # each cell reports what it moves
    for cell in cells:
        reported = [m for m in b["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])


def _served(root, cell="tiny.chat", seed=5, seconds=1.0, trace=True):
    """The Served record of a tiny run (what the metric readers read)."""
    import torch

    from benchmark import core
    from benchmark.kinds import serve

    torch.set_num_threads(1)
    return serve.run(core.make_ctx(root, cell, seed, seconds, trace, torch.device("cpu")))


def test_prompt_tokens_come_from_the_jobs_and_match_the_spans(tmp_path):
    run = _served(make_root(tmp_path))
    assert run.spans_ok and run.prompt_tokens > 0 and run.output_tokens > 0
    assert run.prompt_tokens == sum(n for st in run.steps for n, _ in st.prefills)


def test_a_changed_engine_method_turns_the_spans_off(tmp_path, monkeypatch):
    """A hooked method whose parameters changed leaves the recorder off: the
    end-to-end counts stand, the readings made from spans report nothing."""
    from llamago_tpu_torch.runtime.engine import Engine

    real = Engine._prefill

    def _prefill(self, slot, ids, write_pos):
        return real(self, slot, ids, write_pos=write_pos)

    monkeypatch.setattr(Engine, "_prefill", _prefill)
    root = make_root(tmp_path)
    run = _served(root)
    assert not run.spans_ok and run.steps == []
    assert run.prompt_tokens > 0 and run.output_tokens > 0
    line = run_tiny(root, trace=True)
    assert "decode_rows.chat" not in line["metrics"]
    assert run_tiny(root)["metrics"]["output_tok_s"]["value"] > 0


def test_spans_that_miss_work_are_named():
    from benchmark.spans import Recorder, Step

    class Engine:
        def step(self): ...
        def _admit(self, slot_idx, job): ...
        def _prefill(self, slot_idx, ids, write_pos): ...
        def _decode_positions(self, active, writes): ...
        def _decode_chunked(self, active, n_chunk, temp, top_k, top_p, rp): ...

    rec = Recorder(Engine())
    assert rec.off == ""
    rec.steps = [Step(0.0, 1.0, prefills=[(10, 0)], positions=[3], tokens=1, forwards=1)]
    assert rec.disagrees(10, 4) == ""
    assert "prompt tokens" in rec.disagrees(30, 4)
    rec.steps = [Step(0.0, 1.0, prefills=[(10, 0)])]
    assert "no decode forward" in rec.disagrees(10, 4)
    del Engine._decode_chunked
    assert "_decode_chunked" in Recorder(Engine()).off


def test_the_drain_serves_until_the_check_has_its_tokens(tmp_path):
    """A window too short to finish a request: the loop serves on, counted in
    no metric, until the finished greedy requests hold the check's tokens."""
    from benchmark.tests.tiny import TINY_MIX

    mix = dict(TINY_MIX, drain_s=120, ramp_steps=0,
               check={"max_requests": 16, "target_tokens": 120, "min_tokens": 100})
    line = run_tiny(make_root(tmp_path, mix=mix), seed=9, seconds=0.05)
    assert line["correct"] is True, line["check"]
    assert line["check"]["checked_tokens"]["value"] >= 100
