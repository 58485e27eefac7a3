"""Split one benchmark window's host time by the engine's spans.

    python scripts/span_split.py <cell> <seed> [seconds] > split.json

Runs the cell from BENCHMARK.json on the card as `benchmark/run.py --trace
1` does (without its correctness check), then prints one JSON object: the
cell's end-to-end rates and per-layer readings, the window's self time by
span name (`outside` is the time between engine steps), the host's waits
by enclosing span and site, spans a step, and the traced slice's idle time
by the innermost span. Fails without a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split(run) -> dict:
    from benchmark import program_spans as ps
    from benchmark.trace import busy_intervals, idle_by_activity

    w = ps.window_spans(run)
    if w is None:
        return {}
    spans, t0, t1 = w
    by_name = {"outside": (t1 - t0) - sum(s.t1 - s.t0 for s in spans if s.name == "step")}
    for s, t in zip(spans, ps.self_times(spans)):
        by_name[s.name] = by_name.get(s.name, 0.0) + t
    waits: dict = {}
    for s, p in zip(spans, ps.parents(spans)):
        if s.name == "wait":
            key = f"{spans[p].name if p >= 0 else '-'}:{s.a}"
            n, tt = waits.get(key, (0, 0.0))
            waits[key] = (n + 1, tt + s.t1 - s.t0)
    per: dict = {}
    for s in spans:
        if s.step >= 0:
            per[s.step] = per.get(s.step, 0) + 1
    counts = sorted(per.values())
    out = {"window_s": t1 - t0, "self_s_by_name": by_name, "waits_by_parent_site": waits,
           "spans_per_step": {"steps": len(counts), "mean": sum(counts) / len(counts),
                              "median": statistics.median(counts), "max": counts[-1],
                              "over_50": sum(1 for c in counts if c > 50)}}
    t = run.trace
    sl = None if t is None else ps.spans_between(run, t.t0, t.t1)
    if sl:
        out["slice_s"] = t.t1 - t.t0
        out["slice_idle_by_innermost"] = idle_by_activity(
            busy_intervals(t.events, t.t0, t.t1), t.t0, t.t1, ps.innermost_marks(sl))
    return out


def main(argv) -> int:
    cell, seed = argv[0], int(argv[1])
    seconds = float(argv[2]) if len(argv) > 2 else 45.0
    sys.path.insert(0, ROOT)
    from benchmark import run as bench_run

    bench_run._caches()
    import torch

    from benchmark import core
    from benchmark.kinds import serve

    if not torch.cuda.is_available():
        print("no result: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = serve.run(core.make_ctx(ROOT, cell, seed, seconds, 1, dev, t_start=T_START))
    bench = core.load_benchmark(ROOT)
    out = {"cell": cell, "seed": seed, "card": core.power_limit(), "setup_s": run.setup_s,
           "output_tok_s": run.output_tokens / run.window_s,
           "prompt_tok_s": run.prompt_tokens / run.window_s,
           "metrics": {m["name"]: core.read_metric(ROOT, m["name"], run)
                       for m in core.cell_metrics(bench, cell, True)}}
    out.update(split(run))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
