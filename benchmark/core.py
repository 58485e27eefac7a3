"""The harness's core: find a cell by name, run its kind, read its metrics,
judge its outputs, and put together the one result line.

Everything is found by name, so that a later change adds files and entries
and edits none: the cell in BENCHMARK.json names its configuration
(`benchmark/configs/<config>.json`) and its traffic mix
(`benchmark/traffic/<traffic>.json`); the mix's "kind" names the module
that runs it (`benchmark/kinds/<kind>.py`: `run`, `check`, `passes`); each
metric the cell reports has a reader (`benchmark/metrics/<metric>.py`, a
`read(run)` that returns a number or None); the cell's output limits are
`benchmark/limits/<workload>.json`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass

FORBIDDEN = ("jax", "jaxlib", "flax", "llamago_tpu")


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `llamago_tpu_torch` is not `llamago_tpu`."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


@dataclass
class Ctx:
    root: str
    workload: dict
    dims: object
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    control: bool
    t_start: float


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics the cell reports: its end-to-end ones, or with a trace its
    per-layer ones; a metric without "workloads" goes to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(root: str, name: str, run):
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def make_ctx(root, workload, seed, seconds, trace, device, control=False, t_start=None):
    from benchmark.reference.dims import load_dims

    bench = load_benchmark(root)
    cell = find_cell(bench, workload)
    cfg = config_entry(bench, cell["config"])
    return Ctx(root=root, workload=cell, dims=load_dims(os.path.join(root, cfg["file"])),
               mix=_json(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json")),
               limits=_json(os.path.join(root, "benchmark", "limits", f"{workload}.json")),
               seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device,
               control=control, t_start=time.perf_counter() if t_start is None else t_start)


def run_cell(ctx: Ctx) -> dict:
    """Run the cell and return its result line (a dict, keys in order)."""
    kind = importlib.import_module(f"benchmark.kinds.{ctx.mix['kind']}")
    run = kind.run(ctx)
    bench = load_benchmark(ctx.root)
    metrics = {}
    for m in cell_metrics(bench, ctx.workload["name"], ctx.trace):
        v = read_metric(ctx.root, m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = device_info(ctx, run)
    breakdown = breakdown_of(run) if ctx.trace and run.trace is not None else None
    numbers, control = kind.check(ctx, run)
    line = {"correct": kind.passes(numbers), "attempted": len(run.ttft_s),
            "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if control is not None:
        line["control"] = control
    line["check"] = numbers
    return line


def device_info(ctx: Ctx, run) -> dict:
    import torch

    if ctx.device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": run.memory_peak_bytes}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
                "count": int(ctx.workload["chips"]),
                "memory_peak_bytes": run.memory_peak_bytes,
                "power_limit": power_limit()}
    if ctx.trace and run.trace is not None:
        from benchmark.readings import busy_s, slice_s

        info["busy_s"] = busy_s(run)
        info["window_s"] = slice_s(run)
    return info


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread: {e}"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unread"


def breakdown_of(run) -> dict:
    """The slice's device operations that took most time, and its idle time
    by what the host was doing (spans.py's activities)."""
    from benchmark.trace import busy_intervals, idle_by_activity, time_by_kernel, top

    t = run.trace
    busy = busy_intervals(t.events, t.t0, t.t1)
    return {"device_ops": top(time_by_kernel(t.events)),
            "idle_gaps": top(idle_by_activity(busy, t.t0, t.t1, run.marks))}


def check_lines(line: dict) -> list[str]:
    """The numbers compared, each beside its limit, one a line."""
    return [f"check {k}: {v['value']} limit {v['limit']}" for k, v in line["check"].items()]
