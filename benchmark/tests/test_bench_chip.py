"""On the card: the tiny cell traced, and each cell's fp8 control at the
cell's own size through the command itself. Skip without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.tests.conftest import ROOT
from benchmark.tests.tiny import make_root

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    _BENCH = json.load(_f)
CELLS = [w["name"] for w in _BENCH["workloads"]]
CONTROL_SEEDS = (2**31 + 901, 2**31 + 902, 2**31 + 903)


@pytest.mark.chip
def test_tiny_cell_traced_on_the_card(cuda, tmp_path):
    from benchmark import core

    root = make_root(tmp_path)
    ctx = core.make_ctx(root, "tiny.chat", 2**31 + 3, 3.0, True, cuda)
    line = core.run_cell(ctx)
    assert line["correct"] is True, line["check"]
    m = line["metrics"]
    for name in ("device_idle.chat", "device_ops_per_step.chat", "mfu.chat",
                 "matmul_roofline.chat"):
        assert name in m, sorted(m)
    assert 0 < m["device_idle.chat"]["value"] < 100
    assert 0 < m["matmul_roofline.chat"]["value"] <= 105
    assert line["device"]["busy_s"] > 0 and line["device"]["platform"] == "gpu"
    assert line["breakdown"]["device_ops"]
    torch.cuda.synchronize()


@pytest.mark.chip
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cuda, cell, seed):
    """`run.py --control` puts the fp8 control in the program's place: the
    run's own comparison has to come out not correct against the cell's
    limit, while the program's gap of the same run stays within it."""
    r = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                        "--workload", cell, "--seed", str(seed),
                        "--seconds", str(_BENCH["run_seconds"]), "--trace", "0", "--control"],
                       cwd=ROOT, capture_output=True, text=True, timeout=360)
    sys.stderr.write(r.stderr[-3000:])
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"control {cell} seed={seed} {json.dumps(line)}")
    with open(os.path.join(ROOT, "benchmark", "limits", f"{cell}.json")) as f:
        limit = json.load(f)["max_logit_gap"]["limit"]
    gap = line["check"]["max_logit_gap"]
    assert gap["limit"] == limit
    assert line["correct"] is False and gap["value"] > limit
    assert line["control"]["program_max_logit_gap"] <= limit
