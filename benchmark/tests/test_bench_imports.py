"""Nothing the harness runs imports JAX or the JAX package, and a run
without a card fails."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.core import forbidden_modules
from benchmark.tests.conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "llamago_tpu"}


def test_top_level_names_are_compared_whole():
    names = ["llamago_tpu_torch", "llamago_tpu_torch.ops.kernels", "jaxtyping", "jax_foo",
             "numpy", "llamago_tpu.ops", "jax", "flax.linen", "jaxlib.xla_client"]
    assert forbidden_modules(names) == ["flax.linen", "jax", "jaxlib.xla_client",
                                        "llamago_tpu.ops"]
    assert forbidden_modules(["llamago_tpu_torch.models.llama"]) == []


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_harness_file_names_jax_or_the_jax_package():
    for d, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py"):
                for m in _imports(os.path.join(d, f)):
                    assert m.split(".")[0] not in BANNED, (f, m)


def test_a_tiny_run_loads_neither(tmp_path):
    """The harness's whole run, in a fresh interpreter: the modules loaded at
    its end (the port's included) hold no JAX and no JAX package."""
    from benchmark.tests.tiny import make_root

    root = make_root(tmp_path)
    code = ("import sys, json, io, contextlib\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from benchmark.tests.tiny import run_tiny\n"
            "from benchmark.core import forbidden_modules\n"
            "with contextlib.redirect_stderr(io.StringIO()):\n"
            f"    line = run_tiny({root!r}, seconds=2.0)\n"
            "print(json.dumps([line['correct'], forbidden_modules(),"
            " 'llamago_tpu_torch' in sys.modules]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [], True]


def test_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", "mistral-7b-q8.chat", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


@pytest.mark.chip
def test_run_without_the_program_fails_on_the_card(cuda, tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/ has no program
    to measure: the run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mistral-7b-q8.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
