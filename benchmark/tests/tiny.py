"""A tiny cell for the CPU tests, added to a temporary copy of the benchmark
as new files and entries only: a configuration, a traffic mix, its limits
and its workload, each found by name as a real cell's are."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.tests.conftest import ROOT

TINY_CONFIG = {
    "source": "a test configuration", "architectures": ["MistralForCausalLM"],
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 512,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "formats": {"weights": "q8_0", "compute": "bfloat16", "kv_cache": "bfloat16"},
    "reduced": [], "assumed": {}}

TINY_MIX = {
    "kind": "serve", "why": "a test mix", "slots": 4, "clients": 4, "context": 256,
    "prefill_chunk": 32, "decode_chunk": 4,
    "prompt_tokens": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8, "max": 100},
    "output_tokens": {"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 40},
    "sampling": {"temp": 0.5, "top_k": 40, "top_p": 0.95, "repeat_penalty": 1.1,
                 "repeat_last_n": 1024},
    "greedy_share": 0.5, "ramp_steps": 4,
    "check": {"max_requests": 16, "target_tokens": 300, "min_tokens": 10}}

# The widest gap the tiny cell allows: its bf16 runs on the CPU read 0 to
# 0.041 over 8 seeds and window lengths of 0.3-2.5 s, the fp8 control 0.25
# to 0.81.
TINY_LIMIT = 0.15


def make_root(tmp, name: str = "tiny", kv_cache: str = "bfloat16", n_kv_heads: int = 2,
              limit: float = TINY_LIMIT, mix: dict | None = None) -> str:
    """A copy of BENCHMARK.json and benchmark/ under tmp, plus a tiny cell
    `<name>.chat` that reports every metric of the chat cells."""
    root = os.path.join(str(tmp), "checkout")
    if not os.path.exists(root):
        os.makedirs(root)
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
        shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(root, "benchmark")
    cfg = dict(TINY_CONFIG, num_key_value_heads=n_kv_heads,
               formats=dict(TINY_CONFIG["formats"], kv_cache=kv_cache))
    with open(os.path.join(b, "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", f"{name}.json"), "w") as f:
        json.dump(mix or TINY_MIX, f)
    cell = f"{name}.chat"
    with open(os.path.join(b, "limits", f"{cell}.json"), "w") as f:
        json.dump({"max_logit_gap": {"limit": limit}}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": name, "source": "test",
                             "file": f"benchmark/configs/{name}.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": cell, "config": name, "traffic": name, "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mistral-7b-q8.chat" in m.get("workloads", []):
            m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def run_tiny(root: str, cell: str = "tiny.chat", seed: int = 7, seconds: float = 2.0,
             trace: bool = False, control: bool = False) -> dict:
    """The test-only entry: the harness on the CPU (run.py refuses to), on
    one CPU thread, which the tiny model's small operations run fastest on
    and which keeps parallel test workers from starving each other."""
    import torch

    from benchmark import core

    torch.set_num_threads(1)
    ctx = core.make_ctx(root, cell, seed, seconds, trace, torch.device("cpu"), control=control)
    return core.run_cell(ctx)
