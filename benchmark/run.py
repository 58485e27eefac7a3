"""The benchmark of llamago_tpu_torch on one NVIDIA card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout and prints, as
its last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), `device`, with a trace `breakdown`, and last `check`, the
numbers compared with their limits (also the last lines of standard error).
It fails, printing no result, without a CUDA card (or with fewer than the
cell asks for), and if `jax`, `jaxlib`, `flax` or the JAX package
`llamago_tpu` is loaded once the window has closed. `--control` puts the
fp8 control (oracle.py) in the program's place in the comparison: the
line's `max_logit_gap` and `correct` are then the control's, and
`control` holds the program's own gap of the run. The cells' own runs
leave it off.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc builds go to <checkout>/build already)."""
    base = os.path.join(ROOT, "build", "bench-cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    a = p.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    from benchmark import core

    bench = core.load_benchmark(ROOT)
    chips = int(core.find_cell(bench, a.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no result: the cell needs {chips} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = core.make_ctx(ROOT, a.workload, a.seed, a.seconds, a.trace, device,
                        control=a.control, t_start=T_START)
    line = core.run_cell(ctx)
    found = core.forbidden_modules()
    if found:
        print(f"no result: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for s in core.check_lines(line):
        print(s, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
