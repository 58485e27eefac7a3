"""Time the engine recorder's records (llamago_tpu_torch/runtime/spans.py)
on this host: microseconds a `span`, a `wait` and a `step` record, each
the median of 7 loops of 100,000 records on a recorder of its own, and the
host's CPU model. Imports neither the model nor the card.

    python scripts/span_cost.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llamago_tpu_torch.runtime.spans import H2D, Recorder  # noqa: E402

N = 100_000


def _loop(record) -> float:
    t = time.perf_counter()
    for _ in range(N):
        with record():
            pass
    return (time.perf_counter() - t) / N * 1e6


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def main() -> None:
    out = {"cpu": cpu_model()}
    for name, make in (("span_us", lambda r: lambda: r.span("decode", None, 128, 4096)),
                       ("wait_us", lambda r: lambda: r.wait(H2D)),
                       ("step_us", lambda r: r.step)):
        out[name] = statistics.median(_loop(make(Recorder())) for _ in range(7))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
