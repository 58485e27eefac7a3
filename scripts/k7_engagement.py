"""How many K7 launches each prefill chunk of a benchmark cell makes.

    python scripts/k7_engagement.py <cell> <seed> [seconds] > engagement.json

Runs the cell from BENCHMARK.json on the card as `benchmark/run.py --trace
0` does (without its correctness check), with `Engine._prefill` wrapped so
that each chunk's launches of K7 (`flash_attention.launches_prefill` and
its bf16 form's `launches_prefill_tc`) and of K2 (`flash_attention.launches`)
are counted by the chunk's bucket, from the warm-up to the window's end.
Prints one JSON object: for each bucket the chunks and the least and most
K7 and K2 launches a chunk. LLAMAGO_ATTN_PREFILL_FLOOR in the environment
sets the route as it does for the program. Fails without a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counting(by_bucket: dict):
    """Wrap `Engine._prefill` on the class, its parameters kept (the
    benchmark's hooks wrap the instance's method over it)."""
    from llamago_tpu_torch.ops.attention import flash_attention as fa
    from llamago_tpu_torch.runtime.engine import Engine

    inner = Engine._prefill

    @functools.wraps(inner)
    def _prefill(self, slot_idx, ids, write_pos):
        before = (fa.launches_prefill, fa.launches_prefill_tc, fa.launches)
        inner(self, slot_idx, ids, write_pos)
        k7, k7_tc, k2 = (a - b for a, b in zip(
            (fa.launches_prefill, fa.launches_prefill_tc, fa.launches), before))
        rows = by_bucket.setdefault(self._bucket(len(ids)), [])
        rows.append((k7, k7_tc, k2))

    Engine._prefill = _prefill


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
    by_bucket: dict = {}
    _counting(by_bucket)
    run = serve.run(core.make_ctx(ROOT, cell, seed, seconds, 0, dev, t_start=T_START))
    out = {"cell": cell, "seed": seed, "card": core.power_limit(),
           "floor_env": os.environ.get("LLAMAGO_ATTN_PREFILL_FLOOR"),
           "prompt_tok_s": run.prompt_tokens / run.window_s,
           "output_tok_s": run.output_tokens / run.window_s, "buckets": {}}
    for bucket, rows in sorted(by_bucket.items()):
        out["buckets"][bucket] = {
            "chunks": len(rows),
            **{f"{name}_a_chunk": [min(r[i] for r in rows), max(r[i] for r in rows)]
               for i, name in enumerate(("k7", "k7_tc", "k2"))}}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
