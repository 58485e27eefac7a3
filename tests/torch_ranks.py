"""Gloo CPU ranks of the PyTorch port for the parallel tests.

`run_ranks(fn, world, workdir, **kwargs)` starts `world` processes of this
file; each joins one torch.distributed world on a free port through the
port's `initialize_distributed` (device "cpu") and calls
`torch_rank_cases.<fn>(workdir, rank, **kwargs)`. A case reads its inputs
from `workdir` (written by the test) and writes its outputs there; the test
reads them back. The ranks never import JAX. Every run has its own
timeout: a rank that hangs (a rendezvous or a collective that never
completes) fails the test instead of stalling the suite.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn: str, world: int, workdir, timeout: float = 120, **kwargs) -> list[str]:
    """Run case `fn` on `world` ranks; returns each rank's output text.
    Raises if a rank fails or the run outlasts `timeout` seconds."""
    workdir = str(workdir)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), fn, str(world), str(r), str(port),
         workdir, json.dumps(kwargs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"ranks of {fn} did not finish in {timeout} s") from None
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {fn} failed:\n{out[-4000:]}"
    return outs


def save(workdir, name: str, obj) -> None:
    with open(os.path.join(str(workdir), name), "wb") as f:
        pickle.dump(obj, f)


def load(workdir, name: str):
    with open(os.path.join(str(workdir), name), "rb") as f:
        return pickle.load(f)


def _main(fn: str, world: int, rank: int, port: int, workdir: str, kwargs: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, HERE)
    import torch_rank_cases

    from llamago_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        getattr(torch_rank_cases, fn)(workdir, rank, **json.loads(kwargs))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
          sys.argv[6])
