"""What each rank of the parallel tests runs (tests/torch_ranks.py).

Every case is `fn(workdir, rank, **kwargs)`: it reads the test's inputs
from `workdir` (pickled numpy), runs the port on a mesh of the gloo CPU
ranks, and writes `<name>.rank<r>.pkl`. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
import uuid

import numpy as np
import torch

from torch_ranks import load, save

from llamago_tpu_torch.checkpoint.params import (
    load_parameters,
    params_from_numpy,
    random_quantized_parameters,
    to_torch,
    unstack_layer_params,
)
from llamago_tpu_torch.config import GenerateConfig, ModelConfig, ServerConfig
from llamago_tpu_torch.models.llama import forward_impl
from llamago_tpu_torch.parallel import make_mesh
from llamago_tpu_torch.parallel.tp_kernels import activate_mesh
from llamago_tpu_torch.runtime.kv_cache import KVCache


def _mesh(tp=1, dp=1, sp=1):
    mesh = make_mesh(tp=tp, dp=dp, sp=sp, devices=["cpu"] * (tp * dp * sp))
    activate_mesh(mesh)
    return mesh


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return list(tree.shape)


def forwards(workdir, rank, name: str, tp=1, dp=1, sp=1):
    """For each run of `<name>.pkl` ({"config", "params" (numpy tree),
    "tokens", "pos", "steps": [(tokens, pos)]}): the prefill forward's
    logits (all positions) and each decode step's, with this rank's leaf
    shapes and cache shape."""
    mesh = _mesh(tp, dp, sp)
    out = []
    for run in load(workdir, f"{name}.pkl"):
        config = ModelConfig(**run["config"])
        params = unstack_layer_params(
            params_from_numpy(run["params"], "cpu", mesh=mesh, config=config), config.n_layers)
        tokens = torch.from_numpy(run["tokens"])
        cache = KVCache.create(config, batch=tokens.shape[0], device="cpu", mesh=mesh)
        logits, cache = forward_impl(params, tokens, cache, torch.from_numpy(run["pos"]),
                                     config, return_all_logits=True)
        steps = []
        for tok, pos in run.get("steps", []):
            lg, cache = forward_impl(params, torch.from_numpy(tok), cache,
                                     torch.from_numpy(pos), config)
            steps.append(_np(lg))
        out.append({"logits": _np(logits), "steps": steps, "shapes": _shapes(params["layers"][0]),
                    "head": _shapes(params["output"]), "cache": list(cache.k[0].shape)})
    save(workdir, f"{name}.rank{rank}.pkl", out)


def matmuls(workdir, rank, name: str, tp=1, dp=1):
    """maybe_tp_matmul on this rank's block of each leaf ({"x", "leaf",
    "kind"} runs; a dp run takes this rank's rows of x)."""
    from llamago_tpu_torch.parallel.sharding import shard_leaf
    from llamago_tpu_torch.parallel.tp_kernels import maybe_tp_matmul

    mesh = _mesh(tp, dp)
    out = []
    for run in load(workdir, f"{name}.pkl"):
        leaf = {k: to_torch(v, "cpu") for k, v in run["leaf"].items()}
        x = torch.from_numpy(run["x"])
        kind = run["kind"]
        if kind is not None:
            leaf = shard_leaf(leaf, kind, tp, mesh.coord("tp"))
        if kind == "row":
            x = x[..., mesh.coord("tp") * (x.shape[-1] // tp):][..., :x.shape[-1] // tp]
        if dp > 1:
            n = x.shape[0] // dp
            x = x[mesh.coord("dp") * n:(mesh.coord("dp") + 1) * n]
        y = maybe_tp_matmul(x, leaf, kind)
        out.append(_np(y))
    save(workdir, f"{name}.rank{rank}.pkl", out)


def attention_sp(workdir, rank, name: str, tp=1, sp=1):
    """attention_math_sp on this rank's heads and positions of each run
    ({"q", "k", "v", "pos"[, "ks", "vs"]})."""
    from llamago_tpu_torch.ops.attention import attention_math_sp

    mesh = _mesh(tp=tp, sp=sp)
    out = []
    for run in load(workdir, f"{name}.pkl"):
        t = {k: torch.from_numpy(v) for k, v in run.items()}
        h, kv, s = t["q"].shape[2], t["k"].shape[1], t["k"].shape[2]
        i, j = mesh.coord("tp"), mesh.coord("sp")
        q = t["q"][:, :, i * h // tp:(i + 1) * h // tp]
        heads = slice(i * kv // tp, (i + 1) * kv // tp)
        rows = slice(j * s // sp, (j + 1) * s // sp)
        scales = [t[k][:, heads, rows] for k in ("ks", "vs")] if "ks" in t else [None, None]
        o = attention_math_sp(q, t["k"][:, heads, rows], t["v"][:, heads, rows], t["pos"],
                              mesh, *scales)
        out.append(_np(o))
    save(workdir, f"{name}.rank{rank}.pkl", out)


def _record_jobs(engine) -> dict:
    """Every job the engine is given, by id."""
    records: dict = {}
    submit = engine.submit

    def recorded(prompt, gen, job_id=None):
        job = submit(prompt, gen, job_id=job_id)
        records[job.id] = job
        return job

    engine.submit = recorded
    return records


def _engine(workdir, mesh, slots: int = 2):
    """The Engine of `engine.pkl` ({"config", "tensors" (ggjt numpy),
    "vocab"}) on this rank's blocks, loaded through load_parameters."""
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.tokenizer import Vocab

    inp = load(workdir, "engine.pkl")
    config = ModelConfig(**inp["config"])
    params = unstack_layer_params(
        load_parameters(config, inp["tensors"], device="cpu", mesh=mesh), config.n_layers)
    return Engine(config, params, Vocab(inp["vocab"]), slots=slots, decode_chunk_size=1,
                  device="cpu"), inp


def engine_greedy(workdir, rank, tp=1, sp=1, dp=1):
    """Warm the Engine (the wipe must keep the rank's cache block), then run
    the prompts of engine.pkl greedily to their end: each job's tokens."""
    from llamago_tpu_torch.runtime.engine import JobStatus

    mesh = _mesh(tp, dp, sp)
    engine, inp = _engine(workdir, mesh)
    before = list(engine.cache.k[0].shape)
    engine.warmup()
    assert list(engine.cache.k[0].shape) == before
    gen = GenerateConfig(**inp["gen"])
    jobs = [engine.submit(p, gen) for p in inp["prompts"]]
    for _ in range(400):
        engine.step()
        if all(j.status in (JobStatus.FINISHED, JobStatus.FAILED) for j in jobs):
            break
    save(workdir, f"engine.rank{rank}.pkl", {
        "tokens": [j.output_tokens for j in jobs], "status": [j.status.value for j in jobs],
        "errors": [j.error for j in jobs], "cache": before})


def _http(port: int, path: str, body: dict | None = None, tries: int = 100) -> dict:
    url = f"http://127.0.0.1:{port}{path}"
    for i in range(tries):
        try:
            data = None if body is None else json.dumps(body).encode()
            with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=30) as r:
                return json.loads(r.read())
        except OSError:
            if i == tries - 1:
                raise
            time.sleep(0.1)
    raise AssertionError("unreachable")


def lockstep_serve(workdir, rank, http_port: int, tp=1, dp=1, sp=1, embed: bool = False,
                   deadline: bool = False):
    """serve_lockstep with rank 0's JobServer on `http_port`: a client on
    rank 0 posts the prompts of engine.pkl (and, with `embed`, one
    /v1/embeddings request; with `deadline`, one job of a 1e-9 s deadline
    whose expiry rank 0 decides), waits for them, and sets the stop flag
    that ends every rank. Each rank writes the jobs it ran, by id."""
    from llamago_tpu_torch.parallel.multihost import serve_lockstep
    from llamago_tpu_torch.server.api import JobServer

    mesh = _mesh(tp, dp, sp)
    engine, inp = _engine(workdir, mesh)
    records = _record_jobs(engine)
    result: dict = {}
    if rank != 0:
        def not_here(*_):
            raise AssertionError("only rank 0 decides deadline expiry")

        engine.expired_job_ids = not_here
        serve_lockstep(engine, None)
    else:
        server = JobServer(engine, ServerConfig(host="127.0.0.1", port=http_port),
                           GenerateConfig(**inp["gen"]), model_name="tiny")
        done = threading.Event()

        def client():
            try:
                ids = []
                for p in inp["prompts"]:
                    jid = str(uuid.uuid4())
                    _http(http_port, "/jobs/", {"id": jid, "prompt": p})
                    ids.append(jid)
                if deadline:
                    engine.submit("a deadline", GenerateConfig(**{**inp["gen"], "max_tokens": 64,
                                                                  "deadline_s": 1e-9}))
                if embed:
                    result["embedding"] = _http(http_port, "/v1/embeddings", {"input": "hello"})
                for jid in ids:
                    for _ in range(600):
                        if _http(http_port, f"/jobs/status/{jid}")["status"] in ("finished",
                                                                                   "failed"):
                            break
                        time.sleep(0.05)
                result["jobs"] = [_http(http_port, f"/jobs/{jid}") for jid in ids]
            finally:
                done.set()

        threading.Thread(target=client, daemon=True).start()
        serve_lockstep(engine, server, stop_when=done.is_set)
    save(workdir, f"serve.rank{rank}.pkl", {
        "jobs": {jid: {"tokens": j.output_tokens, "status": j.status.value, "error": j.error,
                       "prompt": j.prompt, "seed": j.gen.seed}
                 for jid, j in records.items()},
        "result": result})


def agreement(workdir, rank):
    """agree() on a submission with seed -1, broadcast_pytree, and one
    all_reduce over a mesh's tp group."""
    from llamago_tpu_torch.parallel.mesh import all_reduce
    from llamago_tpu_torch.parallel.multihost import agree, broadcast_pytree, is_primary

    assert is_primary() == (rank == 0)
    subs = [{"id": "j1", "prompt": "hello", "gen": {"seed": -1}}] if rank == 0 else []
    got = agree(subs)
    echoed = broadcast_pytree({"from": rank})
    mesh = _mesh(tp=2)
    total = all_reduce(torch.full((3,), float(rank + 1)), mesh, "tp")
    save(workdir, f"agree.rank{rank}.pkl", {"subs": got, "echo": echoed,
                                           "sum": total.tolist()})


def random_quantized(workdir, rank, tp=2, weight_dtype="int8"):
    """random_quantized_parameters on this rank's blocks."""
    config = ModelConfig(**load(workdir, "config.pkl")).replace(weight_dtype=weight_dtype)
    mesh = _mesh(tp)
    params = random_quantized_parameters(config, seed=3, device="cpu", mesh=mesh)
    flat = {"output": {k: v.numpy() for k, v in params["output"].items()},
            "wq": {k: v.numpy() for k, v in params["layers"][1]["wq"].items()},
            "wo": {k: v.numpy() for k, v in params["layers"][1]["wo"].items()}}
    save(workdir, f"rq.rank{rank}.pkl", flat)


def lockstep_stop(workdir, rank):
    """serve_lockstep whose stop flag rank 0 raises at its third tick: the
    engine steps each rank ran."""
    from llamago_tpu_torch.parallel.multihost import serve_lockstep

    engine, _ = _engine(workdir, _mesh(tp=2))
    ticks = 0
    step = engine.step

    def counted():
        nonlocal ticks
        ticks += 1
        return step()

    engine.step = counted
    calls = iter(range(1, 100))
    serve_lockstep(engine, None, poll_interval=0.0,
                   stop_when=(lambda: next(calls) >= 3) if rank == 0 else None)
    save(workdir, f"stop.rank{rank}.pkl", {"ticks": ticks})
