"""What each rank of the parallel tests runs (tests/torch_ranks.py).

Every case is `fn(workdir, rank, **kwargs)`: it reads the test's inputs
from `workdir` (pickled numpy), runs the port on a mesh of the gloo CPU
ranks, and writes `<name>.rank<r>.pkl`. Nothing here imports JAX.
"""

from __future__ import annotations

import copy
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


# ------------------------------------------------------------- training

def _flat(tree, prefix: str = "", grads: bool = False) -> dict:
    """path ("layers/0/wq/lora_a") -> numpy of every tensor of a tree (its
    `.grad` with `grads`, where it has one)."""
    out: dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k, grads))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}", grads))
    elif isinstance(tree, torch.Tensor):
        t = tree.grad if grads else tree
        if t is not None:
            # a copy: the optimizer updates the tensors in place afterwards
            out[prefix] = t.detach().float().numpy().copy() if t.is_floating_point() else (
                t.numpy().copy())
    return out


def _set_whole(tree, whole: dict, config, mesh, key_name: str) -> None:
    """Put the whole adapter halves `whole` ({path: numpy}, e.g. every B)
    into a wrapped tree, as this rank's block where the leaf is cut."""
    from llamago_tpu_torch.parallel.sharding import block_kind

    for i, lp in enumerate(tree["layers"]):
        for key, node in lp.items():
            path = f"layers/{i}/{key}/{key_name}"
            if path not in whole:
                continue
            w = torch.from_numpy(np.ascontiguousarray(whole[path], np.float32))
            kind = block_kind(key, node, config, mesh)
            dim = {"lora_b": "col", "lora_a": "row"}[key_name]
            if kind == dim:
                ax = -1 if dim == "col" else -2
                n = w.shape[ax] // mesh.tp
                w = w.narrow(ax, mesh.coord("tp") * n, n).contiguous()
            node[key_name] = w


def _model_on_mesh(run, mesh):
    """A run's model on this rank (from a copy of its numpy tree: a leaf
    kept whole shares its numpy array, which training updates in place)."""
    config = ModelConfig(**run["config"])
    params = unstack_layer_params(
        params_from_numpy(copy.deepcopy(run["params"]), "cpu", mesh=mesh, config=config),
        config.n_layers)
    lo = run.get("lora")
    init_a = {}
    if lo is not None:
        from llamago_tpu_torch.models import lora

        params = lora.init_lora(params, rank=lo["rank"], alpha=lo["alpha"], seed=lo["seed"],
                                config=config)
        init_a = {k: v for k, v in _flat(params).items() if k.endswith("lora_a")}
        for half in ("lora_a", "lora_b"):
            _set_whole(params, lo.get(half[-1], {}), config, mesh, half)
    return config, params, init_a


def _steps(run, config, params, steps):
    """(optimizer, losses, the first step's gradients and parameters) of
    `steps` train steps (LoRA where the run says)."""
    from llamago_tpu_torch.models import lora, training

    if run.get("lora") is not None:
        opt = lora.init_lora_opt_state(params)

        def step(p, o, x):
            return lora.lora_train_step(p, o, x, config)
    else:
        opt = training.make_optimizer(params)

        def step(p, o, x):
            return training.train_step(p, o, x, config)

    losses, first = [], None
    for i, tok in enumerate(steps):
        params, opt, loss = step(params, opt, torch.from_numpy(tok))
        losses.append(float(loss))
        if i == 0:
            first = {"grads": _flat(params, grads=True), "params": _flat(params)}
    return opt, losses, first


def train(workdir, rank, name: str, tp=1, dp=1, sp=1):
    """Each run of `<name>.pkl` ({"config", "params" (numpy, stacked and
    unfused), "steps": [tokens], optional "lora": {"rank", "alpha", "seed",
    "b": {path: whole B}, optional "a" the same for A}, "resume": whether to also save after two steps,
    restore into a fresh tree and take the third, "remat": whether to also
    take loss_fn's gradients with and without remat}): each step's loss,
    the first step's gradients and parameters and the last step's
    parameters, all this rank's blocks."""
    mesh = _mesh(tp, dp, sp)
    out = []
    for run in load(workdir, f"{name}.pkl"):
        config, params, init_a = _model_on_mesh(run, mesh)
        _, losses, first = _steps(run, config, params, run["steps"])
        res = {"losses": losses, **first, "last": _flat(params), "init_a": init_a}
        if run.get("resume"):
            res["resumed"] = _resume(workdir, rank, run, mesh)
        if run.get("remat"):
            res["remat"] = [_loss_grads(run, mesh, remat) for remat in (True, False)]
        out.append(res)
    save(workdir, f"{name}.rank{rank}.pkl", out)


def _loss_grads(run, mesh, remat: bool) -> dict:
    """loss_fn's value and its raw gradients (before any sync) on the first
    batch, with and without remat."""
    from llamago_tpu_torch.models import lora, training

    config, params, _ = _model_on_mesh(run, mesh)
    ts = lora.adapter_tensors(params) if run.get("lora") else training.trainable(params)
    for t in ts:
        t.requires_grad_(True)
    loss = training.loss_fn(params, torch.from_numpy(run["steps"][0]), config, remat=remat)
    loss.backward()
    return {"loss": float(loss), "grads": _flat(params, grads=True)}


def _resume(workdir, rank, run, mesh) -> dict:
    """Two steps, save, restore into a fresh tree and optimizer, one more
    step: the parameters then (this rank's blocks)."""
    from llamago_tpu_torch.models import training

    config, params, _ = _model_on_mesh(run, mesh)
    opt, _, _ = _steps(run, config, params, run["steps"][:2])
    path = f"{workdir}/state"
    training.save_train_state(path, params, opt, 2)
    _, fresh, _ = _model_on_mesh(run, mesh)
    opt2 = training.make_optimizer(fresh, lr=5e-3)
    fresh, opt2, step = training.load_train_state(path, fresh, opt2)
    assert step == 2 and opt2.param_groups[0]["lr"] == 1e-4
    fresh, opt2, _ = training.train_step(fresh, opt2, torch.from_numpy(run["steps"][2]), config)
    return _flat(fresh)


def ppl(workdir, rank, name: str, tp=1, dp=1, sp=1):
    """perplexity() of each run of `<name>.pkl` ({"config", "params",
    "ids", "ctx", "min_context"}) and window 0's NLL, on this rank."""
    from llamago_tpu_torch.eval.perplexity import _window_nll, perplexity

    mesh = _mesh(tp, dp, sp)
    out = []
    for run in load(workdir, f"{name}.pkl"):
        config = ModelConfig(**run["config"])
        params = unstack_layer_params(
            params_from_numpy(run["params"], "cpu", mesh=mesh, config=config), config.n_layers)
        res = perplexity(params, config, run["ids"], ctx=run["ctx"],
                         min_context=run["min_context"])
        window = torch.from_numpy(np.asarray(run["ids"][:run["ctx"]], np.int64)[None])
        out.append({**res, "nll0": _np(_window_nll(params, window, config))})
    save(workdir, f"{name}.rank{rank}.pkl", out)


def merged(workdir, rank, tp=2):
    """load_parameters with adapters (merge.pkl: {"config", "tensors",
    "adapters"}): this rank's merged blocks."""
    mesh = _mesh(tp)
    inp = load(workdir, "merge.pkl")
    config = ModelConfig(**inp["config"])
    params = load_parameters(config, inp["tensors"], device="cpu", mesh=mesh,
                             adapters=inp["adapters"])
    save(workdir, f"merge.rank{rank}.pkl", _flat(params))


def collectives(workdir, rank):
    """The differentiable collectives of parallel/mesh.py on a tp = 2 mesh
    (coll.pkl: {"x" [4, 6], "w" [6, 4], "g" [4, 6]}): for each case the
    forward's value and x's gradient, where the loss's gradient on the
    case's output is the matching part of g (tests/test_torch_parallel_
    train.py holds them against one process's autograd)."""
    from llamago_tpu_torch.parallel.mesh import copy_to, gather_from, reduce_from, tp_slice

    mesh = _mesh(tp=2)
    inp = {k: torch.from_numpy(v) for k, v in load(workdir, "coll.pkl").items()}
    w, g = inp["w"], inp["g"]
    i = mesh.coord("tp")
    rows, cols2, cols3 = slice(3 * i, 3 * i + 3), slice(2 * i, 2 * i + 2), slice(3 * i, 3 * i + 3)
    cases = {
        # (output, its gradient)
        "copy_to": lambda x: (copy_to(x, mesh, "tp") @ w[:, cols2], g[:, :4][:, cols2]),
        "reduce_from": lambda x: (reduce_from(x[:, rows] @ w[rows], mesh, "tp"), g[:, :4]),
        "gather_from": lambda x: (gather_from(x[:, cols3], mesh, "tp"), g),
        "tp_slice": lambda x: (tp_slice(x, mesh), g[:, cols3]),
        "column_block": lambda x: (gather_from(copy_to(x, mesh, "tp") @ w[:, cols2], mesh, "tp"),
                                   g[:, :4]),
        "row_block": lambda x: (reduce_from(tp_slice(x, mesh) @ w[rows], mesh, "tp"), g[:, :4]),
    }
    out = {}
    for name, fn in cases.items():
        x = inp["x"].clone().requires_grad_(True)
        y, gy = fn(x)
        y.backward(gy)
        out[name] = {"y": _np(y), "dx": _np(x.grad)}
    save(workdir, f"coll.rank{rank}.pkl", out)


def dryrun(workdir, rank, n: int):
    """llamago_tpu_torch.dryrun.dryrun_multichip(n) on the CPU with the
    bf16 training parameters of dry.pkl (numpy, stacked)."""
    from llamago_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(n, device="cpu", params=load(workdir, "dry.pkl"))
    save(workdir, f"dry.rank{rank}.pkl", out)
