"""Driver entry points of the port: the counterpart of `__graft_entry__.py`.

entry()              -> (forward step, example args) on the flagship LLaMA
                        structure (LLaMA-2-70B-style GQA, int8 weights) at
                        test scale, batch 1 x 8
dryrun_multichip(n)  -> on one rank of an initialized world of n processes:
                        one sharded bf16 train step over the (dp, sp, tp)
                        mesh the JAX function picks for n, then sharded
                        forwards of int8 weights over the bf16 cache and
                        over the int8 cache, and of w4x8 weights

    python -m llamago_tpu_torch.dryrun --n N [--device cpu]

spawns N rank processes here (ranks share the visible cards round robin,
so N = 2 runs on one card, its collectives over gloo) and runs both; each
rank fails on a non-finite loss or logit, or a wrong shape. It runs on the
card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys

import numpy as np
import torch

from llamago_tpu_torch.checkpoint.params import (
    params_from_numpy,
    random_parameters,
    unstack_layer_params,
)
from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.models.llama import forward_impl
from llamago_tpu_torch.models.training import make_optimizer, train_step
from llamago_tpu_torch.runtime.kv_cache import KVCache


def flagship_config(max_seq_len: int = 128) -> ModelConfig:
    """LLaMA-2-70B-style structure (GQA) at test scale, int8 weights."""
    return ModelConfig(vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
                       multiple_of=32, max_seq_len=max_seq_len, dtype="bfloat16",
                       weight_dtype="int8")


def entry(device="cuda"):
    """(fn, args): fn(params, tokens, cache, write_pos) -> logits [1, V],
    one prefill forward of 8 tokens on the flagship config."""
    config = flagship_config()
    params = random_parameters(config, seed=0, device=device)
    tokens = torch.ones((1, 8), dtype=torch.long)
    cache = KVCache.create(config, batch=1, device=device)
    write_pos = torch.zeros(1, dtype=torch.long)

    def fn(params, tokens, cache, write_pos):
        logits, _ = forward_impl(params, tokens, cache, write_pos, config)
        return logits

    return fn, (params, tokens, cache, write_pos)


def mesh_shape(n: int) -> tuple[int, int, int]:
    """(tp, dp, sp) of n ranks, as the JAX function picks them."""
    dp, sp = (2, 2) if n % 8 == 0 else (2, 1) if n % 4 == 0 else (1, 1)
    return n // (dp * sp), dp, sp


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x.float()).all())


def dryrun_multichip(n: int, device="cuda", params=None) -> dict:
    """One sharded train step and the sharded forwards on this rank of n
    (the world initialized, parallel/mesh.py:initialize_distributed).
    `params` (a numpy tree, stacked, of the bf16 training config) replaces
    the seeded random draw, so that another package's parameters can be
    carried across. Returns {"loss", "logits", "mesh"}."""
    from llamago_tpu_torch.parallel import make_mesh
    from llamago_tpu_torch.parallel.tp_kernels import activate_mesh

    tp, dp, sp = mesh_shape(n)
    mesh = make_mesh(tp=tp, dp=dp, sp=sp)
    activate_mesh(mesh)
    dev = mesh.device if mesh.world > 1 else torch.device(device)

    # bf16 weights for the training step (the optimizer needs dense leaves)
    config = flagship_config(max_seq_len=32).replace(weight_dtype="bfloat16")
    if params is None:
        params = random_parameters(config, seed=0, device=dev, mesh=mesh)
    else:
        params = params_from_numpy(params, dev, mesh=mesh, config=config)
    params = unstack_layer_params(params, config.n_layers)
    batch = dp * 2
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, config.vocab_size, (batch, 16)).astype(np.int64))
    opt = make_optimizer(params)
    params, opt, loss = train_step(params, opt, tokens, config)
    assert _finite(loss), "training loss is not finite"

    # sharded inference over the same mesh (tp weights, dp slots)
    icfg = config.replace(weight_dtype="int8")
    iparams = unstack_layer_params(random_parameters(icfg, seed=1, device=dev, mesh=mesh),
                                   icfg.n_layers)
    dec = torch.ones((batch, 4), dtype=torch.long)
    start = torch.zeros(batch, dtype=torch.long)
    cache = KVCache.create(icfg, batch=batch, device=dev, mesh=mesh)
    with torch.no_grad():
        logits, _ = forward_impl(iparams, dec, cache, start, icfg)
    assert tuple(logits.shape) == (batch, icfg.vocab_size) and _finite(logits)

    # the int8 KV cache over the same mesh (scale planes split like the
    # cache but for head_dim)
    qcfg = icfg.replace(kv_dtype="int8")
    qcache = KVCache.create(qcfg, batch=batch, device=dev, mesh=mesh)
    with torch.no_grad():
        qlogits, qcache = forward_impl(iparams, dec, qcache, start, qcfg)
    assert qcache.quantized and _finite(qlogits)

    # int4 weights in the w4x8 exec format: leaves whose K misses the
    # 128-group (this config's w2) stay Q4_0, a mixed tree
    saved = os.environ.get("LLAMAGO_INT4_EXEC")
    os.environ["LLAMAGO_INT4_EXEC"] = "w4x8"
    try:
        wcfg = icfg.replace(weight_dtype="int4")
        wparams = unstack_layer_params(random_parameters(wcfg, seed=2, device=dev, mesh=mesh),
                                       wcfg.n_layers)
        assert "q4x" in wparams["layers"][0]["wq"], "w4x8 exec not applied"
        wcache = KVCache.create(wcfg, batch=batch, device=dev, mesh=mesh)
        with torch.no_grad():
            wlogits, _ = forward_impl(wparams, dec, wcache, start, wcfg)
        assert _finite(wlogits)
    finally:
        if saved is None:
            os.environ.pop("LLAMAGO_INT4_EXEC", None)
        else:
            os.environ["LLAMAGO_INT4_EXEC"] = saved
    if mesh.rank == 0:
        print(f"dryrun_multichip OK: mesh dp={dp} sp={sp} tp={tp}, train loss "
              f"{float(loss):.4f}, decode logits {tuple(logits.shape)}", flush=True)
    return {"loss": float(loss), "logits": tuple(logits.shape), "mesh": mesh.shape}


def _rank(index: int, n: int, port: int, device: str) -> None:
    import torch.distributed as dist

    from llamago_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", n, index, device=device)
    try:
        dryrun_multichip(n, device=device)
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m llamago_tpu_torch.dryrun",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2, help="ranks of the dry run [2]")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available; pass --device cpu", file=sys.stderr)
        return 2
    fn, fargs = entry(args.device)
    with torch.no_grad():
        out = fn(*fargs)
    print(f"entry OK: {tuple(out.shape)}", flush=True)
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        mp.spawn(_rank, args=(args.n, port, args.device), nprocs=args.n, join=True)
    except (mp.ProcessExitedException, mp.ProcessRaisedException) as e:
        print(f"error: a rank of the dry run failed: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
