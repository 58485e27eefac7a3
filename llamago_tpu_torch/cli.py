"""CLI entry point of the port.

Counterpart of the JAX package's `cli.py`, with the same flags and
defaults plus `--device` (reference flags: main.go:24-41, defaults
main.go:352-382). One-shot mode streams the job's output as it grows and
prints the per-job report; `--server` serves the REST job API; `--chat`
is the interactive loop; `perplexity --file F` prints the perplexity of a
text file; `--spec` turns on prompt-lookup speculative decoding for
greedy requests; `finetune --file F` trains LoRA adapters over a text file
(the base frozen, quantized or not) and saves them as .npz, and `--lora A`
merges saved adapters into the weights at load. `--model` takes a ggjt or
a GGUF file (the magic decides).
The checkpoint tools: `quantize` (ggjt or GGUF f32/f16 -> Q8_0 / Q4_0 /
Q4_1 ggjt, or GGUF when --out ends in .gguf), `convert` (a Meta or HF
checkpoint directory -> ggjt, or GGUF for BPE-tokenizer models), `load`
(fetch a model file by name).

The port runs on CUDA unless `--device cpu` is given. The compute dtype
defaults to bfloat16 on CUDA and float32 on the CPU, and the decode chunk
to 32 tokens per host sync on CUDA and 1 on the CPU.

`--tp/--dp/--sp` run one process a rank (parallel/): without
`--coordinator` or `--multihost` this process spawns the tp*dp*sp ranks
here, one card each (it refuses when fewer cards are visible; the CPU takes
any number), and each rank re-enters `main` as `--coordinator
127.0.0.1:<port> --nprocs N --procid i`; `--coordinator host:port --nprocs
N --procid i` makes this process rank i of N on cuda:(i mod local cards),
and `--multihost` alone reads torchrun's environment. `--tp 0` takes
world // (dp*sp). Serving, `perplexity` and `finetune` run on the mesh
(`--lora` merges in the loader, before each rank's cut). Rank 0 owns HTTP
(`--server`), prints and writes; every rank runs the lockstep tick
(parallel/multihost.py) or the meshed step (models/training.py) and, at
the end, logs its kernels' launch counts as one JSON line on stderr.
`load`, `convert` and `quantize` run in one process.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading
import time

from llamago_tpu_torch.utils import colorize, log

LOGO = r"""
  _ _                                        _
 | | | __ _ _ __ ___   __ _        __ _  ___| |_ _ __  _   _
 | | |/ _` | '_ ` _ \ / _` |_____ / _` |/ _ \ __| '_ \| | | |
 | | | (_| | | | | | | (_| |_____| (_| | (_) | |_| |_) | |_| |
 |_|_|\__,_|_| |_| |_|\__,_|      \__, |\___/ \__| .__/ \__,_|
                                  |___/          |_|
 LLaMA inference  (PyTorch / CUDA)
"""

_COMMANDS = ("load", "convert", "quantize", "perplexity", "finetune")
# what runs on a mesh of ranks: serving (no command), perplexity, finetune
_MESH_COMMANDS = (None, "perplexity", "finetune")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="llamago-tpu-torch", description="LLaMA inference on PyTorch/CUDA")
    p.add_argument("command", nargs="?", default=None,
                   help="optional subcommand: load | convert | quantize | "
                        "perplexity | finetune")
    p.add_argument("--file", default="", help="text file for `perplexity`/`finetune`")
    p.add_argument("--out", default="",
                   help="output path for `quantize`/`convert`/`finetune`")
    p.add_argument("--vocab-only", action="store_true",
                   help="`convert`: write only the scored vocab, no tensors")
    p.add_argument("--qkind", default="", choices=["", "q8_0", "q4_0", "q4_1"],
                   help="quantization kind for `quantize` (overrides --bits)")
    p.add_argument("--bits", type=int, default=8, choices=[4, 8],
                   help="bit width for `quantize` [8]")
    # --- reference flag parity (main.go:24-41)
    p.add_argument("--prompt", default="", help="text prompt to feed the model")
    p.add_argument("--model", default="",
                   help="path of a ggjt (.bin) or GGUF model file; `convert`: the "
                        "checkpoint directory; `load`: the file name to fetch")
    p.add_argument("--server", action="store_true", help="start REST API server mode")
    p.add_argument("--host", default="localhost", help="server host [localhost]")
    p.add_argument("--port", type=int, default=8080, help="server port [8080]")
    p.add_argument("--pods", type=int, default=1,
                   help="parallel decode slots in server mode [1]")
    p.add_argument("--threads", type=int, default=0,
                   help="host CPU threads for PyTorch's CPU ops and the native "
                        "quantizers [0 = default]")
    p.add_argument("--context", type=int, default=1024, help="context size [1024]")
    p.add_argument("--predict", type=int, default=512, help="tokens to predict [512]")
    p.add_argument("--temp", type=float, default=0.5, help="temperature [0.5]")
    p.add_argument("--silent", action="store_true", help="hide logo and extra output")
    p.add_argument("--chat", action="store_true", help="interactive chat mode")
    p.add_argument("--dir", default=".", help="download dir for `load`")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace into ./profile/")
    # accepted for drop-in compatibility with llama.go invocations
    p.add_argument("--avx", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--neon", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--debug", action="store_true",
                   help="engine invariant asserts (utils/debug.py)")
    # --- sampling knobs
    p.add_argument("--topk", type=int, default=40)
    p.add_argument("--topp", type=float, default=0.95)
    p.add_argument("--repeat-penalty", type=float, default=1.10)
    p.add_argument("--repeat-last-n", type=int, default=0,
                   help="penalty window [default: context size]")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--stop-at-eos", action="store_true",
                   help="stop at EOS (the reference never does; parity default off)")
    # --- device and numerics
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run [cuda]")
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                   help="compute dtype [default: bfloat16 on cuda, float32 on cpu]")
    p.add_argument("--weight-dtype", default=None,
                   choices=["bfloat16", "float32", "int8", "int4"],
                   help="weight storage [default: same as --dtype]")
    p.add_argument("--kv-dtype", default="auto",
                   choices=["auto", "bfloat16", "float32", "int8"],
                   help="KV-cache storage [auto = compute dtype]")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel size [0 = all local devices]")
    p.add_argument("--dp", type=int, default=1, help="data-parallel size [1]")
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel size [1]")
    p.add_argument("--chunk", type=int, default=0,
                   help="decode chunk size (tokens per host sync) "
                        "[0 = auto: 32 on cuda, 1 on cpu]")
    p.add_argument("--spec", action="store_true",
                   help="prompt-lookup speculative decoding for greedy requests")
    p.add_argument("--prefill-buckets", default="",
                   help="comma-separated prefill pad lengths "
                        "[default: 16,32,...,4096 capped at --context]")
    p.add_argument("--prefill-chunk", type=int, default=256,
                   help="max prompt tokens absorbed per engine step [256]")
    p.add_argument("--draft", type=int, default=7, help="speculative draft length [7]")
    # --- LoRA fine-tuning
    p.add_argument("--rank", type=int, default=8, help="LoRA rank [8]")
    p.add_argument("--lora-alpha", type=float, default=16.0,
                   help="LoRA alpha (scale = alpha/rank) [16]")
    p.add_argument("--lr", type=float, default=1e-3, help="finetune learning rate [1e-3]")
    p.add_argument("--steps", type=int, default=100, help="finetune optimizer steps [100]")
    p.add_argument("--train-batch", type=int, default=2,
                   help="finetune batch size (sequences/step) [2]")
    p.add_argument("--seq", type=int, default=256,
                   help="finetune sequence length [256, capped by --context]")
    p.add_argument("--lora", default="", help="adapters .npz to apply at load")
    # --- multi-host flags (the parallel slice)
    p.add_argument("--multihost", action="store_true",
                   help="initialize a multi-process run before touching devices")
    p.add_argument("--coordinator", default="", help="coordinator address host:port")
    p.add_argument("--nprocs", type=int, default=0,
                   help="total process count for --coordinator mode")
    p.add_argument("--procid", type=int, default=-1,
                   help="this process's id for --coordinator mode")
    return p


def _grid(args, n: int) -> tuple[int, int, int]:
    """(tp, dp, sp); --tp 0 takes n // (dp * sp) of n devices or ranks."""
    dp, sp = max(args.dp, 1), max(args.sp, 1)
    return (args.tp if args.tp > 0 else max(n // (dp * sp), 1)), dp, sp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned_rank(index: int, argv: list[str]) -> None:
    """A locally spawned rank: main() as rank `index` of the coordinator's
    world."""
    code = main(argv + ["--procid", str(index)])
    if code:
        raise SystemExit(code)


def _spawn_ranks(argv: list[str], world: int) -> int:
    """Run this command as `world` local processes, one a rank."""
    import torch.multiprocessing as mp

    argv = argv + ["--coordinator", f"127.0.0.1:{_free_port()}", "--nprocs", str(world)]
    try:
        mp.spawn(_spawned_rank, args=(argv,), nprocs=world, join=True)
    except mp.ProcessExitedException as e:
        print(f"error: rank {e.error_index} exited with code {e.exit_code}", file=sys.stderr)
        return e.exit_code or 1
    except mp.ProcessRaisedException as e:
        print(f"error: a rank failed: {e}", file=sys.stderr)
        return 1
    return 0


def _join_mesh(args):
    """This process as a rank of --coordinator / --multihost's world: the
    mesh of --tp/--dp/--sp over it, made active."""
    import torch.distributed as dist

    from llamago_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from llamago_tpu_torch.parallel.tp_kernels import activate_mesh

    initialize_distributed(coordinator=args.coordinator or None,
                           num_processes=args.nprocs or None,
                           process_id=args.procid if args.procid >= 0 else None,
                           device=args.device)
    world = dist.get_world_size()
    tp, dp, sp = _grid(args, world)
    if tp * dp * sp != world:
        raise ValueError(f"--tp {tp} --dp {dp} --sp {sp} make {tp * dp * sp} ranks, "
                         f"the world has {world} processes")
    mesh = make_mesh(tp=tp, dp=dp, sp=sp)
    activate_mesh(mesh)
    return mesh


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    ranked = bool(args.multihost or args.coordinator)
    if ranked:
        import torch.distributed as dist

        if args.procid > 0 or (args.multihost and int(os.environ.get("RANK", "0")) > 0):
            args.silent = True  # rank 0 prints

    if args.threads > 0:
        import torch

        torch.set_num_threads(args.threads)
        # also read by the native C++ data path (native/__init__.py)
        os.environ["LLAMAGO_THREADS"] = str(args.threads)

    if args.command is not None and args.command not in _COMMANDS:
        print(f"unknown command: {args.command}", file=sys.stderr)
        return 2
    if not ranked and args.command in _MESH_COMMANDS and args.model:
        from llamago_tpu_torch.parallel.mesh import check_local_devices

        tp, dp, sp = _grid(args, _cuda_count() if args.device != "cpu" else 1)
        if tp * dp * sp > 1:
            try:
                check_local_devices(args.device, tp * dp * sp)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
            return _spawn_ranks(argv, tp * dp * sp)
    if not args.silent:
        colorize("[magenta]" + LOGO)
    if (ranked or max(args.tp, args.dp, args.sp) > 1) and args.command not in _MESH_COMMANDS:
        print(f"error: `{args.command}` runs in one process: --tp/--dp/--sp and the "
              "multi-process flags do not apply", file=sys.stderr)
        return 2
    if ranked:
        try:
            mesh = _join_mesh(args)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            dist.destroy_process_group()
            return 2
        try:
            return _main(args)
        finally:
            _log_rank(mesh)
            dist.destroy_process_group()
    return _main(args)


def _cuda_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _main(args) -> int:

    if args.command == "load":
        return cmd_load(args)
    if args.command == "convert":
        return cmd_convert(args)
    if args.command == "quantize":
        return cmd_quantize(args)
    if not args.model and args.command is None:
        print("error: --model is required (or use the `load`/`convert` commands)",
              file=sys.stderr)
        return 2

    if args.debug:
        from llamago_tpu_torch.utils.debug import enable_debug_checks

        enable_debug_checks()

    prof = None
    if args.profile:
        import torch

        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    try:
        if args.command == "perplexity":
            return cmd_perplexity(args)
        if args.command == "finetune":
            return cmd_finetune(args)
        return run(args)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs("profile", exist_ok=True)
            prof.export_chrome_trace(os.path.join("profile", "trace.json"))
            if not args.silent:
                print("\n[PROF] trace written to ./profile/trace.json")


def _load_engine(args):
    """Load checkpoint -> device params -> engine."""
    from llamago_tpu_torch.checkpoint.gguf import read_checkpoint
    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        load_parameters,
        unstack_layer_params,
    )
    from llamago_tpu_torch.parallel.tp_kernels import active_mesh
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.utils.device import resolve_device

    mesh = active_mesh()
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if args.dtype is None:
        args.dtype = "bfloat16" if device.type == "cuda" else "float32"
    t0 = time.time()
    if not args.silent:
        log("info", f"loading model {args.model} ...")
    # magic-sniffing loader: ggjt v1 or GGUF (llama.cpp ecosystem)
    ckpt = read_checkpoint(args.model, max_seq_len=args.context)
    file_quantized = ckpt.ftype in (2, 3, 7)  # Q4_0 / Q4_1 / Q8_0
    config = ckpt.config.replace(
        dtype=args.dtype,
        # a pre-quantized file dictates the weight storage
        weight_dtype=(ckpt.config.weight_dtype if file_quantized
                      else args.weight_dtype or args.dtype),
        kv_dtype=args.kv_dtype,
        max_seq_len=args.context,
    )
    # saved adapters merge into the weights at load: serving runs the plain
    # kernel path afterwards, with no per-step cost. Adapters on split
    # projections (trained under tp) merge in the loader, into each whole
    # layer leaf before a rank's cut; adapters on the fused wqkv / w13 (one
    # card) merge into the fused leaves, which exist at tp = 1 only.
    adapters = fused = None
    if args.lora:
        from llamago_tpu_torch.models.lora import load_lora

        adapters = load_lora(args.lora)
        fused = _names_fused(adapters)
    params = load_parameters(config, ckpt.tensors, device=device, mesh=mesh,
                             adapters=None if fused else adapters)
    params = unstack_layer_params(params, config.n_layers)
    if mesh is None or mesh.tp == 1:
        # fused wqkv / w13; a rank's blocks under tp stay unfused, as the
        # JAX package keeps them under a mesh
        params = fuse_layer_weights(params)
    if fused:
        from llamago_tpu_torch.models.lora import attach_lora, merge_lora

        params = merge_lora(attach_lora(params, adapters))
    if args.lora and not args.silent:
        log("info", f"merged LoRA adapters from {args.lora}")
    if not args.silent:
        log("info", f"model ready in {time.time() - t0:.1f}s",
            layers=config.n_layers, dim=config.dim,
            weights=config.weight_dtype, device=str(device),
            **({} if mesh is None else mesh.shape))
    chunk = args.chunk or (32 if device.type == "cuda" else 1)
    kwargs = {}
    if args.prefill_buckets:
        kwargs["buckets"] = tuple(sorted(int(b) for b in args.prefill_buckets.split(",")))
    engine = Engine(config, params, ckpt.vocab, slots=args.pods,
                    decode_chunk_size=chunk, speculative=args.spec,
                    draft_len=args.draft, prefill_chunk=args.prefill_chunk,
                    device=device, **kwargs)
    return engine, ckpt, config


def _names_fused(adapters) -> bool:
    """Whether an adapter subtree names the fused wqkv / w13 leaves."""
    la = adapters.get("layers") if isinstance(adapters, dict) else None
    keys = set(la) if isinstance(la, dict) else {k for layer in la or () for k in layer}
    return bool(keys & {"wqkv", "w13"})


def cmd_load(args) -> int:
    """Download a model file (reference: downloadModel, main.go:435-463)."""
    import urllib.request

    if not args.model:
        print("error: --model names the file to download", file=sys.stderr)
        return 2
    url = f"https://nogpu.com/{args.model}"
    dest = os.path.join(args.dir, args.model)
    print(f"[LOAD] downloading {url} -> {dest}")
    try:
        urllib.request.urlretrieve(url, dest)
    except Exception as e:  # noqa: BLE001 — report any network failure
        print(f"[ERROR] model was not downloaded: {e}", file=sys.stderr)
        return 1
    size = os.path.getsize(dest)
    if size < 1024 * 1024:  # sanity check >1MB, parity main.go:455-459
        print("[ERROR] downloaded file is suspiciously small", file=sys.stderr)
        return 1
    print(f"[LOAD] model of size {size / 2**30:.2f} GiB downloaded")
    return 0


def cmd_quantize(args) -> int:
    """ggjt or GGUF f32/f16 -> Q8_0 / Q4_0 / Q4_1 (llama.cpp-compatible bit
    layout; --out ending in .gguf writes GGUF). The native C++ quantizers
    run where g++ can build them; `native=` says whether they did."""
    if not args.model:
        print("error: quantize needs --model <ggjt file>", file=sys.stderr)
        return 2
    from llamago_tpu_torch import native
    from llamago_tpu_torch.checkpoint.quant_file import quantize_ggjt

    kind = args.qkind or ("q8_0" if args.bits == 8 else "q4_0")
    out = args.out or args.model.replace(".bin", f"-{kind}.bin")
    t0 = time.time()
    quantize_ggjt(args.model, out, kind)
    print(f"[QUANT] wrote {out} ({kind}, native={native.available()}) "
          f"in {time.time() - t0:.1f}s")
    return 0


def cmd_convert(args) -> int:
    from llamago_tpu_torch.checkpoint.convert import convert_cli

    return convert_cli(args)


def cmd_perplexity(args) -> int:
    """Perplexity over a text file (the BASELINE.md quality metric), in
    windows of min(--context, 512) tokens."""
    if not args.model or not args.file:
        print("error: perplexity needs --model and --file", file=sys.stderr)
        return 2
    engine, ckpt, config = _load_engine(args)
    with open(args.file, encoding="utf-8") as f:
        text = f.read()
    from llamago_tpu_torch.eval import perplexity
    from llamago_tpu_torch.tokenizer import tokenize

    ids = tokenize(ckpt.vocab, " " + text, bos=True)
    ctx = min(args.context, 512)
    result = perplexity(engine.params, config, ids, ctx=ctx)
    from llamago_tpu_torch.parallel.multihost import is_primary

    if is_primary():  # every rank ran the windows; rank 0 prints
        print(f"[PPL] perplexity {result['ppl']:.4f} | nll {result['nll']:.4f} | "
              f"{result['n_tokens']} tokens in {result['n_windows']} windows "
              f"(ctx {ctx}, {config.weight_dtype} weights)")
    return 0


def cmd_finetune(args) -> int:
    """LoRA / QLoRA fine-tuning over a text file (models/lora.py): the base
    stays frozen (a quantized base streams through the quantized matmul
    kernels, whose autograd Function freezes it) and rank-r adapters train
    with AdamW. Saves a small .npz; serve it with `--lora` (merged at load,
    so serving speed is unchanged). Under a mesh every rank draws the same
    batches from --seed and runs the meshed step (a dp rank trains on its
    rows); rank 0 prints and writes the whole adapters."""
    if not args.model or not args.file:
        print("error: finetune needs --model and --file", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    from llamago_tpu_torch.models import lora
    from llamago_tpu_torch.parallel.multihost import is_primary
    from llamago_tpu_torch.tokenizer import tokenize

    engine, ckpt, config = _load_engine(args)
    params, device = engine.params, engine.device
    engine = None  # its cache is not needed for training

    with open(args.file, encoding="utf-8") as f:
        text = f.read()
    ids = np.asarray(tokenize(ckpt.vocab, " " + text, bos=True), np.int32)
    seq = min(args.seq, args.context)
    n_blocks = len(ids) // seq
    if n_blocks == 0:
        print(f"error: --file tokenizes to {len(ids)} tokens, fewer than "
              f"--seq {seq}", file=sys.stderr)
        return 2
    blocks = ids[: n_blocks * seq].reshape(n_blocks, seq)
    if is_primary():
        log("info", f"finetune: {len(ids)} tokens -> {n_blocks} blocks of {seq}",
            rank=args.rank, steps=args.steps, lr=args.lr)

    params = lora.init_lora(params, rank=args.rank, alpha=args.lora_alpha, config=config)
    opt = lora.init_lora_opt_state(params, lr=args.lr)
    rng = np.random.default_rng(args.seed if args.seed >= 0 else 0)
    t0 = time.time()
    loss = None
    for step in range(args.steps):
        take = rng.integers(0, n_blocks, size=args.train_batch)
        batch = torch.from_numpy(blocks[take]).to(device)
        params, opt, loss = lora.lora_train_step(params, opt, batch, config, lr=args.lr)
        if not args.silent and (step % 10 == 0 or step == args.steps - 1):
            log("info", f"step {step:4d} loss {float(loss):.4f} "
                f"({time.time() - t0:.1f}s)")
    out = args.out or (args.model + ".lora.npz")
    lora.save_lora(out, params, config)
    if is_primary():
        tps = args.steps * args.train_batch * seq / (time.time() - t0)
        print(f"[FINETUNE] {args.steps} steps, final loss {float(loss):.4f}, "
              f"{tps:.0f} tok/s -> adapters saved to {out}")
        print(f"[FINETUNE] serve with: --model {args.model} --lora {out}")
    return 0


def _gen_config(args):
    from llamago_tpu_torch.config import GenerateConfig

    return GenerateConfig(
        max_tokens=args.predict,
        ctx_size=args.context,
        temp=args.temp,
        top_k=args.topk,
        top_p=args.topp,
        repeat_penalty=args.repeat_penalty,
        repeat_last_n=args.repeat_last_n or args.context,
        seed=args.seed,
        stop_at_eos=args.stop_at_eos or args.chat,
    )


def run(args) -> int:
    engine, ckpt, config = _load_engine(args)
    gen = _gen_config(args)
    from llamago_tpu_torch.parallel.tp_kernels import active_mesh

    if active_mesh() is not None and active_mesh().world > 1:
        return run_ranked(engine, gen, args)

    if args.server:
        from llamago_tpu_torch.config import ServerConfig
        from llamago_tpu_torch.server.api import JobServer

        server = JobServer(
            engine,
            ServerConfig(host=args.host, port=args.port, max_pods=args.pods,
                         prefill_buckets=engine.buckets),
            gen,
            model_name=os.path.basename(args.model),
        )
        warm_s = engine.warmup()
        if not args.silent:
            log("info", f"engine warm in {warm_s:.1f}s")
            log("info", f"listening on http://{args.host}:{args.port}", pods=args.pods)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
        return 0

    if args.chat:
        return run_chat(engine, gen, args)

    if not args.prompt:
        print("error: --prompt is required (or --server / --chat)", file=sys.stderr)
        return 2
    return run_oneshot(engine, gen, args)


def run_ranked(engine, gen, args) -> int:
    """`run` as one rank of a mesh: every rank runs the lockstep tick
    (parallel/multihost.py); rank 0 owns HTTP with --server, and reads and
    prints with --chat / --prompt."""
    from llamago_tpu_torch.parallel.multihost import is_primary, serve_lockstep

    primary = is_primary()
    if args.server:
        from llamago_tpu_torch.config import ServerConfig
        from llamago_tpu_torch.server.api import JobServer

        server = JobServer(
            engine,
            ServerConfig(host=args.host, port=args.port, max_pods=args.pods,
                         prefill_buckets=engine.buckets),
            gen, model_name=os.path.basename(args.model)) if primary else None
        warm_s = engine.warmup()
        if not args.silent:
            log("info", f"engine warm in {warm_s:.1f}s")
            log("info", f"listening on http://{args.host}:{args.port}", pods=args.pods)
        # SIGTERM / SIGINT stop every rank through rank 0's broadcast
        stop = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
        serve_lockstep(engine, server, stop_when=stop.is_set)
        return 0
    if args.chat:
        return run_chat(engine, gen, args)
    if not args.prompt:
        print("error: --prompt is required (or --server / --chat)", file=sys.stderr)
        return 2
    return run_oneshot(engine, gen, args)


def _log_rank(mesh) -> None:
    """One JSON line on stderr: this rank's kernel launch counts and the
    collectives that went through host memory. One write: ranks spawned
    here share the parent's stderr, and a pipe keeps a write of up to 4 KiB
    whole."""
    from llamago_tpu_torch.ops import launches
    from llamago_tpu_torch.parallel import mesh as mesh_mod

    line = json.dumps({"rank": mesh.rank, "launches": launches.counts(),
                       "host_copies": mesh_mod.host_copies})
    sys.stderr.flush()
    os.write(sys.stderr.fileno(), (line + "\n").encode())


def _drive(engine, prompt: str, gen, show):
    """Run one job to its end and return it, calling show(job) as its output
    grows: one process steps the engine; under a mesh every rank runs the
    lockstep tick until rank 0's job is done (rank 0 submits it; the other
    ranks get it from the broadcast and return None)."""
    from llamago_tpu_torch.parallel.tp_kernels import active_mesh
    from llamago_tpu_torch.runtime.engine import JobStatus

    def done(job):
        show(job)
        return job.status not in (JobStatus.QUEUED, JobStatus.PROCESSING)

    if active_mesh() is None or active_mesh().world == 1:
        job = engine.submit(prompt, gen)
        while not done(job):
            engine.step()
        return job
    from llamago_tpu_torch.parallel.multihost import is_primary, serve_lockstep

    job = engine.submit(prompt, gen) if is_primary() else None
    serve_lockstep(engine, None, poll_interval=0.0,
                   stop_when=(lambda: done(job)) if job is not None else None)
    return job


def _printer():
    """show(job): print the part of job.output not printed yet."""
    shown = 0

    def show(job):
        nonlocal shown
        if len(job.output) > shown:
            print(job.output[shown:], end="", flush=True)
            shown = len(job.output)

    return show


def run_oneshot(engine, gen, args) -> int:
    """One-shot generation with streamed output (main.go:131-147) and the
    end-of-job performance report (server.go:244-274). Under a mesh rank 0
    prints; the other ranks only run the tick."""
    from llamago_tpu_torch.parallel.multihost import is_primary
    from llamago_tpu_torch.runtime.engine import JobStatus

    if is_primary():
        print(args.prompt, end="", flush=True)
    show = _printer()
    job = _drive(engine, args.prompt, gen, show)
    if job is None:
        return 0
    show(job)
    print()
    if job.status == JobStatus.FAILED:
        log("error", job.error)
        return 1
    if not args.silent:
        _report(job)
    return 0


def run_chat(engine, gen, args) -> int:
    """Interactive chat carrying the conversation: each turn submits
    history+reply+new input, so the slot's prefix cache re-prefills only
    the new suffix. History trims oldest-first near the context budget.
    Under a mesh rank 0 reads and prints, and tells the other ranks over the
    broadcast whether another turn comes."""
    from llamago_tpu_torch.parallel.multihost import broadcast_pytree, is_primary
    from llamago_tpu_torch.runtime.engine import JobStatus

    if not is_primary():
        while broadcast_pytree(None)["go"]:
            _drive(engine, "", gen, lambda job: None)
        return 0

    def turn(go: bool) -> None:
        broadcast_pytree({"go": go})  # one process: nothing to tell

    print("[CHAT] interactive mode — empty line or Ctrl-D to exit\n")
    history = ""
    while True:
        try:
            prompt = input("user> ")
        except (EOFError, KeyboardInterrupt):
            print()
            turn(False)
            return 0
        if not prompt.strip():
            turn(False)
            return 0
        if len(prompt) + 1 >= gen.ctx_size:
            print(f"[chat] input of {len(prompt)} chars exceeds the "
                  f"context ({gen.ctx_size}) — not sent", file=sys.stderr)
            continue
        budget = max(len(prompt) + 2, gen.ctx_size // 2)
        full = history + prompt
        while history and len(full) + 1 >= budget:
            history = history[max(1, len(history) // 2):]  # always shrinks
            full = history + prompt
        print("model> ", end="", flush=True)
        turn(True)
        show = _printer()
        job = _drive(engine, full, gen, show)
        show(job)
        print()
        if job.status == JobStatus.FAILED:
            print(f"[chat] turn failed: {job.error}", file=sys.stderr)
            if "too long" in job.error or "does not fit" in job.error:
                history = ""
                print("[chat] history cleared", file=sys.stderr)
            continue
        history = full + " " + job.output + "\n"


def _report(job) -> None:
    """Per-job performance table (parity: server.go:244-274), per emitted
    token, from the engine's spans since the job's admission (the one job
    of a one-shot run): eval is the time the host spent launching device
    work outside sampling and waiting for the card, sample the `sample`
    spans' time."""
    from llamago_tpu_torch.runtime.spans import LAUNCH, SPANS, parents, self_times

    n = len(job.output_tokens)
    held = SPANS.spans()
    first = max((i for i, s in enumerate(held) if s.name == "admit" and s.job == job.id),
                default=len(held))
    spans = [s for s in held[first:] if s.t1 >= s.t0]
    own, up = self_times(spans), parents(spans)
    sample = sum(s.t1 - s.t0 for s in spans if s.name == "sample")
    launch = sum(t for s, t in zip(spans, own) if s.name in LAUNCH and s.name != "sample")
    wait = sum(s.t1 - s.t0 for s, p in zip(spans, up)
               if s.name == "wait" and (p < 0 or spans[p].name != "sample"))
    avg_eval = 1e3 * (launch + wait) / max(n, 1)
    avg_sample = 1e3 * sample / max(n, 1)
    print(f"\n[ HALT ] Time per token: {avg_eval + avg_sample:.2f} ms | "
          f"eval {avg_eval:.2f} ms | sample {avg_sample:.2f} ms | "
          f"TTFT {job.ttft_ms:.0f} ms | "
          f"tokens {n} | {job.tokens_per_second:.2f} tokens/s")


if __name__ == "__main__":
    sys.exit(main())
