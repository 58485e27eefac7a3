"""CLI entry point of the port.

Counterpart of the JAX package's `cli.py`, with the same flags and
defaults plus `--device` (reference flags: main.go:24-41, defaults
main.go:352-382). One-shot mode streams the job's output as it grows and
prints the per-job report; `--server` serves the REST job API; `--chat`
is the interactive loop.

The port runs on CUDA unless `--device cpu` is given. The compute dtype
defaults to bfloat16 on CUDA and float32 on the CPU, and the decode chunk
to 32 tokens per host sync on CUDA and 1 on the CPU. Flags and
subcommands whose slice of the port has not landed fail with a message
that names the slice.
"""

from __future__ import annotations

import argparse
import os
import sys
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

# subcommand -> the slice of the port that brings it
_UNPORTED_COMMANDS = {
    "load": "checkpoint tools",
    "convert": "checkpoint tools",
    "quantize": "checkpoint tools",
    "perplexity": "eval",
    "finetune": "training",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="llamago-tpu-torch", description="LLaMA inference on PyTorch/CUDA")
    p.add_argument("command", nargs="?", default=None,
                   help="optional subcommand: load | convert | quantize | "
                        "perplexity | finetune (not yet ported)")
    p.add_argument("--file", default="", help="text file for `perplexity`/`finetune`")
    p.add_argument("--out", default="", help="output path for `quantize`/`convert`")
    p.add_argument("--vocab-only", action="store_true",
                   help="`convert`: write only the scored vocab, no tensors")
    p.add_argument("--qkind", default="", choices=["", "q8_0", "q4_0", "q4_1"],
                   help="quantization kind for `quantize` (overrides --bits)")
    p.add_argument("--bits", type=int, default=8, choices=[4, 8],
                   help="bit width for `quantize` [8]")
    # --- reference flag parity (main.go:24-41)
    p.add_argument("--prompt", default="", help="text prompt to feed the model")
    p.add_argument("--model", default="", help="path of converted .bin ggjt model")
    p.add_argument("--server", action="store_true", help="start REST API server mode")
    p.add_argument("--host", default="localhost", help="server host [localhost]")
    p.add_argument("--port", type=int, default=8080, help="server port [8080]")
    p.add_argument("--pods", type=int, default=1,
                   help="parallel decode slots in server mode [1]")
    p.add_argument("--threads", type=int, default=0,
                   help="host CPU threads for PyTorch's CPU ops [0 = default]")
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
    # --- LoRA fine-tuning flags (the training slice)
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


def unported_reason(args) -> str | None:
    """Why these flags cannot run yet (the slice that brings them), or None."""
    if args.command in _UNPORTED_COMMANDS:
        return (f"the `{args.command}` subcommand is not yet ported "
                f"({_UNPORTED_COMMANDS[args.command]} slice of the port)")
    if args.spec:
        return "--spec is not yet ported (speculative-decoding slice of the port)"
    if args.tp > 1 or args.dp != 1 or args.sp != 1:
        return "--tp/--dp/--sp are not yet ported (parallel slice of the port)"
    if args.multihost or args.coordinator or args.nprocs or args.procid >= 0:
        return "--multihost is not yet ported (parallel slice of the port)"
    if args.lora:
        return "--lora is not yet ported (training slice of the port)"
    return None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.threads > 0:
        import torch

        torch.set_num_threads(args.threads)

    if not args.silent:
        colorize("[magenta]" + LOGO)

    if args.command is not None and args.command not in _UNPORTED_COMMANDS:
        print(f"unknown command: {args.command}", file=sys.stderr)
        return 2
    reason = unported_reason(args)
    if reason is not None:
        print(f"error: {reason}", file=sys.stderr)
        return 2

    if not args.model:
        print("error: --model is required", file=sys.stderr)
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
    from llamago_tpu_torch.checkpoint.ggjt import read_ggjt
    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        load_parameters,
        unstack_layer_params,
    )
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.dtype is None:
        args.dtype = "bfloat16" if device.type == "cuda" else "float32"
    t0 = time.time()
    if not args.silent:
        log("info", f"loading model {args.model} ...")
    ckpt = read_ggjt(args.model, max_seq_len=args.context)
    file_quantized = ckpt.ftype in (2, 3, 7)  # Q4_0 / Q4_1 / Q8_0
    config = ckpt.config.replace(
        dtype=args.dtype,
        # a pre-quantized file dictates the weight storage
        weight_dtype=(ckpt.config.weight_dtype if file_quantized
                      else args.weight_dtype or args.dtype),
        kv_dtype=args.kv_dtype,
        max_seq_len=args.context,
    )
    params = load_parameters(config, ckpt.tensors, device=device)
    params = fuse_layer_weights(unstack_layer_params(params, config.n_layers))
    if not args.silent:
        log("info", f"model ready in {time.time() - t0:.1f}s",
            layers=config.n_layers, dim=config.dim,
            weights=config.weight_dtype, device=str(device))
    chunk = args.chunk or (32 if device.type == "cuda" else 1)
    kwargs = {}
    if args.prefill_buckets:
        kwargs["buckets"] = tuple(sorted(int(b) for b in args.prefill_buckets.split(",")))
    engine = Engine(config, params, ckpt.vocab, slots=args.pods,
                    decode_chunk_size=chunk, prefill_chunk=args.prefill_chunk,
                    device=device, **kwargs)
    return engine, ckpt, config


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


def run_oneshot(engine, gen, args) -> int:
    """One-shot generation with streamed output (main.go:131-147) and the
    end-of-job performance report (server.go:244-274)."""
    from llamago_tpu_torch.runtime.engine import JobStatus

    job = engine.submit(args.prompt, gen)
    shown = 0
    print(args.prompt, end="", flush=True)
    while job.status in (JobStatus.QUEUED, JobStatus.PROCESSING):
        engine.step()
        out = job.output
        if len(out) > shown:
            print(out[shown:], end="", flush=True)
            shown = len(out)
    if len(job.output) > shown:
        print(job.output[shown:], end="", flush=True)
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
    the new suffix. History trims oldest-first near the context budget."""
    from llamago_tpu_torch.runtime.engine import JobStatus

    print("[CHAT] interactive mode — empty line or Ctrl-D to exit\n")
    history = ""
    while True:
        try:
            prompt = input("user> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not prompt.strip():
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
        job = engine.submit(full, gen)
        shown = 0
        print("model> ", end="", flush=True)
        while job.status in (JobStatus.QUEUED, JobStatus.PROCESSING):
            engine.step()
            if len(job.output) > shown:
                print(job.output[shown:], end="", flush=True)
                shown = len(job.output)
        print(job.output[shown:] if len(job.output) > shown else "")
        if job.status == JobStatus.FAILED:
            print(f"[chat] turn failed: {job.error}", file=sys.stderr)
            if "too long" in job.error or "does not fit" in job.error:
                history = ""
                print("[chat] history cleared", file=sys.stderr)
            continue
        history = full + " " + job.output + "\n"


def _report(job) -> None:
    """Per-job performance table (parity: server.go:244-274)."""
    n = len(job.output_tokens)
    avg_eval = sum(job.eval_ms) / max(len(job.eval_ms), 1)
    avg_sample = sum(job.sample_ms) / max(len(job.sample_ms), 1)
    print(f"\n[ HALT ] Time per token: {avg_eval + avg_sample:.2f} ms | "
          f"eval {avg_eval:.2f} ms | sample {avg_sample:.2f} ms | "
          f"TTFT {job.ttft_ms:.0f} ms | "
          f"tokens {n} | {job.tokens_per_second:.2f} tokens/s")


if __name__ == "__main__":
    sys.exit(main())
