"""Quantization quality gate: perplexity deltas fp32 vs Q8_0/Q4_0/Q4_1.

Counterpart of the JAX package's `eval/quality_gate.py`. BASELINE.md gates
INT4 quantization at <=0.1 perplexity delta vs FP16 on WikiText-2. No real
LLaMA weights are reachable offline, so the gate runs end to end on the
closest proxy: a byte-level LLaMA (the same architecture and quantization
paths) trained here on the repository's English documents and measured on
a held-out split. Every stage is the production pipeline:

    train (models/training.py loss) -> export_ggjt_tensors -> write_ggjt
    -> quantize_ggjt (file blocks, checkpoint/quant_file.py)
    -> read_ggjt -> load_parameters (the serving loader)
    -> eval/perplexity.py on held-out text

The file-format rows run the files' own formats (LLAMAGO_INT4_EXEC=q4_0
pinned: on CUDA a Q4_0 file would otherwise be re-laid as w4x8 at load).
On CUDA (`fused`, the default there) every quantized file is also
evaluated in bf16 compute on the card's kernels: Q8_0 and Q4_0 on K1, Q4_1 on its
dequantize + matmul, and the w4x8 rows on K6 ("w4x8"), on K5 for every
w4x8 matmul ("w4x8_a8": `ops.kernels._W4X8_A8_MAX_M` raised in this
process, which is the global `w4x8_form` reads) and from the dense file
quantized straight to w4x8 ("w4x8_direct"). Their deltas are taken
against the dense file in the same bf16 compute.

`python -m llamago_tpu_torch.eval.quality_gate` prints the result as one
JSON line (`--out F` also writes it to F); `--model <ggjt-or-gguf>` runs
the same gate on a real dense checkpoint. The files go to a temporary
directory unless `tmp_dir` names one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.tokenizer import Vocab
from llamago_tpu_torch.utils.device import resolve_device

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the documents the proxy trains and is measured on, as the JAX package reads them
CORPUS_FILES = ("README.md", "SURVEY.md", "BASELINE.md", "PAPERS.md", "SNIPPETS.md",
                "docs/SERVING.md", "docs/QUANTIZATION.md", "docs/PARALLELISM.md")


def byte_vocab() -> Vocab:
    """unk/bos/eos + 256 byte pieces: a byte-level LM over raw text."""
    tokens = [(" ⁇ ".encode(), 0.0), (b"", 0.0), (b"", 0.0)]
    tokens += [(bytes([b]), -1000.0) for b in range(256)]
    return Vocab(tokens)


def _corpus() -> tuple[str, str]:
    """Real English text available offline: this repository's documents,
    split 70/30 into train and held-out text at a line boundary (at least
    20k held-out tokens, so a 0.1-ppl gate can tell a regression from
    noise)."""
    parts = []
    for name in CORPUS_FILES:
        p = os.path.join(_ROOT, name)
        if os.path.exists(p):
            with open(p, encoding="utf-8") as f:
                parts.append(f.read())
    text = "\n\n".join(parts)
    cut = int(len(text) * 0.7)
    cut = text.find("\n", cut) + 1 or cut
    return text[:cut], text[cut:]


def _byte_ids(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32) + 3


def train_byte_lm(config: ModelConfig, train_ids: np.ndarray, steps: int, batch: int,
                  seed: int = 0, lr: float = 3e-3, log_every: int = 50, device="cuda",
                  init=None):
    """Train from `init` (default: random_parameters(config, seed)) with
    AdamW on random windows of the corpus, drawn from
    np.random.default_rng(seed) as the JAX package draws them (the loss of
    models/training.py over the production forward)."""
    from llamago_tpu_torch.checkpoint.params import random_parameters
    from llamago_tpu_torch.models.training import make_optimizer, train_step

    dev = resolve_device(device)
    params = init if init is not None else random_parameters(config, seed=seed, device=dev)
    opt = make_optimizer(params, lr=lr)
    t = config.max_seq_len
    rng = np.random.default_rng(seed)
    for i in range(steps):
        starts = rng.integers(0, len(train_ids) - t, batch)
        tokens = torch.from_numpy(np.stack([train_ids[s:s + t] for s in starts])).to(dev)
        params, opt, loss = train_step(params, opt, tokens, config)
        if log_every and (i + 1) % log_every == 0:
            print(f"[train] step {i + 1}/{steps} loss {float(loss):.3f}",
                  file=sys.stderr, flush=True)
    for p in opt.param_groups[0]["params"]:
        p.requires_grad_(False)
    return params


def ppl_of_file(path: str, eval_ids, ctx: int, device="cuda", compute: str = "float32",
                kv: str = "auto", weight_dtype: str | None = None) -> float:
    """Held-out perplexity of a model file as the serving loader loads it,
    in `compute` dtype on `device` (weight_dtype set: its dense leaves
    quantized at load)."""
    from llamago_tpu_torch.checkpoint.gguf import read_checkpoint
    from llamago_tpu_torch.checkpoint.params import load_parameters
    from llamago_tpu_torch.eval.perplexity import perplexity

    ckpt = read_checkpoint(path, max_seq_len=ctx)
    cfg = ckpt.config.replace(dtype=compute, max_seq_len=ctx, kv_dtype=kv)
    if weight_dtype is not None:
        cfg = cfg.replace(weight_dtype=weight_dtype)
    params = load_parameters(cfg, ckpt.tensors, device=device)
    return perplexity(params, cfg, eval_ids, ctx=ctx)["ppl"]


@contextlib.contextmanager
def _exec_routes(int4_exec: str, a8_max_m: int | None = None):
    """LLAMAGO_INT4_EXEC (read at load) and, where given, K5's row limit
    `ops.kernels._W4X8_A8_MAX_M` (read at each call) while open."""
    from llamago_tpu_torch.ops import kernels
    from llamago_tpu_torch.ops.quant import _INT4_EXEC_ENV

    saved_exec, saved_a8 = os.environ.get(_INT4_EXEC_ENV), kernels._W4X8_A8_MAX_M
    os.environ[_INT4_EXEC_ENV] = int4_exec
    if a8_max_m is not None:
        kernels._W4X8_A8_MAX_M = a8_max_m
    try:
        yield
    finally:
        kernels._W4X8_A8_MAX_M = saved_a8
        if saved_exec is None:
            os.environ.pop(_INT4_EXEC_ENV, None)
        else:
            os.environ[_INT4_EXEC_ENV] = saved_exec


@contextlib.contextmanager
def _work_dir(tmp_dir: str | None):
    if tmp_dir is not None:
        os.makedirs(tmp_dir, exist_ok=True)
        yield tmp_dir
        return
    d = tempfile.mkdtemp(prefix="llamago_quality_gate_")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def run_gate(steps: int = 400, batch: int = 8, ctx: int = 256, tmp_dir: str | None = None,
             kinds: tuple[str, ...] = ("q8_0", "q4_0", "q4_1"), dim: int = 256,
             n_layers: int = 6, fused: bool | None = None, device="cuda", init=None) -> dict:
    """Gate the quantized serving path end to end on `device` (the JAX
    package's rows and keys). `fused` (default: on CUDA) adds the bf16 rows
    on the card's kernels, their deltas against the dense file in bf16.
    `init` replaces the random initial parameters (a parity test starts
    both packages from one tree)."""
    from llamago_tpu_torch.checkpoint.ggjt import write_ggjt
    from llamago_tpu_torch.checkpoint.params import export_ggjt_tensors
    from llamago_tpu_torch.checkpoint.quant_file import quantize_ggjt

    dev = resolve_device(device)
    if fused is None:
        fused = dev.type == "cuda"
    train_text, eval_text = _corpus()
    train_ids, eval_ids = _byte_ids(train_text), _byte_ids(eval_text)
    vocab = byte_vocab()
    config = ModelConfig(vocab_size=len(vocab), dim=dim, n_layers=n_layers,
                         n_heads=max(4, dim // 32), multiple_of=32, max_seq_len=ctx,
                         dtype="float32", weight_dtype="float32")
    params = train_byte_lm(config, train_ids, steps=steps, batch=batch, device=dev, init=init)

    def ppl_of(path, compute="float32", kv="auto", weight_dtype=None):
        return ppl_of_file(path, eval_ids, ctx, dev, compute, kv, weight_dtype)

    with _work_dir(tmp_dir) as work:
        f32_path = os.path.join(work, "model-f32.bin")
        write_ggjt(f32_path, config, vocab, export_ggjt_tensors(config, params), ftype=0)
        del params
        qpaths = {}
        with _exec_routes("q4_0"):  # the file formats, never re-laid as w4x8
            results = {"fp32": ppl_of(f32_path)}
            for kind in kinds:
                qpaths[kind] = quantize_ggjt(f32_path, os.path.join(work, f"model-{kind}.bin"),
                                             kind)
                results[kind] = ppl_of(qpaths[kind])
            # the int8 KV cache row isolates the cache's quantization error
            results["kv_int8"] = ppl_of(f32_path, kv="int8")

        deltas = {k: results[k] - results["fp32"] for k in (*kinds, "kv_int8")}
        out = {
            "metric": "quantization_ppl_gate",
            "model": f"byte-LLaMA d{config.dim} L{config.n_layers} (proxy; "
                     "no real weights reachable offline)",
            "eval_tokens": int(len(eval_ids)),
            "ctx": ctx,
            "train_steps": steps,
            "ppl": {k: round(v, 4) for k, v in results.items()},
            "ppl_delta_vs_fp32": {k: round(v, 4) for k, v in deltas.items()},
            "baseline_gate": "<=0.1 ppl delta at INT4 (BASELINE.md)",
            "gate_int4_pass": bool(deltas.get("q4_0", 9e9) <= 0.1),
            "gate_kv_int8_pass": bool(deltas.get("kv_int8", 9e9) <= 0.1),
        }
        if fused:
            bf16 = "bfloat16"
            with _exec_routes("q4_0"):  # the file format, never re-laid
                fres = {"dense_bf16": ppl_of(f32_path, compute=bf16)}
                for kind in kinds:
                    fres[kind] = ppl_of(qpaths[kind], compute=bf16)
            fkeys = list(kinds)
            if "q4_0" in qpaths:
                # w4x8 rows, what int4 serving runs on the card: K6 over the
                # re-laid Q4_0 blocks; K5 (int8 activation rounding) for every
                # w4x8 matmul; and the dense file quantized straight to w4x8
                with _exec_routes("w4x8"):
                    fres["w4x8"] = ppl_of(qpaths["q4_0"], compute=bf16)
                with _exec_routes("w4x8", a8_max_m=4096):
                    fres["w4x8_a8"] = ppl_of(qpaths["q4_0"], compute=bf16)
                with _exec_routes("w4x8"):
                    fres["w4x8_direct"] = ppl_of(f32_path, compute=bf16, weight_dtype="int4")
                fkeys += ["w4x8", "w4x8_a8", "w4x8_direct"]
            fdeltas = {k: fres[k] - fres["dense_bf16"] for k in fkeys}
            out["fused"] = {
                "backend": dev.type,
                "fused": dev.type == "cuda",
                "compute_dtype": bf16,
                "ppl": {k: round(v, 4) for k, v in fres.items()},
                "ppl_delta_vs_dense_bf16": {k: round(v, 4) for k, v in fdeltas.items()},
                "gate_int4_pass": bool(fdeltas.get("q4_0", 9e9) <= 0.1),
                "gate_w4x8_pass": bool(fdeltas.get("w4x8_a8", 9e9) <= 0.1),
            }
    return out


def run_gate_on_checkpoint(model_path: str, ctx: int = 512, tmp_dir: str | None = None,
                           kinds: tuple[str, ...] = ("q8_0", "q4_0", "q4_1"),
                           fused: bool | None = None, device="cuda") -> dict:
    """The same gate on a real dense checkpoint (ggjt or GGUF): quantize
    the given f32/f16 file with the production file quantizer and compare
    held-out perplexity, the eval text tokenized with the checkpoint's own
    tokenizer (BASELINE.md's WikiText-2 gate analogue)."""
    from llamago_tpu_torch.checkpoint.gguf import read_checkpoint
    from llamago_tpu_torch.checkpoint.quant_file import quantize_ggjt
    from llamago_tpu_torch.tokenizer import tokenize

    dev = resolve_device(device)
    if fused is None:
        fused = dev.type == "cuda"
    _, eval_text = _corpus()
    ckpt = read_checkpoint(model_path, max_seq_len=ctx)
    if ckpt.ftype not in (0, 1):
        raise ValueError(
            f"--model gate needs a dense f32/f16 checkpoint (ftype 0|1), "
            f"got ftype={ckpt.ftype}; quantized deltas are measured "
            f"against this base")
    eval_ids = np.asarray(tokenize(ckpt.vocab, eval_text, bos=True), np.int32)
    compute = "bfloat16" if fused else "float32"
    results = {"dense": ppl_of_file(model_path, eval_ids, ctx, dev, compute)}
    with _work_dir(tmp_dir) as work:
        for kind in kinds:
            qpath = quantize_ggjt(model_path, os.path.join(work, f"real-{kind}.bin"), kind)
            results[kind] = ppl_of_file(qpath, eval_ids, ctx, dev, compute)
    deltas = {k: results[k] - results["dense"] for k in kinds}
    return {
        "metric": "quantization_ppl_gate_real",
        "model": os.path.basename(model_path),
        "backend": dev.type,
        "compute_dtype": compute,
        "eval_tokens": int(len(eval_ids)),
        "ctx": ctx,
        "ppl": {k: round(v, 4) for k, v in results.items()},
        "ppl_delta_vs_dense": {k: round(v, 4) for k, v in deltas.items()},
        "baseline_gate": "<=0.1 ppl delta at INT4 (BASELINE.md)",
        "gate_int4_pass": bool(deltas.get("q4_0", 9e9) <= 0.1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=256)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--fused", action="store_true", default=None,
                    help="also gate the bf16 rows on the card's kernels "
                         "[default: on with --device cuda]")
    ap.add_argument("--model", default=None,
                    help="gate a real dense checkpoint (ggjt/GGUF) instead "
                         "of the trained proxy")
    ap.add_argument("--out", default="", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if args.out and os.path.abspath(args.out).startswith(
            os.path.join(_ROOT, "bench_artifacts") + os.sep):
        ap.error("--out: bench_artifacts/ holds the JAX package's numbers")

    if args.model:
        result = run_gate_on_checkpoint(args.model, ctx=args.ctx, fused=args.fused,
                                        device=args.device)
    else:
        result = run_gate(steps=args.steps, batch=args.batch, ctx=args.ctx, dim=args.dim,
                          n_layers=args.layers, fused=args.fused, device=args.device)
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                             text=True, timeout=10, cwd=_ROOT).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        rev = "unknown"
    dev = resolve_device(args.device)
    result.update({
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_rev": rev,
        "backend": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    })
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
