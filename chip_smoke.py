#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (llamago_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DETAIL.json] [--only PHASE,...]

Phases, each of which fails the run (exit code 1, no result line):

  1. print the card (nvidia-smi name and power limit) and build every
     CUDA kernel from csrc/ with nvcc (one process per source, together);
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the serving path gives it (K3 and K5's activation quantization
     bit for bit), and time the kernel, the plain version, one PyTorch
     library call computing the same function where there is one (a
     yardstick the port never calls) and the bound (the larger of bytes
     over 3.35 TB/s and operations over the peak rate of their type: 989
     TFLOP/s bf16, 1,979 TOPS int8, 67 TFLOP/s f32; H100 SXM data sheet).
     K1 (Q8_0 and Q4_0), K2, K3, K4, K8, K5 (W4A8 decode matmul), K6 (w4x8
     stream matmul) and K9 (scale-on-output matmul);
  3. check the port end to end on a small model: logits and greedy tokens
     on the card (through the kernels) against the CPU (plain versions),
     with the dense cache, then the int8 cache under K4 and under K8, then
     int4 weights in the w4x8 format (K5, K6 and, for the leaf whose K is
     no multiple of 128, K1 bits=4), in the Q4_0 format (K1 bits=4) and in
     the Q4_0 format with the scale-on-output switch on (K9);
  4. serve full-width LLaMA-7B with random Q8_0 weights (depth and weights
     as MODEL_PRESETS["7B"], random from seed 0) over the REST job API:
     8 sampled jobs over HTTP on 4 slots with decode chunks of 32, then a
     greedy job twice. The launch counts of K1 and K2 must rise while
     serving, those of the int8 cache's kernels stay 0. Then one decode
     chunk of the 4 slots is timed and traced for where a decode step's
     time goes (device busy share, top kernels and host ops);
  4b. the same with the int8 KV cache (`kv_dtype="int8"`) on 8 slots and
     16 jobs, after phase 4's engine is freed: K1, K3 and K4 must launch,
     K2 and K8 not;
  4c. the same with random int4 weights in the w4x8 format and the bf16
     cache on 4 slots and 8 jobs, after the int8 weights are freed: K5, K6
     and K2 must launch, every other kernel stay at 0;

then print the card line, the kernels line (JSON) and, last, the device
line (JSON). `--out` names a file for the detail (per-shape kernel times,
the serving numbers, the decode-step profile) as JSON. `--only` runs the
named phases alone (after the build) for work on one of them, and prints no
result lines: k1, k2, k3, k4k8, k1q4, k5, k6, k9, small, small_int4, serve,
serve_int8, serve_int4.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
import traceback
import urllib.request
import uuid

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet

# the 7B projections of one decode step: (name, K, N, launches per step)
K1_SHAPES = (("wqkv", 4096, 12288, 32), ("wo", 4096, 4096, 32),
             ("w13", 4096, 22016, 32), ("w2", 11008, 4096, 32),
             ("lm_head", 4096, 32768, 1))
# the same with int4 weights: the head is not padded
INT4_SHAPES = K1_SHAPES[:4] + (("lm_head", 4096, 32000, 1),)
# x max|ref|, for every quantized matmul (K1, K5, K6, K9): the kernel's f32
# sums run in another order than the plain version's (split K, warps, FMA);
# a bf16 output adds one rounding
K1_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
K2_TOL = 1e-2  # absolute, bf16 outputs of size ~1
K2_SHAPE = dict(b=4, kv=32, g=1, hd=128, s=1024)
K2_COPIES = 3  # 3 x 67 MB of K and V at K2_SHAPE
K3_SHAPE = dict(b=8, kv=32, hd=128, s=1024)  # the int8 serving phase's decode step
# absolute, bf16 outputs of size ~1: one bf16 rounding of the output, and the
# kernel's per-S-block statistics (exp, f32 sums in another order) against the
# plain version's running ones
K4_TOL = 1e-2
K4_SHAPE = dict(b=8, kv=32, g=1, hd=128, s=1024)
K4_COPIES = 3  # 3 x 68 MB of int8 K and V and their scales at K4_SHAPE


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_busy_us(events) -> float:
    """Length of the union of the device-side activity spans in a trace."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def timed(fns, iters: int) -> float:
    """Device time in ms per call over `iters` calls cycling through `fns`,
    after one warm-up pass: the card's busy time in a torch.profiler
    trace, so the host's launch cost between small kernels does not count
    as kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    busy = device_busy_us(prof.events())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device activity")
    return busy / 1e3 / iters


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    """The least time for the work, and which of bytes/operations bound it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 2

def _random_leaf(gen, dev, fmt: str, k: int, n: int) -> dict:
    """A random quantized leaf with bf16 scales in (0, 0.02): "q8" (Q8_0),
    "q4" (Q4_0) or "q4x" (w4x8, its group scales stored as duplicated rows)."""
    import torch

    def scales(rows):
        return (torch.rand((rows, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)

    if fmt == "q8":
        return {"q8": torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int8,
                                    device=dev), "s": scales(k // 32)}
    packed = torch.randint(0, 256, (k // 2, n), generator=gen, dtype=torch.uint8, device=dev)
    if fmt == "q4":
        return {"q4": packed, "s": scales(k // 32)}
    return {"q4x": packed, "s": torch.repeat_interleave(scales(k // 128), 2, dim=0)}


def _leaf_bytes(w: dict) -> int:
    """Bytes the kernels read of a leaf: of a w4x8 leaf's duplicated scale
    rows only every other one."""
    s = w["s"].numel() * w["s"].element_size()
    if "q4x" in w:
        return w["q4x"].numel() + s // 2
    return (w["q8"] if "q8" in w else w["q4"]).numel() + s


def check_matmul(dev, detail: dict, tag: str, fmt: str, kernel, plain, timed_m: tuple,
                 other_m: tuple, ops_per_s: float, seed: int, step_m: int = 4) -> dict:
    """One quantized matmul kernel at the five 7B projection shapes (the
    head at its width in that format): kernel against plain version for f32
    and bf16 x (and f32 scales at the wqkv shape, as a file brings them,
    where the kernel takes them) at the row counts `timed_m`, which are also
    timed in bf16, and at the wqkv shape at `other_m`. Returns the kernels
    line's numbers: one decode step (or one pass over the five shapes) at
    `step_m` rows."""
    import torch

    from llamago_tpu_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(seed)
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    max_err = 0.0
    rows = []
    for name, k, n, per_step in (K1_SHAPES if fmt == "q8" else INT4_SHAPES):
        ws = [_random_leaf(gen, dev, fmt, k, n)]
        # copies enough that a cycle of calls streams past the 50 MB L2,
        # as the decode step's weight stream does
        copies = max(1, -(-200_000_000 // _leaf_bytes(ws[0])))
        ws += [_random_leaf(gen, dev, fmt, k, n) for _ in range(copies - 1)]
        cases = [("float32", ws[0]), ("bfloat16", ws[0])]
        if name == "wqkv" and fmt != "q4x":
            cases.append(("float32", {**ws[0], "s": ws[0]["s"].float()}))

        def check(m):
            nonlocal max_err
            for xdt, w in cases:
                x = torch.randn((m, k), generator=gen, device=dev).to(getattr(torch, xdt))
                got = kernel(x, w).float()
                ref = plain(x, w).float()
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item() / ref.abs().max().item()
                if not err <= K1_TOL[xdt]:
                    raise AssertionError(f"{tag} {name} m={m} x={xdt}: max|d|/max|ref| "
                                         f"{err:.3g} > {K1_TOL[xdt]}")
                max_err = max(max_err, err)

        if name == "wqkv":
            for m in other_m:
                check(m)
        for m in timed_m:
            check(m)
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            deqs = [quant.dequantize(w, torch.bfloat16) for w in ws]
            kern = timed([lambda w=w: kernel(x, w) for w in ws], 20 * copies)
            plain_ms = timed([lambda w=w: plain(x, w) for w in ws], max(3, copies))
            lib = timed([lambda d=d: x @ d for d in deqs], 20 * copies)
            del deqs
            bnd, by = bound_ms(_leaf_bytes(ws[0]) + m * k * 2 + m * n * 2, 2.0 * m * k * n,
                               ops_per_s)
            rows.append(dict(name=name, m=m, k=k, n=n, ms=kern, plain_ms=plain_ms,
                             library_ms=lib, bound_ms=bnd, bound_by=by))
            log(f"{tag} {name:8s} m={m:3d} K={k} N={n}: kernel {kern:.4f} ms, plain "
                f"{plain_ms:.4f} ms, x@W bf16 {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
            if m == step_m:
                for key, v in (("ms", kern), ("plain_ms", plain_ms), ("library_ms", lib),
                               ("bound_ms", bnd)):
                    step[key] += per_step * v
                step["bound_by"] = by
        del ws
        torch.cuda.empty_cache()
    detail[tag.lower().replace(" ", "_")] = rows
    return {"max_abs_err": max_err, **step}


def check_k1(dev, detail: dict, fmt: str = "q8") -> dict:
    """K1 (Q8_0, or Q4_0 with fmt "q4") at m=4 (decode) and m=64 (the
    prefill bucket of the smoke's prompts), checked and timed; the other row
    counts the serving path produces (1, 2 and 8 slots: the GEMV's other
    templates; the prefill buckets 16 and 32) checked at the wqkv shape. Its
    arithmetic is f32 outside the tensor cores."""
    from llamago_tpu_torch.ops import kernels

    return check_matmul(dev, detail, "K1" if fmt == "q8" else "K1 q4", fmt,
                        kernels.dequant_matmul, kernels.dequant_matmul_plain,
                        timed_m=(4, 64), other_m=(1, 2, 8, 16, 32),
                        ops_per_s=F32_OPS_PER_S, seed=1 if fmt == "q8" else 7)


def check_k5(dev, detail: dict) -> dict:
    """K5 at m=4 (decode) and m=16 (the warm-up prefill bucket), checked and
    timed, other row counts (every register layout of the kernel) at the
    wqkv shape; first its activation quantization alone, bit for bit against
    the plain version. Both compute the same int8 activations and exact
    integer dots, so they differ by the order of the f32 sums only. Its
    operations are int8."""
    import torch

    from llamago_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev).manual_seed(8)
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn((16, 11008), generator=gen, device=dev) * 3).to(dt)
        x[2, 128:256] = 0  # a zero group: sx = 1
        x[3, :5] = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0], device=dev).to(dt)  # ties
        x[3, 5:128] *= 0.01
        xq, sx = kernels.w4x8_quantize_x(x)
        pq, ps = kernels.quantize_activations_a8(x)
        torch.cuda.synchronize()
        if not (torch.equal(xq, pq) and torch.equal(sx, ps)):
            raise AssertionError(f"K5 {dt}: xq / sx differ from the plain version: "
                                 f"{(xq != pq).sum().item()} xq, {(sx != ps).sum().item()} sx")
        if xq[3, :5].tolist() != [0, 2, 2, 0, 127] or sx[2, 1].item() != 1.0:
            raise AssertionError(f"K5 {dt}: ties or the zero group went wrong: "
                                 f"{xq[3, :5].tolist()}, {sx[2, 1].item()}")
        log(f"K5 {str(dt).split('.')[-1]}: xq and sx bit-exact against the plain version")
    before = kernels.w4x8_matmul.launches_stream
    out = check_matmul(dev, detail, "K5", "q4x", kernels.w4x8_matmul,
                       kernels.w4x8_matmul_a8_plain, timed_m=(4, 16),
                       other_m=(1, 2, 3, 8, 9), ops_per_s=INT8_OPS_PER_S, seed=9)
    if kernels.w4x8_matmul.launches_stream != before:
        raise AssertionError("K5: a call of at most 16 rows took the stream kernel")
    return out


def check_k6(dev, detail: dict) -> dict:
    """K6 at m=64 (the prefill bucket of the smoke's prompts), checked and
    timed; m=32 and a ragged m=17 at the wqkv shape. f32 arithmetic outside
    the tensor cores. The kernels line takes one pass over the five shapes
    at m=64 (a prefill chunk's 129 launches)."""
    from llamago_tpu_torch.ops import kernels

    before = kernels.w4x8_matmul.launches_a8
    out = check_matmul(dev, detail, "K6", "q4x", kernels.w4x8_matmul,
                       kernels.w4x8_matmul_stream_plain, timed_m=(64,), other_m=(17, 32),
                       ops_per_s=F32_OPS_PER_S, seed=10, step_m=64)
    if kernels.w4x8_matmul.launches_a8 != before:
        raise AssertionError("K6: a call of more than 16 rows took the W4A8 kernel")
    return out


def check_k9(dev, detail: dict) -> dict:
    """K9 at m=4 for Q8_0 and Q4_0 leaves, checked and timed; 1, 3 and 8
    rows (its other templates, and more rows than one launch takes) at the
    wqkv shape. f32 arithmetic outside the tensor cores. The kernels line
    takes the Q4_0 numbers, the format of this kernel's run in phase 3."""
    from llamago_tpu_torch.ops import kernels

    out = {}
    for fmt in ("q8", "q4"):
        out[fmt] = check_matmul(dev, detail, f"K9 {fmt}", fmt, kernels.dequant_matmul_so,
                                kernels.dequant_matmul_so_plain, timed_m=(4,),
                                other_m=(1, 3, 8), ops_per_s=F32_OPS_PER_S,
                                seed=11 if fmt == "q8" else 12)
    return out["q4"]


def _k2_inputs(dev, gen, t, fill, c=K2_SHAPE, dtype="bfloat16"):
    import torch

    dt = getattr(torch, dtype)
    h = c["kv"] * c["g"]
    q = torch.randn((c["b"], t, h, c["hd"]), generator=gen, device=dev).to(dt)
    cache_shape = (c["b"], c["kv"], c["s"], c["hd"])
    kc = torch.randn(cache_shape, generator=gen, device=dev).to(dt)
    vc = torch.randn(cache_shape, generator=gen, device=dev).to(dt)
    pos0 = max(fill - t, 0)
    positions = (torch.full((c["b"], 1), pos0, device=dev)
                 + torch.arange(t, device=dev)[None, :])
    return q, kc, vc, positions


def _k2_error(q, kc, vc, positions, c) -> float:
    """max |kernel - plain| over one call."""
    import torch

    from llamago_tpu_torch.ops import attention

    got = attention.flash_attention(q, kc, vc, positions).float()
    q5 = q.reshape(c["b"], q.shape[1], c["kv"], c["g"], c["hd"])
    ref = attention.flash_attention_plain(q5, kc, vc, positions[:, 0].to(torch.int32))
    torch.cuda.synchronize()
    return (got - ref.reshape(got.shape).float()).abs().max().item()


def check_k2(dev, detail: dict) -> dict:
    """K2 at b=4, KV=32, hd=128, S=1024 for fills 1, 300 and 1024 and
    windows t=1 (decode) and t=32 (prefill bucket), in bf16, checked and
    timed; two other geometries checked only."""
    import torch
    import torch.nn.functional as F

    from llamago_tpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(2)
    c = K2_SHAPE
    rows, max_err, record = [], 0.0, None
    # other geometries the kernel takes: GQA g=8 at hd=64, and f32
    for shape, dtype, tol in ((dict(b=2, kv=2, g=8, hd=64, s=512), "bfloat16", K2_TOL),
                              (dict(b=2, kv=4, g=2, hd=128, s=512), "float32", 1e-4)):
        for t in (1, 16):
            err = _k2_error(*_k2_inputs(dev, gen, t, 200, shape, dtype), shape)
            if not err <= tol:
                raise AssertionError(f"K2 {shape} {dtype} t={t}: max|d| {err:.3g} > {tol}")
            max_err = max(max_err, err)
            log(f"K2 {shape} {dtype} t={t}: max|d| {err:.2e}")
    for t in (1, 32):
        for fill in (1, 300, 1024):
            q, kc, vc, positions = _k2_inputs(dev, gen, t, fill)
            q5 = q.reshape(c["b"], t, c["kv"], c["g"], c["hd"])
            pos0 = positions[:, 0].to(torch.int32)
            err = _k2_error(q, kc, vc, positions, c)
            if not err <= K2_TOL:
                raise AssertionError(f"K2 t={t} fill={fill}: max|d| {err:.3g} > {K2_TOL}")
            max_err = max(max_err, err)
            # caches enough that a cycle of calls streams past the 50 MB L2,
            # as a decode step's 32 layers do
            caches = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(K2_COPIES - 1)]
            visible = min(max(fill, t), c["s"])  # slots seen by the last query row
            kern = timed([lambda kv=kv: attention.flash_attention(q, *kv, positions)
                          for kv in caches], 50 * K2_COPIES)
            plain = timed([lambda kv=kv: attention.flash_attention_plain(q5, *kv, pos0)
                           for kv in caches], 2 * K2_COPIES)
            # yardstick: SDPA over the visible prefix (causal within the window)
            qh = q.transpose(1, 2)
            mask = None
            if t > 1:
                qpos = positions[0][:, None]
                mask = torch.arange(visible, device=dev)[None, :] <= qpos
            lib = timed([lambda kv=kv: F.scaled_dot_product_attention(
                qh, kv[0][:, :, :visible], kv[1][:, :, :visible], attn_mask=mask)
                for kv in caches], 50 * K2_COPIES)
            del caches
            h = c["kv"] * c["g"]
            nbytes = (2 * c["b"] * c["kv"] * visible * c["hd"] * 2
                      + 2 * c["b"] * t * h * c["hd"] * 2 + c["b"] * 4)
            bnd, by = bound_ms(nbytes, 4.0 * c["b"] * h * t * visible * c["hd"])
            row = dict(t=t, fill=fill, visible=visible, ms=kern, plain_ms=plain,
                       library_ms=lib, bound_ms=bnd, bound_by=by, max_abs_err=err)
            rows.append(row)
            log(f"K2 t={t:2d} fill={fill:4d}: kernel {kern:.4f} ms, plain {plain:.4f} ms, "
                f"sdpa {lib:.4f} ms, bound {bnd:.4f} ms, max|d| {err:.2e}")
            if t == 1 and fill == c["s"]:
                record = row
    detail["k2"] = rows
    # one decode step at full fill: one launch per layer (32)
    return {"max_abs_err": max_err, "bound_by": record["bound_by"],
            **{k: 32 * record[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}


def check_k3(dev, detail: dict) -> dict:
    """K3 at b=8, KV=32, hd=128, S=1024 (the int8 serving phase's decode
    step), bf16 and f32 new rows, write positions 0, S-1, overrunning and
    negative starts among them: bit-exact against the plain version, every
    other row untouched. Timed in bf16; no one PyTorch call computes it."""
    import torch

    from llamago_tpu_torch.ops import cache_write

    gen = torch.Generator(device=dev).manual_seed(5)
    c = K3_SHAPE
    b, kv, hd, s = c["b"], c["kv"], c["hd"], c["s"]
    shape = (b, kv, s, hd)
    cache = [torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device=dev)
             for _ in range(2)]
    cache += [torch.rand(shape[:3], generator=gen, device=dev) for _ in range(2)]
    pos = torch.tensor([0, s - 1, s + 500, -5, 1, 512, 700, 2 * s - 1], dtype=torch.int32,
                       device=dev)
    slot = torch.tensor([0, s - 1, s - 1, s - 5, 1, 512, 700, s - 1], device=dev)
    written = torch.zeros((b, s), dtype=torch.bool, device=dev)
    written[torch.arange(b, device=dev), slot] = True
    for dtype in (torch.bfloat16, torch.float32):
        new = [torch.randn((b, 1, kv, hd), generator=gen, device=dev).to(dtype)
               for _ in range(2)]
        new[1][0, 0, 3] = 0  # a zero row: scale 1, row 0
        got = [a.clone() for a in cache]
        want = [a.clone() for a in cache]
        cache_write.cache_append_quant(*got, *new, pos)
        cache_write.cache_append_quant_plain(*want, *new, pos)
        torch.cuda.synchronize()
        for name, g, w, orig in zip(("k", "v", "ks", "vs"), got, want, cache):
            if not torch.equal(g, w):
                raise AssertionError(f"K3 {dtype}: {name} differs from the plain version")
            keep = ~written[:, None, :].expand(b, kv, s)
            if not torch.equal(g[keep], orig[keep]):
                raise AssertionError(f"K3 {dtype}: {name} changed a row it must not write")
        log(f"K3 {str(dtype).split('.')[-1]}: bit-exact against the plain version, "
            "other rows untouched")
    new = [torch.randn((b, 1, kv, hd), generator=gen, device=dev).to(torch.bfloat16)
           for _ in range(2)]
    pos = torch.full((b,), 700, dtype=torch.int32, device=dev)
    kern = timed([lambda: cache_write.cache_append_quant(*cache, *new, pos)], 200)
    plain = timed([lambda: cache_write.cache_append_quant_plain(*cache, *new, pos)], 20)
    n = b * kv * hd  # values per new K (or V) tensor
    # read the bf16 rows and the positions, write the int8 rows and f32 scales;
    # abs, max, divide and round per value in f32
    bnd, by = bound_ms(2 * n * 2 + 4 * b + 2 * n + 2 * b * kv * 4, 4.0 * 2 * n, F32_OPS_PER_S)
    row = dict(ms=kern, plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by)
    detail["k3"] = row
    log(f"K3 b={b}: kernel {kern:.4f} ms, plain {plain:.4f} ms, bound {bnd:.6f} ms "
        "(one layer)")
    # one decode step: one launch per layer (32)
    return {"max_abs_err": 0.0, "bound_by": by, "library_ms": None,
            **{k: 32 * row[k] for k in ("ms", "plain_ms", "bound_ms")}}


def _quant_cache(dev, gen, b, kv, s, hd):
    """int8 rows and f32 row scales of a normal cache."""
    import torch

    from llamago_tpu_torch.runtime.kv_cache import quantize_kv_rows

    return quantize_kv_rows(torch.randn((b, kv, s, hd), generator=gen, device=dev))


def _k4_error(q, k8, v8, positions, ks, vs, plain) -> float:
    """max |kernel - plain| over one call."""
    import torch

    from llamago_tpu_torch.ops import attention

    b, t, h, hd = q.shape
    got = attention.flash_attention_quant(q, k8, v8, positions, ks, vs).float()
    q5 = q.reshape(b, t, k8.shape[1], h // k8.shape[1], hd)
    ref = plain(q5, k8, v8, positions[:, 0].to(torch.int32), ks, vs)
    torch.cuda.synchronize()
    return (got - ref.reshape(got.shape).float()).abs().max().item()


def check_k4_k8(dev, detail: dict) -> tuple[dict, dict]:
    """K4 (i8dot) and K8 (widening) at b=8, KV=32, hd=128, S=1024 for fills
    1, 300 and 1024 and windows t=1 (decode) and t=32 (prefill bucket), q in
    bf16, checked and timed; a GQA geometry (g=8, hd=64, S=512) checked only.
    The yardstick is SDPA over a bf16 dequantized copy of the visible cache:
    the same function, reading twice the cache bytes."""
    import torch
    import torch.nn.functional as F

    from llamago_tpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(6)
    c = K4_SHAPE
    b, kv, g, hd, s = c["b"], c["kv"], c["g"], c["hd"], c["s"]
    h = kv * g
    caches = [(*_quant_cache(dev, gen, b, kv, s, hd), *_quant_cache(dev, gen, b, kv, s, hd))
              for _ in range(K4_COPIES)]  # (k8, ks, v8, vs)
    deq = [((k8.float() * ks[..., None]).to(torch.bfloat16),
            (v8.float() * vs[..., None]).to(torch.bfloat16)) for k8, ks, v8, vs in caches]
    out, default = [], attention._I8DOT
    for i8dot, name, plain, rate in (
            (True, "K4", attention.flash_attention_quant_i8dot_plain, INT8_OPS_PER_S),
            (False, "K8", attention.flash_attention_quant_plain, BF16_OPS_PER_S)):
        attention._I8DOT = i8dot
        rows, max_err, record = [], 0.0, None
        gb, gkv, gg, ghd, gs = 2, 2, 8, 64, 512
        gk8, gks = _quant_cache(dev, gen, gb, gkv, gs, ghd)
        gv8, gvs = _quant_cache(dev, gen, gb, gkv, gs, ghd)
        for t in (1, 16):
            gq = torch.randn((gb, t, gkv * gg, ghd), generator=gen, device=dev).bfloat16()
            gpos = torch.tensor([[190], [480]], device=dev) + torch.arange(t, device=dev)
            err = _k4_error(gq, gk8, gv8, gpos, gks, gvs, plain)
            if not err <= K4_TOL:
                raise AssertionError(f"{name} GQA t={t}: max|d| {err:.3g} > {K4_TOL}")
            max_err = max(max_err, err)
            log(f"{name} GQA g={gg} hd={ghd} S={gs} t={t}: max|d| {err:.2e}")
        for t in (1, 32):
            for fill in (1, 300, 1024):
                q = torch.randn((b, t, h, hd), generator=gen, device=dev).bfloat16()
                positions = (torch.full((b, 1), max(fill - t, 0), device=dev)
                             + torch.arange(t, device=dev)[None, :])
                k8, ks, v8, vs = caches[0]
                err = _k4_error(q, k8, v8, positions, ks, vs, plain)
                if not err <= K4_TOL:
                    raise AssertionError(f"{name} t={t} fill={fill}: max|d| {err:.3g} "
                                         f"> {K4_TOL}")
                max_err = max(max_err, err)
                visible = min(max(fill, t), s)  # slots seen by the last query row
                q5 = q.reshape(b, t, kv, g, hd)
                pos0 = positions[:, 0].to(torch.int32)
                kern = timed([lambda c_=c_: attention.flash_attention_quant(
                    q, c_[0], c_[2], positions, c_[1], c_[3]) for c_ in caches],
                    50 * K4_COPIES)
                plain_ms = timed([lambda c_=c_: plain(q5, c_[0], c_[2], pos0, c_[1], c_[3])
                                  for c_ in caches], 2 * K4_COPIES)
                qh = q.transpose(1, 2)
                mask = None
                if t > 1:
                    mask = torch.arange(visible, device=dev)[None, :] <= positions[0][:, None]
                lib = timed([lambda d=d: F.scaled_dot_product_attention(
                    qh, d[0][:, :, :visible], d[1][:, :, :visible], attn_mask=mask)
                    for d in deq], 50 * K4_COPIES)
                nbytes = (2 * b * kv * visible * (hd + 4) + 2 * b * t * h * hd * 2 + b * 4)
                bnd, by = bound_ms(nbytes, 4.0 * b * h * t * visible * hd, rate)
                row = dict(t=t, fill=fill, visible=visible, ms=kern, plain_ms=plain_ms,
                           library_ms=lib, bound_ms=bnd, bound_by=by, max_abs_err=err)
                rows.append(row)
                log(f"{name} t={t:2d} fill={fill:4d}: kernel {kern:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, sdpa on a bf16 copy {lib:.4f} ms, bound "
                    f"{bnd:.4f} ms, max|d| {err:.2e}")
                if t == 1 and fill == s:
                    record = row
        detail[name.lower()] = rows
        # one decode step at full fill: one launch per layer (32)
        out.append({"max_abs_err": max_err, "bound_by": record["bound_by"],
                    **{k: 32 * record[k] for k in ("ms", "plain_ms", "library_ms",
                                                    "bound_ms")}})
    attention._I8DOT = default
    del caches, deq
    torch.cuda.empty_cache()
    return out[0], out[1]


# ---------------------------------------------------------------- phase 3

def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_to_cpu(v) for v in tree)
    return tree.cpu()


def check_small_model(dev) -> int:
    """A small Q8_0 GQA model with head_dim 128: logits through the kernels
    on the card against the plain versions on the CPU (f32 compute), and
    greedy tokens of a short engine run on both; with the dense cache, then
    the int8 cache under K4 and under K8 (LLAMAGO_ATTN_I8DOT off). Returns
    the launches of K8 in its run."""
    import torch

    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        random_quantized_parameters,
    )
    from llamago_tpu_torch.config import GenerateConfig, ModelConfig
    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.ops import attention
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    dense = ModelConfig(vocab_size=4000, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                        multiple_of=256, max_seq_len=256, dtype="float32",
                        weight_dtype="int8")
    gpu = fuse_layer_weights(random_quantized_parameters(dense, seed=3, device=dev))
    # int8 weights with 0.01 scales give O(1) activations only with small scales
    for lp in gpu["layers"]:
        for leaf in ("wqkv", "wo", "w13", "w2"):
            lp[leaf]["s"] = torch.full_like(lp[leaf]["s"], 0.002)
    cpu = _to_cpu(gpu)
    toks = torch.randint(3, 4000, (2, 40), generator=torch.Generator().manual_seed(4))
    vocab = _byte_vocab(dense.vocab_size)
    gen = GenerateConfig(max_tokens=12, ctx_size=256, temp=0.0)
    default, k8_launches = attention._I8DOT, 0
    # t=40: einsum-math prefill; t=16: K2/K4/K8 prefill bucket; t=1: decode
    # (K2, or K3 and K4/K8)
    for name, cfg, i8dot in (("dense cache", dense, default),
                             ("int8 cache, K4", dense.replace(kv_dtype="int8"), True),
                             ("int8 cache, K8", dense.replace(kv_dtype="int8"), False)):
        attention._I8DOT = i8dot
        attention.flash_attention_quant.launches_widening = 0
        for t in (40, 16, 1):
            x = toks[:, :t]
            wp = torch.tensor([0, 7])
            lg, _ = forward_impl(gpu, x.to(dev), KVCache.create(cfg, batch=2, device=dev),
                                 wp.to(dev), cfg)
            lc, _ = forward_impl(cpu, x, KVCache.create(cfg, batch=2, device="cpu"), wp, cfg)
            lg = lg.cpu()
            if not torch.isfinite(lg).all():
                raise AssertionError(f"small model, {name}: non-finite logits on the card")
            err = (lg - lc).abs().max().item() / lc.abs().max().item()
            log(f"small model, {name}, t={t}: card vs CPU logits max|d|/max|ref| {err:.2e}")
            if not err <= 1e-3:
                raise AssertionError(f"small model, {name}, t={t}: logits differ, "
                                     f"{err:.3g} > 1e-3")
        outs = []
        for params, d in ((gpu, dev), (cpu, "cpu")):
            eng = Engine(cfg, params, vocab, slots=2, decode_chunk_size=4, device=d)
            outs.append(eng.generate("smoke test prompt", gen).output_tokens)
        log(f"small model, {name}, greedy tokens: card {outs[0]}, CPU {outs[1]}")
        if outs[0] != outs[1]:
            raise AssertionError(f"small model, {name}: greedy tokens differ between "
                                 "card and CPU")
        if not i8dot:
            k8_launches = attention.flash_attention_quant.launches_widening
    attention._I8DOT = default
    if k8_launches == 0:
        raise AssertionError("small model: K8 was never launched in its run")
    return k8_launches


INT4_LOGIT_TOL = {
    # card vs CPU, x max|logit|. K5 rounds activations to int8: where the
    # card's and the CPU's f32 sums leave an activation on either side of a
    # rounding boundary, one int8 step moves an output by sx * |w|, about
    # 1e-3 of a typical output at K=512, and later layers carry it on
    "w4x8": 5e-3,
    # f32 throughout: the order of the sums only, as for the Q8_0 model
    "q4_0": 1e-3,
    "q4_0, scale on output": 1e-3,
}


def check_small_model_int4(dev) -> dict:
    """A small GQA model with random int4 weights, card (kernels) against
    CPU (plain versions), f32 compute: logits for a 40-token window, a
    16-token window and a decode step, and greedy tokens of a short engine
    run; in the w4x8 format (K5 at decode, K6 in prefill; w2, whose K = 1376
    is no multiple of 128, stays Q4_0 and takes K1 bits=4: the mixed tree),
    in the Q4_0 format (K1 bits=4), and in the Q4_0 format with the
    scale-on-output switch at 8 rows (K9 at decode). Returns the launch
    counts of each run."""
    import torch

    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        random_quantized_parameters,
    )
    from llamago_tpu_torch.config import GenerateConfig, ModelConfig
    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.ops import kernels
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    cfg = ModelConfig(vocab_size=4000, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      ffn_dim=1376, max_seq_len=256, dtype="float32", weight_dtype="int4")
    toks = torch.randint(3, 4000, (2, 40), generator=torch.Generator().manual_seed(14))
    vocab = _byte_vocab(cfg.vocab_size)
    gen = GenerateConfig(max_tokens=12, ctx_size=256, temp=0.0)
    env, so_default = os.environ.get("LLAMAGO_INT4_EXEC"), kernels.SCALE_ON_OUTPUT_MAX_M
    counts = {}
    try:
        for name, fmt, so_max_m, must in (
                ("w4x8", "w4x8", 0, ("w4x8_matmul_a8", "w4x8_matmul_stream",
                                     "dequant_matmul_q4")),
                ("q4_0", "q4_0", 0, ("dequant_matmul_q4",)),
                ("q4_0, scale on output", "q4_0", 8, ("dequant_matmul_so",
                                                      "dequant_matmul_q4"))):
            os.environ["LLAMAGO_INT4_EXEC"] = fmt
            kernels.SCALE_ON_OUTPUT_MAX_M = so_max_m
            gpu = fuse_layer_weights(random_quantized_parameters(cfg, seed=13, device=dev))
            if ("q4x" in gpu["layers"][0]["wqkv"]) != (fmt == "w4x8") \
                    or "q4" not in gpu["layers"][0]["w2"]:
                raise AssertionError(f"small int4 model, {name}: unexpected leaf formats")
            cpu = _to_cpu(gpu)
            reset_launch_counts()
            for t in (40, 16, 1):
                x = toks[:, :t]
                wp = torch.tensor([0, 7])
                lg, _ = forward_impl(gpu, x.to(dev), KVCache.create(cfg, batch=2, device=dev),
                                     wp.to(dev), cfg)
                lc, _ = forward_impl(cpu, x, KVCache.create(cfg, batch=2, device="cpu"), wp,
                                     cfg)
                lg = lg.cpu()
                if not torch.isfinite(lg).all():
                    raise AssertionError(f"small int4 model, {name}: non-finite logits")
                err = (lg - lc).abs().max().item() / lc.abs().max().item()
                log(f"small int4 model, {name}, t={t}: card vs CPU logits max|d|/max|ref| "
                    f"{err:.2e}")
                if not err <= INT4_LOGIT_TOL[name]:
                    raise AssertionError(f"small int4 model, {name}, t={t}: logits differ, "
                                         f"{err:.3g} > {INT4_LOGIT_TOL[name]}")
            outs = []
            for tree, d in ((gpu, dev), (cpu, "cpu")):
                eng = Engine(cfg, tree, vocab, slots=2, decode_chunk_size=4, device=d)
                outs.append(eng.generate("smoke test prompt", gen).output_tokens)
            log(f"small int4 model, {name}, greedy tokens: card {outs[0]}, CPU {outs[1]}")
            if outs[0] != outs[1]:
                raise AssertionError(f"small int4 model, {name}: greedy tokens differ "
                                     "between card and CPU")
            counts[name] = launch_counts()
            log(f"small int4 model, {name}: launches {counts[name]}")
            idle = [k for k in must if counts[name][k] == 0]
            if idle or counts[name]["dequant_matmul"] > 0:
                raise AssertionError(f"small int4 model, {name}: {idle} never launched, or "
                                     f"the Q8_0 kernel did: {counts[name]}")
    finally:
        kernels.SCALE_ON_OUTPUT_MAX_M = so_default
        if env is None:
            os.environ.pop("LLAMAGO_INT4_EXEC", None)
        else:
            os.environ["LLAMAGO_INT4_EXEC"] = env
    return counts


# ---------------------------------------------------------------- phase 4

def _byte_vocab(vocab_size: int):
    """unk/bos/eos + 256 byte pieces + filler: byte fallback makes prompt
    length controllable and detokenization exact."""
    from llamago_tpu_torch.tokenizer import Vocab

    tokens = [(" ⁇ ".encode(), 0.0), (b"", 0.0), (b"", 0.0)]
    tokens += [(bytes([b]), -1000.0) for b in range(256)]
    tokens += [(f"<pad{i}>".encode(), -2000.0) for i in range(vocab_size - len(tokens))]
    return Vocab(tokens)


def _launch_counters():
    """(wrapper, attribute) holding each kernel's launch count, by name."""
    from llamago_tpu_torch.ops import attention, cache_write, kernels

    return {"dequant_matmul": (kernels.dequant_matmul, "launches"),
            "dequant_matmul_q4": (kernels.dequant_matmul, "launches_q4"),
            "w4x8_matmul_a8": (kernels.w4x8_matmul, "launches_a8"),
            "w4x8_matmul_stream": (kernels.w4x8_matmul, "launches_stream"),
            "dequant_matmul_so": (kernels.dequant_matmul_so, "launches"),
            "flash_attention": (attention.flash_attention, "launches"),
            "cache_append_quant": (cache_write.cache_append_quant, "launches"),
            "flash_attention_quant_i8dot": (attention.flash_attention_quant,
                                            "launches_i8dot"),
            "flash_attention_quant_widening": (attention.flash_attention_quant,
                                               "launches_widening")}


def reset_launch_counts() -> None:
    for fn, attr in _launch_counters().values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _launch_counters().items()}


def make_7b_params(dev, weight_dtype: str = "int8"):
    """Full-width, full-depth LLaMA-7B with random Q8_0 weights, or int4
    weights in the w4x8 format (seed 0), fused wqkv/w13, bf16 compute."""
    import torch

    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        random_quantized_parameters,
    )
    from llamago_tpu_torch.config import MODEL_PRESETS

    cfg = MODEL_PRESETS["7B"].replace(weight_dtype=weight_dtype, dtype="bfloat16")
    env = os.environ.get("LLAMAGO_INT4_EXEC")
    os.environ["LLAMAGO_INT4_EXEC"] = "w4x8"
    t0 = time.time()
    try:
        params = fuse_layer_weights(random_quantized_parameters(cfg, seed=0, device=dev))
    finally:
        if env is None:
            del os.environ["LLAMAGO_INT4_EXEC"]
        else:
            os.environ["LLAMAGO_INT4_EXEC"] = env
    torch.cuda.synchronize()
    log(f"7B {weight_dtype} params in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return cfg, params


def serve(dev, cfg, params, slots: int, n_jobs: int, rise: tuple) -> dict:
    """Serve n_jobs sampled HTTP jobs on `slots` decode slots, then the
    repeated greedy job, then profile one decode chunk. Every launch count
    is set to 0 before the engine warms up; those named in `rise` must have
    risen by the end of the sampled jobs, every other one must still be 0."""
    import torch

    from llamago_tpu_torch.config import GenerateConfig, ServerConfig
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.server.api import JobServer

    predict, prompt_tokens, chunk = 64, 48, 32
    engine = Engine(cfg, params, _byte_vocab(cfg.vocab_size), slots=slots,
                    decode_chunk_size=chunk, prefill_chunk=256, device=dev)
    gen = GenerateConfig(max_tokens=predict, ctx_size=cfg.max_seq_len, temp=0.8, seed=11)
    server = JobServer(engine, ServerConfig(host="127.0.0.1", port=0), gen,
                       model_name=f"7B-{cfg.weight_dtype}")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    warm_s = engine.warmup(max_bucket=engine._bucket(prompt_tokens + 2),
                           include_embed=False)
    server.start_background()
    port = server.port
    try:
        def post(body):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/jobs/",
                                         data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
                return json.loads(r.read())

        def run_jobs(bodies, timeout_s=600):
            for b in bodies:
                post(b)
            done, deadline = {}, time.time() + timeout_s
            while len(done) < len(bodies) and time.time() < deadline:
                time.sleep(0.05)
                for b in bodies:
                    if b["id"] not in done and \
                            get(f"/jobs/status/{b['id']}")["status"] in ("finished", "failed"):
                        done[b["id"]] = get(f"/jobs/{b['id']}")
            if len(done) < len(bodies):
                raise AssertionError(f"serve: {len(bodies) - len(done)} jobs did not finish")
            return [done[b["id"]] for b in bodies]

        prompts = [(f"request {i:03d}: " + "abcdefgh" * 40)[: prompt_tokens - 1]
                   for i in range(n_jobs)]
        bodies = [{"id": str(uuid.uuid4()), "prompt": p, "seed": 11 + i}
                  for i, p in enumerate(prompts)]
        t_start = time.time()
        jobs = run_jobs(bodies)
        t_total = time.time() - t_start
        metrics = get("/metrics")
        launches = launch_counts()
        failed = [j for j in jobs if j["status"] != "finished"]
        if failed:
            raise AssertionError(f"serve: {len(failed)} jobs failed: {failed[0].get('error')}")
        toks = [server.jobs[b["id"]].output_tokens for b in bodies]
        if any(len(t) != predict for t in toks):
            raise AssertionError(f"serve: token counts {[len(t) for t in toks]}")
        if any(not 0 <= x < cfg.vocab_size for t in toks for x in t):
            raise AssertionError("serve: a token id out of the vocabulary")
        if any((launches[k] > 0) != (k in rise) for k in launches):
            raise AssertionError(f"serve: launches {launches}; each of {rise} must rise "
                                 "and every other count stay 0")
        generated = metrics["generated_tokens"]

        # The greedy job runs twice into slot 0 with the same cache layout:
        # each run finds a slot whose history shares only BOS and the
        # leading space with it (the job F in between replaces the first
        # run's history), so both prefill the same rows in the same bucket.
        # A run that reused the first run's rows would prefill in other
        # chunks, and bf16 sums taken over other shapes may round apart.
        def greedy_job(prompt):
            body = {"id": str(uuid.uuid4()), "prompt": prompt, "temp": 0,
                    "max_tokens": 32}
            out = run_jobs([body])[0]
            return out["output"], server.jobs[body["id"]].output_tokens

        g_prompt = ("greedy check: " + "ijklmnop" * 40)[: prompt_tokens - 1]
        first = greedy_job(g_prompt)
        greedy_job(("flush: " + "qrstuvwx" * 40)[: prompt_tokens - 1])
        second = greedy_job(g_prompt)
        if first != second or len(first[1]) != 32:
            raise AssertionError(f"serve: the repeated greedy job gave different tokens: "
                                 f"{first[1]} vs {second[1]}")
    finally:
        server.shutdown()
    step = profile_decode(engine, chunk)
    result = {
        "model": f"7B {cfg.weight_dtype} (random, seed 0)", "kv_dtype": cfg.kv_dtype,
        "slots": slots, "jobs": n_jobs,
        "predict": predict, "prompt_tokens": prompt_tokens, "decode_chunk": chunk,
        "warmup_s": warm_s, "served_tokens": generated, "seconds": t_total,
        "served_tokens_per_s": generated / t_total,
        "ttft_ms_p50": metrics["ttft_ms"]["p50"], "ttft_ms_p95": metrics["ttft_ms"]["p95"],
        "launches": launches, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "decode_step": step,
    }
    log(f"{cfg.weight_dtype} weights, {cfg.kv_dtype} cache, {slots} slots: served "
        f"{generated} tokens in {t_total:.2f} s = "
        f"{result['served_tokens_per_s']:.1f} tok/s, TTFT p50 {result['ttft_ms_p50']} ms "
        f"p95 {result['ttft_ms_p95']} ms, peak {result['peak_gib']:.2f} GiB on the card, "
        f"launches {launches}")
    return result


def profile_decode(engine, chunk: int, traced: int = 4) -> dict:
    """Where a decode step's time goes: one greedy decode chunk of all
    slots, timed by the host clock (synchronized), then `traced` steps
    under torch.profiler for the device time per step and the kernels and
    host ops that take it. The profiler's own host cost lengthens the
    traced window, so the device's busy share is taken against the
    untraced step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llamago_tpu_torch.runtime.decode_loop import decode_chunk

    n = engine.n_slots
    dev = engine.device
    tok = torch.full((n,), 7, dtype=torch.long, device=dev)
    pos = torch.full((n,), 100, dtype=torch.long, device=dev)

    def run(steps):
        decode_chunk(engine.params, tok, engine.cache, pos, engine.config, steps)
        torch.cuda.synchronize()

    run(chunk)
    t0 = time.perf_counter()
    run(chunk)
    step_ms = (time.perf_counter() - t0) * 1e3 / chunk
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(traced)
        traced_ms = (time.perf_counter() - t0) * 1e3 / traced
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = device_busy_us(prof.events())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device activity")
    device_ms = busy / 1e3 / traced
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:10]
    out = {"slots": n, "step_ms": step_ms, "traced_step_ms": traced_ms,
           "device_busy_ms": device_ms,
           "device_busy_share": device_ms / step_ms,
           "top_kernels_ms_per_step": {k: v / 1e3 / traced for k, v in top},
           "top_host_ops_ms_per_step": {a.key: a.self_cpu_time_total / 1e3 / traced
                                        for a in host},
           "host_op_calls_per_step": sum(a.count for a in prof.key_averages()) / traced}
    log(f"decode step ({n} slots): {step_ms:.2f} ms host-timed, {traced_ms:.2f} ms traced, "
        f"device busy {device_ms:.3f} ms/step")
    for k, v in out["top_kernels_ms_per_step"].items():
        log(f"  device {v:8.3f} ms/step  {k[:100]}")
    for k, v in out["top_host_ops_ms_per_step"].items():
        log(f"  host   {v:8.3f} ms/step  {k[:100]}")
    return out


# ------------------------------------------------------------------ main

def main(argv: list[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    ap.add_argument("--out", default="", help="write the run's detail here as JSON")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run alone (prints no result lines)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        log("CUDA is not available: this smoke test needs a GPU")
        return 1
    from llamago_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    log(f"card: {card}")
    t0 = time.time()
    ptxas = _build.build_all(verbose=True)
    log(f"kernels built in {time.time() - t0:.1f} s")
    for name, text in ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    # float32 products in the references run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN")

    detail: dict = {"card": card}
    only = set(args.only.split(",")) if args.only else None

    def want(phase: str) -> bool:
        return only is None or phase in only

    k1 = check_k1(dev, detail) if want("k1") else {}
    k2 = check_k2(dev, detail) if want("k2") else {}
    k3 = check_k3(dev, detail) if want("k3") else {}
    k4, k8 = check_k4_k8(dev, detail) if want("k4k8") else ({}, {})
    k1q4 = check_k1(dev, detail, "q4") if want("k1q4") else {}
    k5 = check_k5(dev, detail) if want("k5") else {}
    k6 = check_k6(dev, detail) if want("k6") else {}
    k9 = check_k9(dev, detail) if want("k9") else {}
    k8_launches = check_small_model(dev) if want("small") else 0
    small4 = check_small_model_int4(dev) if want("small_int4") else {}
    detail["small_int4_launches"] = small4
    none = {"launches": launch_counts()}  # all 0: a phase that --only left out
    served = served_q = served_4 = none
    if want("serve") or want("serve_int8"):
        cfg, params = make_7b_params(dev)
        # phase 4: the bf16 cache on 4 slots; phase 4b: the int8 cache on 8
        if want("serve"):
            served = serve(dev, cfg, params, slots=4, n_jobs=8,
                           rise=("dequant_matmul", "flash_attention"))
            gc.collect()  # the phase 4 engine and its cache
            torch.cuda.empty_cache()
        if want("serve_int8"):
            served_q = serve(dev, cfg.replace(kv_dtype="int8"), params, slots=8, n_jobs=16,
                             rise=("dequant_matmul", "cache_append_quant",
                                   "flash_attention_quant_i8dot"))
        del params
        gc.collect()  # the int8 weights, the phase 4b engine and its cache
        torch.cuda.empty_cache()
    if want("serve_int4"):
        # phase 4c: int4 weights (w4x8), the bf16 cache on 4 slots
        cfg, params = make_7b_params(dev, "int4")
        served_4 = serve(dev, cfg, params, slots=4, n_jobs=8,
                         rise=("w4x8_matmul_a8", "w4x8_matmul_stream", "flash_attention"))
        del params
    detail["serve"], detail["serve_int8"], detail["serve_int4"] = served, served_q, served_4
    q4_run, so_run = small4.get("q4_0", {}), small4.get("q4_0, scale on output", {})
    kernels_line = {"kernels": [
        {"name": "dequant_matmul", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:237",
         "launches": served["launches"]["dequant_matmul"], **k1},
        {"name": "flash_attention", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_decode.cu",
         "replaces": "llamago_tpu/ops/attention.py:230",
         "launches": served["launches"]["flash_attention"], **k2},
        {"name": "cache_append_quant", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/cache_append.cu",
         "replaces": "llamago_tpu/ops/cache_write.py:63",
         "launches": served_q["launches"]["cache_append_quant"], **k3},
        {"name": "flash_attention_quant_i8dot", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_decode_quant.cu",
         "replaces": "llamago_tpu/ops/attention.py:406",
         "launches": served_q["launches"]["flash_attention_quant_i8dot"], **k4},
        {"name": "flash_attention_quant_widening", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/attn_decode_quant.cu",
         "replaces": "llamago_tpu/ops/attention.py:342",
         "launches": k8_launches, **k8},
        {"name": "w4x8_matmul_a8", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/w4x8_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:308",
         "launches": served_4["launches"]["w4x8_matmul_a8"], **k5},
        {"name": "w4x8_matmul_stream", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/w4x8_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:334",
         "launches": served_4["launches"]["w4x8_matmul_stream"], **k6},
        # K1 bits=4 and K9 run in the Q4_0 format, which phase 3 drives
        {"name": "dequant_matmul_q4", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul.cu",
         "replaces": "llamago_tpu/ops/kernels.py:237",
         "launches": q4_run.get("dequant_matmul_q4", 0), **k1q4},
        {"name": "dequant_matmul_so", "route": "cuda",
         "source": "llamago_tpu_torch/csrc/dequant_matmul_so.cu",
         "replaces": "llamago_tpu/ops/kernels.py:183",
         "launches": so_run.get("dequant_matmul_so", 0), **k9},
    ]}
    detail["kernels"] = kernels_line
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(detail, f, indent=1)
    if only is not None:
        log(f"ran only {sorted(only)}: no result lines")
        return 0
    if any(k["launches"] == 0 for k in kernels_line["kernels"]):
        raise AssertionError(f"a kernel was never launched on its path: {kernels_line}")
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        code = 1
    sys.exit(code)
