#!/usr/bin/env python3
"""K2, K4, K8 (decode attention), K7 (prefill attention), K2's and K7's f32
forms, K5 (the W4A8 decode matmul), K1's and K6's tiles with f32 x, K1's
and K9's decode matmuls with f32 x, K9 above 8 rows, K3 (the int8 cache
append), K10 (RMSNorm), the lab's float or integer rows or its probes of
several checkouts on one card, side by side.

    python3 k2_pair.py [--kernel k2|k3|k4|k8|k7|k7cells|attn32|k5|f32mm|f32dec|k9tile|k10|
                                 lab|labint|probe]
                       [--k8-splits N,...]
                       [--k7-chunks N,...] [--k3-warps N,...] [--k10-threads N,...]
                       [--out FILE.json] ROOT [ROOT ...]

Each ROOT is a checkout of this repository; its `llamago_tpu_torch`
builds its kernels into ROOT/build at first use. For each ROOT, in the
order given and each in a process of its own that imports that checkout's
package (and this checkout's chip_smoke.py for the helpers), it reports:

  - `--kernel k2` (the default): K2 at chip_smoke's geometry (b=4, KV=32,
    hd=128, S=1024, bf16 cache): t=1 at fills 1, 63, 64, 65, 101 (the
    serving fill), 300 and 1024, and t=32 at fills 1, 300 and 1024; then
    phase 4's decode step: 7B Q8_0 (random, seed 0), the bf16 cache, 4
    slots at position 100.
  - `--kernel k3`: K3 at chip_smoke's K3_SHAPE (b=8, KV=32, hd=128,
    S=1024, bf16 rows, f32 planes) on the serving path's inputs (v a
    strided view of the fused projection, int64 positions: chip_smoke's
    `k3_serving_rows`) and on contiguous rows with int32 positions: device
    time a call, the device-side operations a call (chip_smoke's
    `device_ops_per_call`), bit-exact against the plain version; the card's floor for one small launch; with
    `--k3-warps` again at those warps a block (`cache_write.APPEND_WARPS`)
    in the checkouts that have it; then phase 4b's decode step (7B Q8_0,
    the int8 cache, 8 slots at position 100): device busy, device kernels
    and host op calls a step, K3's time a step (`append_ms`), and 16 greedy
    tokens of every slot after it.
  - `--kernel k10`: K10 (bf16, d=4096) at 4, 64 and 256 rows beside
    `F.rms_norm`, the launch floor; with `--k10-threads` again at those
    threads a row, in place of `kernels.norm_plan`'s, in the checkouts
    that have it; then phase 4d's decode step with K7 and
    K10 on (7B Q8_0, 4 slots, chip_smoke's `opt_in_routes`), K10's time a
    step among it (`norm_ms`).
  - `--kernel k4`: K4 at chip_smoke's K4_SHAPE (b=8, KV=32, hd=128,
    S=1024, the int8 cache with f32 scale planes, q in bf16) at
    chip_smoke's K4_WINDOWS (t=1 at fills 1 to 1024 with the serving fill
    101 and the S-block's edges 255-257, t=16 and t=32); then phase 4b's
    decode step: 7B Q8_0, the int8 cache, 8 slots at position 100.
  - `--kernel k8`: K8 (LLAMAGO_ATTN_I8DOT=0) at K4_SHAPE with bf16 q at
    chip_smoke's K8_WINDOWS and t=1 at fills 64, 65 and 101; then phase
    4b's decode step with K8 and K9 on (chip_smoke's `k8_k9_routes`), the
    matmul kernels' time (`matmul_ms`) beside `attention_ms`. With
    `--k8-splits`, the rows again for each number of slots a split (a
    multiple of 64, at most S) in place of `k8_split`'s, in the checkouts
    that have it.
  - `--kernel k7`: K7 at chip_smoke's K7_SHAPE (b=1, KV=32, hd=128,
    S=1024, bf16) at its K7_WINDOWS, each beside SDPA with a boolean mask
    over the visible prefix (chip_smoke's yardstick) in the same process;
    then phase 4d's 256-token prefill chunk with K7 and K10 on (7B Q8_0, 4
    slots, chip_smoke's `opt_in_routes`): device busy and `attention_ms`.
    With `--k7-chunks`, the rows again for each number of slots a chunk (a
    multiple of 64) in place of `k7_chunk`'s, in the checkouts that have it.
  - `--kernel k7cells`: K7 (bf16) at the benchmark cells' shapes,
    Mistral-7B's b=1, KV=8, g=4, hd=128 (K7_CELL_WINDOWS): longdoc's
    1024-row chunks over S=8192 at write positions 0, 3072 and 6144, and
    chat's 256-row chunks over S=2048 at 0, 512 and 1536 and a 64-row
    bucket at 0. Each window is called once into NaN-filled memory (every
    call must take the prefill_tc form), held against the plain version
    (max |d| / max(1, |plain|) within chip_smoke's K7_TOL), called again,
    which must give the same bits, and timed beside the plain version, the
    einsum math (`attention_math`, the route these windows took before K7
    was the card's default), SDPA with enable_gqa and a boolean mask over
    the visible prefix, and the bound of the visible causal work (bytes
    or bf16 operations, chip_smoke's `bound_ms`).
  - `--kernel attn32`: K7 and K2 over f32 caches, the form each checkout
    takes there: K7 at chip_smoke's K7_SHAPE and K7_WINDOWS, K2 at its
    K2_SHAPE (b=4, KV=32, hd=128, S=1024) at t=1, 16 and 32, each at fills
    101 and 1024 (chip_smoke's K2_F32_WINDOWS), each beside SDPA on the same
    f32 tensors with a boolean mask over the visible prefix, max|kernel -
    plain| (K7: over max(1, |plain|)).
  - `--kernel k5`: K5 (`kernels.w4x8_matmul` at m <= 16, random w4x8
    weights, bf16 x) at m = 4 and 16 over chip_smoke's five INT4_SHAPES
    (chip_smoke's `check_matmul`: each shape checked against the plain
    version and timed over copies that stream past the L2, beside `x @ W`
    on a bf16 copy; one pass = one 7B decode step's 129 calls); then phase
    4c's decode step: 7B int4 (w4x8, random, seed 0), the bf16 cache, 4
    slots at position 100, with `matmul_ms` and the kernels it counted.
  - `--kernel f32mm`: K1 (Q8_0, then Q4_0) and K6 with f32 x, the form
    each checkout takes there (`kernels.dequant_matmul`), at m = 17, 64,
    100 and 256 over chip_smoke's five shapes (chip_smoke's `check_matmul`:
    each shape checked against the plain version and timed over copies
    that stream past the L2, beside `x @ W` in f32; one pass = one 7B
    prefill pass's 129 calls, its bound three bf16 passes), and at m = 64
    and 256 one pass's device time by kernel (e.g. x's split into three
    bf16 planes apart from the tile, weights warm in L2); then phase 4e's
    64-token prefill chunk (7B Q8_0, random, seed 0, f32 compute, 4 slots):
    host ms, device busy and `matmul_ms` with the kernels it counted.
  - `--kernel f32dec`: K1 (Q8_0 and Q4_0, each with bf16 scales, as the
    random 7B weights have them, and with f32 scales, as a file brings
    them) and K9 (Q4_0, `kernels.dequant_matmul_so`) with f32 x, the form
    each checkout takes there, at m = 1, 2, 4 and 8 over chip_smoke's five
    shapes (chip_smoke's `check_matmul`: each shape checked against the
    plain version and timed over copies that stream past the L2, beside
    `x @ W` in f32; one pass = one 7B decode step's 129 calls); then phase
    4e's decode step (7B Q8_0, random, seed 0, f32 compute, the f32 cache,
    4 slots at position 100): device busy, `matmul_ms` with the kernels it
    counted, device kernels and host op calls a step.
  - `--kernel k9tile`: K9 (`kernels.dequant_matmul_so`, the form each
    checkout takes above 8 rows) at m = 9, 16, 64 and 256 for Q8_0 and
    Q4_0, each with bf16 and with f32 x, over chip_smoke's five shapes
    (chip_smoke's `check_matmul`: each shape checked against the plain
    version, f32 and bf16 x, and timed over copies that stream past the
    L2, beside `x @ W` in x's dtype; one pass = one 7B prefill pass's 129
    calls, its bound the bytes or the bf16 operations, three passes of them
    with f32 x).
  - `--kernel probe`: the lab's L11 probes decode_only, decode_bitcast and
    dma_only, and L1's `base` (K1's decode form at m = 8), at the lab's
    shape as `--kernel lab` times them, each probe first held against its
    plain version (max|d| over K * 8 * max|s|, chip_smoke's
    LAB_PROBE_TOL); each probe's device us a call by kernel (its launch and
    its reduce) over the 24 layers; the static SASS instructions of each
    probe mode's main loop (`cuobjdump -sass`, 64 packed bytes a lane and
    pass) and the SM clock (`nvidia-smi`), for decode_bitcast's issue bound.
  - `--kernel lab`: the kernel lab's six float variants (rows L2, L3, L9,
    L12: i4native, bf16dot, split_bf16_h, bitcast_i4, bitcast_i4_bf16,
    w16dot) and L1's `base` at the lab's shape (K=8192, N=7168, m=8, 24
    layers; chip_smoke's LAB_SHAPE, LAB_STEPS, LAB_REPS), device time per
    launch of each variant's kernels (`kernel_lab.run_variant`), beside `x
    @ W` on the bf16 layers.
  - `--kernel labint`: the same for the lab's eleven integer variants
    (rows L6, L7, L8, L10) and L1's `base` and L5's `base8`.

Each row: device ms per call (the busy time of every kernel the call
launches, chip_smoke's `timed`, over three cache copies that a cycle of
calls streams past the L2) and max|kernel - plain|; the inputs are the same
in every process (seeded per row). The decode step (chip_smoke's
`profile_decode`): device busy and `attention_ms` (device time of the
attention kernels) per step, and the names of the kernels that
`attention_ms` counted.

Name the roots mirrored (parent, change, change, parent) to read each
one's spread. One JSON object per run goes to stdout and, as a list, to
--out. Needs one card; exits 1 if a run fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
STEP_KEYS = ("step_ms", "device_busy_ms", "attention_ms", "attention_kernels")
K8_EXTRA = [(1, 64), (1, 65), (1, 101)]
WINDOWS = [(1, f) for f in (1, 63, 64, 65, 101, 300, 1024)] + [(32, f) for f in (1, 300, 1024)]
# K2's f32 windows (t, fill), as chip_smoke's K2_F32_WINDOWS (an older
# chip_smoke.py may lack them)
K2_F32_WINDOWS = ((1, 101), (1, 1024), (16, 101), (16, 1024), (32, 101), (32, 1024))


def _smoke():
    """This checkout's chip_smoke.py as a module; the package it imports is
    the first `llamago_tpu_torch` on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_k4(cs, root: str) -> dict:
    import torch

    from llamago_tpu_torch.ops import attention
    from llamago_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    c = cs.K4_SHAPE
    b, kv, g, hd, s = c["b"], c["kv"], c["g"], c["hd"], c["s"]
    gen = torch.Generator(device=dev).manual_seed(6)
    caches = [(*cs._quant_cache(dev, gen, b, kv, s, hd), *cs._quant_cache(dev, gen, b, kv, s, hd))
              for _ in range(cs.K4_COPIES)]  # (k8, ks, v8, vs)
    rows = []
    for t, fill in cs.K4_WINDOWS:
        gen = torch.Generator(device=dev).manual_seed(1000 * t + fill)
        q = torch.randn((b, t, kv * g, hd), generator=gen, device=dev).bfloat16()
        positions = (torch.full((b, 1), max(fill - t, 0), device=dev)
                     + torch.arange(t, device=dev)[None, :])
        k8, ks, v8, vs = caches[0]
        got = attention.flash_attention_quant(q, k8, v8, positions, ks, vs).float()
        ref = attention.flash_attention_quant_i8dot_plain(
            q.reshape(b, t, kv, g, hd), k8, v8, positions[:, 0].to(torch.int32), ks, vs)
        err = (got - ref.reshape(got.shape).float()).abs().max().item()
        ms = cs.timed([lambda c_=c_: attention.flash_attention_quant(
            q, c_[0], c_[2], positions, c_[1], c_[3]) for c_ in caches], 50 * cs.K4_COPIES)
        rows.append(dict(t=t, fill=fill, ms=ms, max_abs_err=err))
        cs.log(f"{root}: K4 t={t:2d} fill={fill:4d}: {ms:.4f} ms, max|d| {err:.2e}")
    del caches
    torch.cuda.empty_cache()
    cfg, params = cs.make_7b_params(dev)
    engine = Engine(cfg.replace(kv_dtype="int8"), params, cs._byte_vocab(cfg.vocab_size),
                    slots=8, decode_chunk_size=32, prefill_chunk=256, device=dev)
    step = cs.profile_decode(engine, 32)
    return {"root": root, "card": cs.card_line(), "k4": rows,
            "decode_step": {k: step[k] for k in STEP_KEYS}}


def run_k8(cs, root: str, splits: list[int]) -> dict:
    import torch

    from llamago_tpu_torch.ops import attention
    from llamago_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    c = cs.K4_SHAPE
    b, kv, g, hd, s = c["b"], c["kv"], c["g"], c["hd"], c["s"]
    gen = torch.Generator(device=dev).manual_seed(6)
    caches = [(*cs._quant_cache(dev, gen, b, kv, s, hd), *cs._quant_cache(dev, gen, b, kv, s, hd))
              for _ in range(cs.K4_COPIES)]  # (k8, ks, v8, vs)
    default_i8dot, default_split = attention._I8DOT, getattr(attention, "k8_split", None)
    attention._I8DOT = False
    out = {"root": root, "card": cs.card_line()}
    plans = [("plan", None)] + ([(f"split {n}", n) for n in splits] if default_split else [])
    try:
        for label, n in plans:
            if n is not None:
                attention.k8_split = lambda t, g_, s_, n=n: min(n, s_)
            rows = []
            for t, fill in cs.K8_WINDOWS + K8_EXTRA:
                gen = torch.Generator(device=dev).manual_seed(1000 * t + fill)
                q = torch.randn((b, t, kv * g, hd), generator=gen, device=dev).bfloat16()
                positions = (torch.full((b, 1), max(fill - t, 0), device=dev)
                             + torch.arange(t, device=dev)[None, :])
                k8, ks, v8, vs = caches[0]
                got = attention.flash_attention_quant(q, k8, v8, positions, ks, vs).float()
                ref = attention.flash_attention_quant_plain(
                    q.reshape(b, t, kv, g, hd), k8, v8, positions[:, 0].to(torch.int32), ks, vs)
                err = (got - ref.reshape(got.shape).float()).abs().max().item()
                ms = cs.timed([lambda c_=c_: attention.flash_attention_quant(
                    q, c_[0], c_[2], positions, c_[1], c_[3]) for c_ in caches],
                    50 * cs.K4_COPIES)
                rows.append(dict(t=t, fill=fill, ms=ms, max_abs_err=err))
                cs.log(f"{root} ({label}): K8 t={t:2d} fill={fill:4d}: {ms:.4f} ms, "
                       f"max|d| {err:.2e}")
            out["k8" if n is None else f"k8_split_{n}"] = rows
    finally:
        attention._I8DOT = default_i8dot
        if default_split is not None:
            attention.k8_split = default_split
    del caches
    torch.cuda.empty_cache()
    cfg, params = cs.make_7b_params(dev)
    with cs.k8_k9_routes():
        engine = Engine(cfg.replace(kv_dtype="int8"), params, cs._byte_vocab(cfg.vocab_size),
                        slots=8, decode_chunk_size=32, prefill_chunk=256, device=dev)
        step = cs.profile_decode(engine, 32)
    out["decode_step"] = {k: step[k] for k in (*STEP_KEYS, "matmul_ms", "matmul_kernels")}
    return out


LAB_NAMES = ("base", "i4native", "bf16dot", "split_bf16_h", "bitcast_i4", "bitcast_i4_bf16",
             "w16dot")
LAB_INT_NAMES = ("base", "base8", "w4a8", "w4a8_raw", "w4a8_h", "w8a8", "w8a8_h", "w8a8_fulltk",
                 "w4a8_split_fulltk", "bitcast_i4_i8dot", "bitcast_i4_i4dot",
                 "bitcast_i4_i8dot_g128", "bitcast_i4_i8dot_g128_lazy")


def run_k7(cs, root: str, chunks: list[int]) -> dict:
    import torch
    import torch.nn.functional as F

    from llamago_tpu_torch.ops import attention
    from llamago_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    c = cs.K7_SHAPE
    default_chunk = getattr(attention, "k7_chunk", None)
    plans = [("plan", None)] + ([(f"chunk {n}", n) for n in chunks] if default_chunk else [])
    out = {"root": root, "card": cs.card_line()}
    try:
        for label, n in plans:
            if n is not None:
                attention.k7_chunk = lambda b, kv, t, g, s, n=n: n
            rows = []
            for t, pos0 in cs.K7_WINDOWS:
                gen = torch.Generator(device=dev).manual_seed(1000 * t + pos0)
                q, kc, vc, positions = cs._k7_inputs(dev, gen, t, pos0, c, "bfloat16")
                got = attention.flash_attention(q, kc, vc, positions).float()
                ref = attention.flash_attention_prefill_plain(
                    q.reshape(1, t, c["kv"], c["g"], c["hd"]), kc, vc,
                    positions[:, 0].to(torch.int32)).reshape(got.shape).float()
                err = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
                caches = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(cs.K7_COPIES - 1)]
                ms = cs.timed([lambda kv=kv: attention.flash_attention(q, *kv, positions)
                               for kv in caches], 25 * cs.K7_COPIES)
                qh, visible = q.transpose(1, 2), pos0 + t
                mask = torch.arange(visible, device=dev)[None, :] <= positions[0][:, None]
                sdpa = cs.timed([lambda kv=kv: F.scaled_dot_product_attention(
                    qh, kv[0][:, :, :visible], kv[1][:, :, :visible], attn_mask=mask)
                    for kv in caches], 25 * cs.K7_COPIES)
                del caches
                rows.append(dict(t=t, pos0=pos0, ms=ms, sdpa_ms=sdpa, max_abs_err=err))
                cs.log(f"{root} ({label}): K7 t={t:3d} pos0={pos0:3d}: {ms:.4f} ms, SDPA "
                       f"{sdpa:.4f} ms, max|d| {err:.2e}")
            out["k7" if n is None else f"k7_chunk_{n}"] = rows
    finally:
        if default_chunk is not None:
            attention.k7_chunk = default_chunk
    torch.cuda.empty_cache()
    cfg, params = cs.make_7b_params(dev)
    with cs.opt_in_routes():
        engine = Engine(cfg, params, cs._byte_vocab(cfg.vocab_size), slots=4,
                        decode_chunk_size=32, prefill_chunk=256, device=dev)
        chunk = cs.profile_prefill(engine, 256)
    out["prefill_chunk_256"] = {k: chunk[k] for k in ("device_busy_ms", "attention_ms",
                                                       "matmul_ms")}
    return out


# K7 at the benchmark cells' shapes (`--kernel k7cells`): Mistral-7B's
# attention geometry and its windows (S, t, pos0) in the two cells
K7_CELL_SHAPE = dict(b=1, kv=8, g=4, hd=128)
K7_CELL_WINDOWS = ((8192, 1024, 0), (8192, 1024, 3072), (8192, 1024, 6144),
                   (2048, 256, 0), (2048, 256, 512), (2048, 256, 1536), (2048, 64, 0))
K7_CELL_STREAM_BYTES = 120e6  # a cycle of cache copies at least this long passes the L2


def run_k7cells(cs, root: str) -> dict:
    import torch
    import torch.nn.functional as F

    from llamago_tpu_torch.ops import attention

    dev = torch.device("cuda")
    rows = []
    for s, t, pos0 in K7_CELL_WINDOWS:
        c = dict(K7_CELL_SHAPE, s=s)
        h = c["kv"] * c["g"]
        gen = torch.Generator(device=dev).manual_seed(1000 * t + pos0 + s)
        q, kc, vc, positions = cs._k7_inputs(dev, gen, t, pos0, c, "bfloat16")
        first = cs._k7_call(q, kc, vc, positions)
        err = cs._k7_error(q, kc, vc, positions, c, got=first)
        if not err <= cs.K7_TOL:
            raise AssertionError(f"K7 S={s} t={t} pos0={pos0}: max|d| {err:.3g} > {cs.K7_TOL}")
        if not torch.equal(cs._k7_call(q, kc, vc, positions), first):
            raise AssertionError(f"K7 S={s} t={t} pos0={pos0}: a second call gave other bits")
        pair = 2 * kc.numel() * kc.element_size()
        n = max(2, -(-int(K7_CELL_STREAM_BYTES) // pair))
        caches = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n - 1)]
        q5 = q.reshape(c["b"], t, c["kv"], c["g"], c["hd"])
        p0 = positions[:, 0].to(torch.int32)
        visible = pos0 + t
        kern = cs.timed([lambda kv=kv: attention.flash_attention(q, *kv, positions)
                         for kv in caches], 10 * n)
        plain = cs.timed([lambda kv=kv: attention.flash_attention_prefill_plain(q5, *kv, p0)
                          for kv in caches], n)
        math = cs.timed([lambda kv=kv: attention.attention_math(q, *kv, positions)
                         for kv in caches], n)
        qh = q.transpose(1, 2)
        mask = torch.arange(visible, device=dev)[None, :] <= positions[0][:, None]
        sdpa = cs.timed([lambda kv=kv: F.scaled_dot_product_attention(
            qh, kv[0][:, :, :visible], kv[1][:, :, :visible], attn_mask=mask, enable_gqa=True)
            for kv in caches], 10 * n)
        del caches
        nbytes = (2 * c["b"] * c["kv"] * visible * c["hd"] * 2
                  + 2 * c["b"] * t * h * c["hd"] * 2 + c["b"] * 4)
        ops = 4.0 * c["b"] * h * c["hd"] * (t * pos0 + t * (t + 1) / 2)
        bnd, by = cs.bound_ms(nbytes, ops)
        rows.append(dict(s=s, t=t, pos0=pos0, ms=kern, plain_ms=plain, math_ms=math,
                         sdpa_ms=sdpa, bound_ms=bnd, bound_by=by, bound_share=bnd / kern,
                         tflop_s=ops / kern / 1e9, max_abs_err=err))
        cs.log(f"{root}: K7 S={s} t={t:4d} pos0={pos0:4d}: {kern:.4f} ms ({100 * bnd / kern:.1f}% "
               f"of its bound {bnd:.4f} ms, {by}; {ops / kern / 1e9:.0f} TFLOP/s), plain "
               f"{plain:.4f}, einsum math {math:.4f}, SDPA {sdpa:.4f} ms, max|d| {err:.2e}")
    return {"root": root, "card": cs.card_line(), "k7cells": rows}


def run_attn32(cs, root: str) -> dict:
    import torch
    import torch.nn.functional as F

    from llamago_tpu_torch.ops import attention

    dev = torch.device("cuda")
    out = {"root": root, "card": cs.card_line()}
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    c = cs.K7_SHAPE
    for t, pos0 in cs.K7_WINDOWS:
        gen = torch.Generator(device=dev).manual_seed(1000 * t + pos0)
        q, kc, vc, positions = cs._k7_inputs(dev, gen, t, pos0, c, "float32")
        got = attention.flash_attention(q, kc, vc, positions)
        ref = attention.flash_attention_prefill_plain(
            q.reshape(1, t, c["kv"], c["g"], c["hd"]), kc, vc,
            positions[:, 0].to(torch.int32)).reshape(got.shape)
        err = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
        caches = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(cs.K7_COPIES - 1)]
        ms = cs.timed([lambda kv=kv: attention.flash_attention(q, *kv, positions)
                       for kv in caches], 25 * cs.K7_COPIES)
        qh, visible = q.transpose(1, 2), pos0 + t
        mask = torch.arange(visible, device=dev)[None, :] <= positions[0][:, None]
        sdpa = cs.timed([lambda kv=kv: F.scaled_dot_product_attention(
            qh, kv[0][:, :, :visible], kv[1][:, :, :visible], attn_mask=mask)
            for kv in caches], 25 * cs.K7_COPIES)
        del caches
        rows.append(dict(t=t, pos0=pos0, ms=ms, sdpa_ms=sdpa, max_err=err))
        cs.log(f"{root}: K7 f32 t={t:3d} pos0={pos0:3d}: {ms * 1e3:.1f} us, SDPA "
               f"{sdpa * 1e3:.1f} us, max|d| {err:.2e}")
    out["k7_f32"] = rows
    c = cs.K2_SHAPE
    rows = []
    for t, fill in K2_F32_WINDOWS:
        gen = torch.Generator(device=dev).manual_seed(1000 * t + fill)
        q, kc, vc, positions = cs._k2_inputs(dev, gen, t, fill, c, "float32")
        got = attention.flash_attention(q, kc, vc, positions)
        ref = attention.flash_attention_plain(
            q.reshape(c["b"], t, c["kv"], c["g"], c["hd"]), kc, vc,
            positions[:, 0].to(torch.int32)).reshape(got.shape)
        err = (got - ref).abs().max().item()
        caches = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(cs.K2_COPIES - 1)]
        ms = cs.timed([lambda kv=kv: attention.flash_attention(q, *kv, positions)
                       for kv in caches], 50 * cs.K2_COPIES)
        visible = min(max(fill, t), c["s"])
        qh = q.transpose(1, 2)
        mask = (None if t == 1 else
                torch.arange(visible, device=dev)[None, :] <= positions[0][:, None])
        sdpa = cs.timed([lambda kv=kv: F.scaled_dot_product_attention(
            qh, kv[0][:, :, :visible], kv[1][:, :, :visible], attn_mask=mask)
            for kv in caches], 50 * cs.K2_COPIES)
        del caches
        rows.append(dict(t=t, fill=fill, ms=ms, sdpa_ms=sdpa, max_err=err))
        cs.log(f"{root}: K2 f32 t={t:2d} fill={fill:4d}: {ms * 1e3:.1f} us, SDPA "
               f"{sdpa * 1e3:.1f} us, max|d| {err:.2e}")
    out["k2_f32"] = rows
    return out


def run_k5(cs, root: str) -> dict:
    import torch

    from llamago_tpu_torch.ops import kernels
    from llamago_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    detail: dict = {}
    errs, steps = cs.check_matmul(dev, detail, "K5", "q4x", kernels.w4x8_matmul,
                                  kernels.w4x8_matmul_a8_plain, timed_m=(4, 16), other_m=(),
                                  ops_per_s=lambda m: cs.INT8_OPS_PER_S, seed=9)
    torch.cuda.empty_cache()
    cfg, params = cs.make_7b_params(dev, "int4")
    engine = Engine(cfg, params, cs._byte_vocab(cfg.vocab_size), slots=4, decode_chunk_size=32,
                    prefill_chunk=256, device=dev)
    step = cs.profile_decode(engine, 32)
    return {"root": root, "card": cs.card_line(), "k5": detail["k5"],
            "k5_pass": {str(m): v for m, v in steps.items()},
            "max_err": {f"{m} {xdt}": e for (m, xdt), e in errs.items()},
            "decode_step": {k: step[k] for k in (*STEP_KEYS, "matmul_ms", "matmul_kernels")}}


F32MM_ROWS = (17, 64, 100, 256)


def pass_by_kernel(cs, dev, fmt: str, m: int) -> dict:
    """Device ms by kernel name over one 7B prefill pass of the f32 x
    matmul at m rows (each shape's calls, per step, times its share of 10
    traced calls on warm weights)."""
    import re

    import torch

    from llamago_tpu_torch.ops import kernels
    from llamago_tpu_torch.utils.timing import device_us_by_name, profiled

    gen = torch.Generator(device=dev).manual_seed(3)
    total: dict[str, float] = {}
    for _, k, n, per in (cs.K1_SHAPES if fmt != "q4x" else cs.INT4_SHAPES):
        w = cs._random_leaf(gen, dev, fmt, k, n)
        x = torch.randn((m, k), generator=gen, device=dev)
        kernels.dequant_matmul(x, w)
        by = device_us_by_name(profiled(lambda: [kernels.dequant_matmul(x, w)
                                                 for _ in range(10)]))
        for key, us in by.items():
            hit = re.search(r"(\w+)(?:<[^()]*>)?\(", key)  # the kernel's own name
            name = hit.group(1) if hit else key[:40]
            total[name] = total.get(name, 0.0) + per * us / 10 / 1e3
    return total


def run_f32mm(cs, root: str) -> dict:
    import torch

    from llamago_tpu_torch.ops import kernels
    from llamago_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    out = {"root": root, "card": cs.card_line()}
    for tag, fmt, plain, seed in (("k1_q8", "q8", kernels.dequant_matmul_plain, 2),
                                  ("k1_q4", "q4", kernels.dequant_matmul_plain, 8),
                                  ("k6", "q4x", kernels.w4x8_matmul_stream_plain, 19)):
        detail: dict = {}
        errs, steps = cs.check_matmul(dev, detail, tag, fmt, kernels.dequant_matmul, plain,
                                      timed_m=F32MM_ROWS, other_m=(),
                                      ops_per_s=lambda m: cs.F32_TC_OPS_PER_S, seed=seed,
                                      timed_dtype="float32")
        out[tag] = detail[tag]
        out[f"{tag}_pass"] = {str(m): v for m, v in steps.items()}
        out[f"{tag}_max_err"] = {f"{m} {xdt}": e for (m, xdt), e in errs.items()}
        for m in (64, 256):
            out[f"{tag}_pass_by_kernel_{m}"] = by = pass_by_kernel(cs, dev, fmt, m)
            ranked = sorted(by.items(), key=lambda kv: -kv[1])
            cs.log(f"{root}: {tag} m={m} one pass by kernel (ms): "
                   + ", ".join(f"{k} {v:.3f}" for k, v in ranked))
        torch.cuda.empty_cache()
    cfg, params = cs.make_7b_params(dev, "int8", dtype="float32")
    engine = Engine(cfg, params, cs._byte_vocab(cfg.vocab_size), slots=4, decode_chunk_size=32,
                    prefill_chunk=256, device=dev)
    chunk = cs.profile_prefill(engine, 64)
    out["prefill_chunk_64"] = {k: chunk[k] for k in ("host_ms", "device_busy_ms", "matmul_ms",
                                                      "top_kernels_ms")}
    return out


F32DEC_ROWS = (1, 2, 4, 8)


def run_f32dec(cs, root: str) -> dict:
    import torch

    from llamago_tpu_torch.ops import kernels
    from llamago_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    out = {"root": root, "card": cs.card_line()}
    for tag, fmt, sdt, fn, plain, seed in (
            ("k1_q8", "q8", "bfloat16", kernels.dequant_matmul, kernels.dequant_matmul_plain, 2),
            ("k1_q8_f32s", "q8", "float32", kernels.dequant_matmul,
             kernels.dequant_matmul_plain, 3),
            ("k1_q4", "q4", "bfloat16", kernels.dequant_matmul, kernels.dequant_matmul_plain, 8),
            ("k1_q4_f32s", "q4", "float32", kernels.dequant_matmul,
             kernels.dequant_matmul_plain, 9),
            ("k9_q4", "q4", "bfloat16", kernels.dequant_matmul_so,
             kernels.dequant_matmul_so_plain, 14)):
        detail: dict = {}
        errs, steps = cs.check_matmul(dev, detail, tag, fmt, fn, plain, timed_m=F32DEC_ROWS,
                                      other_m=(), ops_per_s=lambda m: cs.F32_TC_OPS_PER_S,
                                      seed=seed, timed_dtype="float32", scale_dtype=sdt)
        out[tag] = detail[tag]
        out[f"{tag}_pass"] = {str(m): v for m, v in steps.items()}
        out[f"{tag}_max_err"] = {f"{m} {xdt}": e for (m, xdt), e in errs.items()}
        torch.cuda.empty_cache()
    cfg, params = cs.make_7b_params(dev, "int8", dtype="float32")
    engine = Engine(cfg, params, cs._byte_vocab(cfg.vocab_size), slots=4, decode_chunk_size=32,
                    prefill_chunk=256, device=dev)
    step = cs.profile_decode(engine, 32)
    out["decode_step"] = {k: step[k] for k in ("step_ms", "device_busy_ms", "matmul_ms",
                                               "matmul_kernels", "device_kernels_per_step",
                                               "host_op_calls_per_step",
                                               "top_kernels_ms_per_step")}
    return out


K9TILE_ROWS = (9, 16, 64, 256)


def run_k9tile(cs, root: str) -> dict:
    import torch

    from llamago_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    out = {"root": root, "card": cs.card_line()}
    for tag, fmt, xdt, seed in (("q8_bf16", "q8", "bfloat16", 21), ("q8_f32", "q8", "float32", 22),
                                ("q4_bf16", "q4", "bfloat16", 23), ("q4_f32", "q4", "float32", 24)):
        rate = cs.BF16_OPS_PER_S if xdt == "bfloat16" else cs.F32_TC_OPS_PER_S
        detail: dict = {}
        errs, steps = cs.check_matmul(dev, detail, f"k9 {tag}", fmt, kernels.dequant_matmul_so,
                                      kernels.dequant_matmul_so_plain, timed_m=K9TILE_ROWS,
                                      other_m=(), ops_per_s=lambda m, r=rate: r, seed=seed,
                                      timed_dtype=xdt)
        out[tag] = detail[f"k9_{tag}"]
        out[f"{tag}_pass"] = {str(m): v for m, v in steps.items()}
        out[f"{tag}_max_err"] = {f"{m} {x}": e for (m, x), e in errs.items()}
        torch.cuda.empty_cache()
    return out


PROBE_NAMES = ("base", "decode_only", "decode_bitcast", "dma_only")
# the probe modes of lab_decode_tc (csrc/lab_matmul.cu kFDecodeOnly ...)
PROBE_MODES = {5: "decode_only", 6: "decode_bitcast", 7: "dma_only"}


def probe_loop_sass() -> dict:
    """Static SASS instructions of the main loop of each probe mode of
    lab_decode_tc (its longest backward branch: one quant block a lane, 64
    packed bytes), from `cuobjdump -sass` of the library this checkout
    built; {} where the checkout has no such modes."""
    import re
    import shutil

    from llamago_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", _build.lib_path("lab_matmul")], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        mode = re.search(r"lab_decode_tcILi(\d)E", chunk.splitlines()[0])
        if mode is None or int(mode.group(1)) not in PROBE_MODES:
            continue
        labels, code, pending = {}, [], []
        for line in chunk.splitlines()[1:]:
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                pending.append(label.group(1))
                continue
            ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
            if ins:
                addr = int(ins.group(1), 16)
                labels.update((p, addr) for p in pending)
                pending = []
                code.append((addr, ins.group(2)))
        longest = 0
        for addr, ins in code:
            bra = re.search(r"\bBRA\b.*?(?:(\.L_x_\d+)|0x([0-9a-f]+))", ins)
            if bra:
                target = labels.get(bra.group(1)) if bra.group(1) else int(bra.group(2), 16)
                if target is not None and target < addr:
                    longest = max(longest, (addr - target) // 16 + 1)
        out[PROBE_MODES[int(mode.group(1))]] = {"loop_instructions": longest,
                                                "per_packed_byte": longest / 64}
    return out


def run_probe(cs, root: str) -> dict:
    import torch

    from llamago_tpu_torch import kernel_lab
    from llamago_tpu_torch.ops import lab_kernels as lk
    from llamago_tpu_torch.utils.timing import device_us_by_name, profiled

    dev = torch.device("cuda")
    k, n, m = (cs.LAB_SHAPE[key] for key in ("k", "n", "m"))
    tk = lk.default_tk(k)
    leaf = kernel_lab.make_layers("q4", k, n, 1, dev, seed=18)[0]
    x = torch.zeros((max(8, m), k), dtype=torch.bfloat16, device=dev)
    scale = k * 8 * leaf["s"].float().abs().max().item()
    errs = {}
    for kind in PROBE_NAMES[1:]:
        got, ref = lk.probe(kind, x, leaf, tk), lk.probe_plain(kind, leaf, x.shape[0], tk)
        errs[kind] = err = (got - ref).abs().max().item() / scale
        if not err <= cs.LAB_PROBE_TOL[kind]:
            raise AssertionError(f"{root}: probe {kind}: max|d| / {scale:.3g} = {err:.3g}")
        cs.log(f"{root}: probe {kind} vs plain max|d|/scale {err:.2e}")
    # device us a call by kernel name: the probe's own launch and its reduce
    layers = kernel_lab.make_layers("q4", k, n, cs.LAB_SHAPE["layers"], dev)
    by_kernel = {}
    for kind in PROBE_NAMES[1:]:
        for w in layers:
            lk.probe(kind, x, w, tk)
        calls = 4 * len(layers)
        by = device_us_by_name(profiled(lambda kind=kind: [lk.probe(kind, x, w, tk)
                                                          for _ in range(4) for w in layers]))
        by_kernel[kind] = {name[:60]: us / calls for name, us in by.items()}
        cs.log(f"{root}: probe {kind} by kernel (us a call): {by_kernel[kind]}")
    del leaf, layers
    torch.cuda.empty_cache()
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip()
    sass = probe_loop_sass()
    cs.log(f"{root}: probe loops (SASS) {sass}; SM clock max, now: {clocks}")
    return {**run_lab(cs, root, PROBE_NAMES), "max_err": errs, "loop_sass": sass,
            "sm_clocks": clocks, "by_kernel_us": by_kernel}


def run_lab(cs, root: str, names=LAB_NAMES) -> dict:
    import torch

    from llamago_tpu_torch import kernel_lab
    from llamago_tpu_torch.ops import lab_kernels as lk

    dev = torch.device("cuda")
    k, n, m, layers = (cs.LAB_SHAPE[key] for key in ("k", "n", "m", "layers"))
    fmts = {kernel_lab.VARIANTS[name].fmt for name in names} | {"q4", "w16"}
    cache = {fmt: kernel_lab.make_layers(fmt, k, n, layers, dev) for fmt in fmts - {"i4"}}
    cache["i4"] = [lk.to_i4(leaf) for leaf in cache["q4"]]
    rows = []
    for name in names:
        r = kernel_lab.run_variant(name, k, n, m, layers, cs.LAB_STEPS, None, cs.LAB_REPS, dev,
                                   cache[kernel_lab.VARIANTS[name].fmt])
        rows.append({key: r[key] for key in ("name", "row", "kernel_ms", "bound_ms",
                                             "bound_by", "bound_share")})
        cs.log(f"{root}: lab {name:16s}: {r['kernel_ms'] * 1e3:.2f} us a launch, bound "
               f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_share']:.1%})")
    x = torch.randn((max(8, m), k), device=dev).to(torch.bfloat16)
    lib = cs.timed([lambda w=w: x @ w["w16"] for w in cache["w16"]], 4 * layers)
    cs.log(f"{root}: lab x @ W: {lib * 1e3:.2f} us")
    return {"root": root, "card": cs.card_line(), "lab": rows, "library_ms": lib}


def run_k3(cs, root: str, warps: list[int]) -> dict:
    import torch

    from llamago_tpu_torch.ops import cache_write
    from llamago_tpu_torch.runtime.decode_loop import decode_chunk
    from llamago_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    c = cs.K3_SHAPE
    b, kv, hd, s = c["b"], c["kv"], c["hd"], c["s"]
    gen = torch.Generator(device=dev).manual_seed(5)
    cache = [torch.randint(-127, 128, (b, kv, s, hd), generator=gen, dtype=torch.int8,
                           device=dev) for _ in range(2)]
    cache += [torch.rand((b, kv, s), generator=gen, device=dev) for _ in range(2)]
    inputs = {"serving": (cs.k3_serving_rows(dev, gen, c, torch.bfloat16),
                          torch.arange(100, 100 + b, dtype=torch.int64, device=dev)),
              "contiguous": ([torch.randn((b, 1, kv, hd), generator=gen, device=dev)
                              .bfloat16() for _ in range(2)],
                             torch.arange(100, 100 + b, dtype=torch.int32, device=dev))}
    default = getattr(cache_write, "APPEND_WARPS", None)
    plans = [("plan", None)] + ([(f"warps {n}", n) for n in warps] if default else [])
    out = {"root": root, "card": cs.card_line(), "launch_floor_ms": cs.launch_floor_ms()}
    cs.log(f"{root}: launch floor {out['launch_floor_ms'] * 1e3:.2f} us")
    try:
        for label, n in plans:
            if n is not None:
                cache_write.APPEND_WARPS = n
            rows = {}
            for name, (new, pos) in inputs.items():
                got, want = [a.clone() for a in cache], [a.clone() for a in cache]
                cache_write.cache_append_quant(*got, *new, pos)
                cache_write.cache_append_quant_plain(*want, *new, pos)
                exact = all(torch.equal(g, w) for g, w in zip(got, want))
                per_call, names = cs.device_ops_per_call(
                    lambda: cache_write.cache_append_quant(*cache, *new, pos))
                ms = cs.timed([lambda: cache_write.cache_append_quant(*cache, *new, pos)], 400)
                rows[name] = dict(ms=ms, device_ops_per_call=per_call, device_ops=names,
                                  bit_exact=exact)
                cs.log(f"{root} ({label}): K3 {name}: {ms * 1e3:.3f} us, {per_call} device "
                       f"operations a call, bit-exact {exact}")
            out["k3" if n is None else f"k3_warps_{n}"] = rows
    finally:
        if default is not None:
            cache_write.APPEND_WARPS = default
    del cache
    torch.cuda.empty_cache()
    cfg, params = cs.make_7b_params(dev)
    engine = Engine(cfg.replace(kv_dtype="int8"), params, cs._byte_vocab(cfg.vocab_size),
                    slots=8, decode_chunk_size=32, prefill_chunk=256, device=dev)
    step = cs.profile_decode(engine, 32)
    out["decode_step"] = {k: step[k] for k in (*STEP_KEYS, "device_kernels_per_step",
                                               "host_op_calls_per_step", "append_ms")}
    # greedy tokens of all slots after the profile, from distinct tokens
    toks = decode_chunk(engine.params, torch.arange(3, 3 + b, device=dev), engine.cache,
                        torch.full((b,), 200, device=dev), engine.config, 16)[0]
    out["greedy_tokens"] = toks.tolist()
    return out


def run_k10(cs, root: str, threads: list[int]) -> dict:
    import torch
    import torch.nn.functional as F

    from llamago_tpu_torch.ops import kernels
    from llamago_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    d, eps = cs.K10_D, 1e-5
    default = getattr(kernels, "norm_plan", None)
    plans = [("plan", None)]
    if default is not None:
        plans += [(f"threads {t}", t) for t in threads]
    out = {"root": root, "card": cs.card_line(), "launch_floor_ms": cs.launch_floor_ms()}
    cs.log(f"{root}: launch floor {out['launch_floor_ms'] * 1e3:.2f} us")
    try:
        for label, t in plans:
            if t is not None:
                def forced(rows, d_, x_dtype, w_dtype, align=16, t=t):
                    return t, default(rows, d_, x_dtype, w_dtype, align)[1]

                kernels.norm_plan = forced
            rows = []
            for n_rows in (4, 64, 256):
                gen = torch.Generator(device=dev).manual_seed(n_rows)
                xs = [torch.randn((1, n_rows, d), generator=gen, device=dev).bfloat16()
                      for _ in range(4)]
                w = (torch.rand((d,), generator=gen, device=dev) + 0.5).bfloat16()
                got = kernels.fused_rms_norm(xs[0], w, eps).float()
                ref = kernels.fused_rms_norm_plain(xs[0], w, eps).float()
                err = ((got - ref).abs() / ref.abs().max()).max().item()
                ms = cs.timed([lambda x=x: kernels.fused_rms_norm(x, w, eps) for x in xs], 400)
                lib = cs.timed([lambda x=x: F.rms_norm(x, (d,), w, eps) for x in xs], 400)
                rows.append(dict(rows=n_rows, ms=ms, library_ms=lib, max_err=err))
                cs.log(f"{root} ({label}): K10 rows={n_rows:3d}: {ms * 1e3:.3f} us, "
                       f"F.rms_norm {lib * 1e3:.3f} us, max|d|/max|ref| {err:.2e}")
            out["k10" if t is None else f"k10_{t}"] = rows
    finally:
        if default is not None:
            kernels.norm_plan = default
    cfg, params = cs.make_7b_params(dev)
    with cs.opt_in_routes():
        engine = Engine(cfg, params, cs._byte_vocab(cfg.vocab_size), slots=4,
                        decode_chunk_size=32, prefill_chunk=256, device=dev)
        step = cs.profile_decode(engine, 32)
    out["decode_step"] = {k: step[k] for k in (*STEP_KEYS, "device_kernels_per_step",
                                               "host_op_calls_per_step", "norm_ms")}
    return out


def run_one(root: str, kernel: str, sweeps: dict) -> dict:
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    cs = _smoke()
    splits, chunks = sweeps["k8_splits"], sweeps["k7_chunks"]
    if kernel == "k3":
        return run_k3(cs, root, sweeps["k3_warps"])
    if kernel == "k10":
        return run_k10(cs, root, sweeps["k10_threads"])
    if kernel == "k4":
        return run_k4(cs, root)
    if kernel == "k8":
        return run_k8(cs, root, splits)
    if kernel == "k7":
        return run_k7(cs, root, chunks)
    if kernel == "k7cells":
        return run_k7cells(cs, root)
    if kernel == "attn32":
        return run_attn32(cs, root)
    if kernel == "lab":
        return run_lab(cs, root)
    if kernel == "labint":
        return run_lab(cs, root, LAB_INT_NAMES)
    if kernel == "k5":
        return run_k5(cs, root)
    if kernel == "f32mm":
        return run_f32mm(cs, root)
    if kernel == "f32dec":
        return run_f32dec(cs, root)
    if kernel == "k9tile":
        return run_k9tile(cs, root)
    if kernel == "probe":
        return run_probe(cs, root)
    import torch

    from llamago_tpu_torch.ops import attention
    from llamago_tpu_torch.runtime.engine import Engine

    dev = torch.device("cuda")
    c = cs.K2_SHAPE
    rows = []
    for t, fill in WINDOWS:
        gen = torch.Generator(device=dev).manual_seed(1000 * t + fill)
        q, kc, vc, positions = cs._k2_inputs(dev, gen, t, fill)
        q5 = q.reshape(c["b"], t, c["kv"], c["g"], c["hd"])
        got = attention.flash_attention(q, kc, vc, positions).float()
        ref = attention.flash_attention_plain(q5, kc, vc, positions[:, 0].to(torch.int32))
        err = (got - ref.reshape(got.shape).float()).abs().max().item()
        caches = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(cs.K2_COPIES - 1)]
        ms = cs.timed([lambda kv=kv: attention.flash_attention(q, *kv, positions)
                       for kv in caches], 50 * cs.K2_COPIES)
        del caches
        rows.append(dict(t=t, fill=fill, ms=ms, max_abs_err=err))
        cs.log(f"{root}: K2 t={t:2d} fill={fill:4d}: {ms:.4f} ms, max|d| {err:.2e}")
    cfg, params = cs.make_7b_params(dev)
    engine = Engine(cfg, params, cs._byte_vocab(cfg.vocab_size), slots=4,
                    decode_chunk_size=32, prefill_chunk=256, device=dev)
    step = cs.profile_decode(engine, 32)
    return {"root": root, "card": cs.card_line(), "k2": rows,
            "decode_step": {k: step[k] for k in STEP_KEYS}}


SWEEPS = {"k8_splits": "slots a split to time K8 at, beside its plan",
          "k7_chunks": "slots a chunk to time K7 at, beside its plan",
          "k3_warps": "warps a block to time K3 at, beside its plan",
          "k10_threads": "threads a row to time K10 at, beside its plan"}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("k2", "k3", "k4", "k8", "k7", "k7cells", "attn32", "k5",
                                         "f32mm", "f32dec", "k9tile", "k10", "lab", "labint",
                                         "probe"),
                    default="k2")
    for name, what in SWEEPS.items():
        ap.add_argument("--" + name.replace("_", "-"), default="",
                        help=f"comma-separated {what}")
    ap.add_argument("--out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="*")
    args = ap.parse_args(argv)
    if args.worker:
        sweeps = {name: [int(n) for n in getattr(args, name).split(",") if n]
                  for name in SWEEPS}
        print(json.dumps(run_one(args.worker, args.kernel, sweeps)), flush=True)
        return 0
    if not args.roots:
        ap.error("name at least one checkout")
    results = []
    for root in args.roots:
        passed = [a for name in SWEEPS for a in ("--" + name.replace("_", "-"),
                                                  getattr(args, name))]
        proc = subprocess.run([sys.executable, str(HERE / "k2_pair.py"), "--kernel",
                               args.kernel, *passed, "--worker", root],
                              stdout=subprocess.PIPE, text=True)
        if proc.returncode != 0:
            print(f"k2_pair: the run of {root} failed ({proc.returncode})", file=sys.stderr)
            return 1
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
