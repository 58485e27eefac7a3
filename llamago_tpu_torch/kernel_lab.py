"""Kernel lab: A/B variants of the small-m int4/int8 dequant-matmul on one
GPU.

    python -m llamago_tpu_torch.kernel_lab [--device cpu] [variant ...]

Counterpart of the JAX package's `scripts/kernel_lab.py`, with the same 32
variant names. Which FUNCTION should a quantized matmul of a few rows
compute: dequantize and dot in f32 (row L2 of the table below), in bf16
(L3), the integer weights in bf16 dotted per 32-block with the scales
folded on the f32 sums (L1, L5: K1's tensor-core forms), integer dots
with the scales folded into the output per 32-block (L4, L6, L7), per
k-tile or 128-group (L8, L10), and what do the floor probes read (L11,
L12)? For each name the lab first checks the variant
against `x @ dequantize(w)` at K = N = 512 (`correctness`: the JAX lab's
skip list and tolerances), then times it at the dominant 70B-shard shape
(K = 8192, N = 7168, m = 8) over 24 layers of distinct weights chained
through a cast, a slice and a tanh, so that the weight stream of one sweep
(0.79 GB of Q4_0) passes the card's 50 MB L2 (`run_variant`). A variant
that fails its check is reported and dropped, the others still run;
`decode_bitcast` is on no skip list, compares column sums with a product,
and is dropped, as in the JAX lab.

On the card the numbers come from the device side of a torch.profiler
trace, split by kernel name: the variant's own kernels give ms per launch,
GB/s of the bytes the function has to move (those of the bound, so that
GB/s over 3.35 TB/s is the share of a byte bound), G elements/s and the share
of the bound (the larger of bytes over 3.35 TB/s and operations over the
card's peak rate of their type); the hoisted operand preparation and the chain are printed beside it
as other device time, the host clock as seconds per sweep. With
`--device cpu` the plain versions run, the host clock is all there is, and
no device rate is printed.

The variants of one row compute the same function and share one kernel
(they differed in the TPU's unpack chain only); each name's plain version
follows its own arithmetic where that differs. Rows L1, L4 and L5 run
through K1 and K9 of `ops/kernels.py`, which return bf16: one more rounding
than the lab's f32 [tm, N], inside the check's 2e-2. `xla_i4` has no kernel
in the JAX lab either: plain PyTorch here too.

Shape overrides, as in the JAX lab: LAB_K, LAB_N, LAB_M, LAB_LAYERS,
LAB_STEPS, LAB_REPS, LAB_TK. tk is part of the function for L8, L10 and
`dma_pure`. LAB_TN and LAB_DIMSEM are not carried over: the n-tile and the
grid's dimension semantics are TPU tile matters no variant's result depends
on, and the CUDA kernels choose their own blocks.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable

import torch

from llamago_tpu_torch.ops import kernels, quant
from llamago_tpu_torch.ops import lab_kernels as lk
from llamago_tpu_torch.ops.quant import QK
from llamago_tpu_torch.utils import timing
from llamago_tpu_torch.utils.device import resolve_device

# names `correctness` does not hold to the Q4_0 / Q8_0 reference: probes
# without a product, the bitcast nibble order (a fixed k-permutation of
# Q4_0's), and the full-tile forms that fold a stand-in scale
SKIP_CHECK = ("decode_only", "dma_only", "dma_pure", "w16dot",
              "bitcast_i4", "bitcast_i4_bf16", "bitcast_i4_i8dot", "bitcast_i4_i4dot",
              "bitcast_i4_i8dot_g128", "bitcast_i4_i8dot_g128_lazy",
              "w8a8_fulltk", "w4a8_split_fulltk")

_RATES = {"f32": timing.F32_OPS_PER_S, "bf16": timing.BF16_OPS_PER_S,
          "int8": timing.INT8_OPS_PER_S}


@dataclass(frozen=True)
class Variant:
    """One name of the lab. `fn(ops, leaf, tk)` and `plain(ops, leaf, tk)`
    take the operands `HOISTS[hoist](x, tk)` made of x bf16 [tm, K] and give
    f32 [tm, N]; `fn` launches the kernel on CUDA tensors."""
    row: str                # the function, L1 .. L12
    fmt: str                # weights: q4, q8, i4, w16
    hoist: str | None       # operand preparation outside the kernel
    fn: Callable
    plain: Callable
    rate: str | None        # type of the products where they run fastest exactly (f32,
                            # bf16: int4 values and bf16 x are exact bf16, int8); None:
                            # no product
    counter: tuple | None   # (wrapper, attribute) of the launch count; None: no kernel
    kernels: tuple = ("lab_",)  # device kernels of the function, by name


HOISTS: dict[str | None, Callable] = {
    None: lambda x, tk: (x,),
    "split": lambda x, tk: lk.hoist_split(x),
    "a8": lambda x, tk: lk.hoist_a8(x),
    "a8full": lk.hoist_a8full,
    "a8g128": lambda x, tk: lk.hoist_a8g128(x),
    "splitfull": lambda x, tk: lk.hoist_splitfull(x),
}


def _whole_x(ops):
    return ops[0] if len(ops) == 1 else lk.join_split(*ops)


def _l1(hoist=None, fmt="q4"):
    """L1 / L5: K1 on the Q4_0 / Q8_0 leaf. K1 gathers x itself, so the
    halves of a hoisted variant are joined back. x is bf16, so on the card
    K1 runs a bf16 tensor-core form (`kernels.k1_form`: the decode form up
    to 8 rows, the tile above): its products are bf16."""
    attr = "launches_q4" if fmt == "q4" else "launches"
    return Variant(
        "L1" if fmt == "q4" else "L5", fmt, hoist,
        lambda ops, w, tk: kernels.dequant_matmul(_whole_x(ops), w).to(torch.float32),
        lambda ops, w, tk: kernels.dequant_matmul_plain(_whole_x(ops), w).to(torch.float32),
        "bf16", (kernels.dequant_matmul, attr), ("dq_",))


def _probe(kind):
    """L11's probes: decode_only sums on the bf16 tensor cores (the decode
    form's own A fragments against ones), decode_bitcast's chain runs in f32
    on the CUDA cores, the byte probes take no products."""
    rate = {"decode_only": "bf16", "decode_bitcast": "f32"}.get(kind)
    return Variant("L11", "q4", None,
                   lambda ops, w, tk: lk.probe(kind, ops[0], w, tk),
                   lambda ops, w, tk: lk.probe_plain(kind, w, ops[0].shape[0], tk),
                   rate, (lk.probe, "launches"))


def _l10(hoist, g128):
    return Variant("L10", "q4", hoist,
                   lambda ops, w, tk: lk.bitcast_i4_i8dot(ops, w, tk, g128),
                   lambda ops, w, tk: lk.bitcast_i4_i8dot_plain(*ops, w, tk, g128),
                   "int8", (lk.bitcast_i4_i8dot, "launches"))


def _a8(row, fmt, hoisted):
    fn = lk.w4a8_matmul if fmt == "q4" else lk.w8a8_matmul

    def plain(ops, w, tk):
        xq, sx = ops if hoisted else lk.hoist_a8(ops[0])
        return lk.a8_block_matmul_plain(xq, sx, w)

    return Variant(row, fmt, "a8" if hoisted else None,
                   lambda ops, w, tk: fn(ops if hoisted else ops[0], w, hoisted),
                   plain, "int8", (fn, "launches"))


VARIANTS: dict[str, Variant] = {
    "base": _l1(),
    "fma": _l1(),
    "bitcast": _l1(),
    "split": _l1(),
    "split_bitcast": _l1(),
    "split_h": _l1("split"),
    "split_u8_h": _l1("split"),
    "split_bf16_h": Variant(
        "L3", "q4", "split",
        lambda ops, w, tk: lk.bf16_dequant_matmul(ops, w, fma_in_bf16=True),
        lambda ops, w, tk: lk.bf16_dequant_matmul_plain(lk.join_split(*ops), w, True),
        "bf16", (lk.bf16_dequant_matmul, "launches")),
    "split_bitcast_h": _l1("split"),
    "w8a8_h": _a8("L7", "q8", True),
    "w4a8_h": _a8("L6", "q4", True),
    "int8dot": Variant(
        "L4", "q4", None,
        lambda ops, w, tk: kernels.dequant_matmul_so(ops[0], w).to(torch.float32),
        lambda ops, w, tk: kernels.dequant_matmul_so_plain(ops[0], w).to(torch.float32),
        "bf16", (kernels.dequant_matmul_so, "launches"), ("so_",)),
    "w4a8": _a8("L6", "q4", False),
    "w4a8_raw": _a8("L6", "q4", False),
    "i4native": Variant(
        "L2", "i4", None,
        lambda ops, w, tk: lk.i4_matmul(ops[0], w),
        lambda ops, w, tk: lk.i4_matmul_plain(ops[0], w["i4"], w["s"]),
        "bf16", (lk.i4_matmul, "launches")),
    # no kernel in the JAX lab either: plain PyTorch on either device
    "xla_i4": Variant(
        "L2", "i4", None,
        lambda ops, w, tk: lk.i4_matmul_plain(ops[0], w["i4"], w["s"]),
        lambda ops, w, tk: lk.i4_matmul_plain(ops[0], w["i4"], w["s"]),
        "f32", None, ()),
    "base8": _l1(fmt="q8"),
    "w8a8": _a8("L7", "q8", False),
    "w8a8_fulltk": Variant(
        "L8", "q8", "a8full",
        lambda ops, w, tk: lk.fulltk_matmul(ops, w, tk),
        lambda ops, w, tk: lk.w8a8_fulltk_plain(*ops, w, tk),
        "int8", (lk.fulltk_matmul, "launches")),
    "w4a8_split_fulltk": Variant(
        "L8", "q4", "splitfull",
        lambda ops, w, tk: lk.fulltk_matmul(ops, w, tk),
        lambda ops, w, tk: lk.w4a8_split_fulltk_plain(*ops, w, tk),
        "int8", (lk.fulltk_matmul, "launches")),
    "bf16dot": Variant(
        "L3", "q4", None,
        lambda ops, w, tk: lk.bf16_dequant_matmul(ops[0], w),
        lambda ops, w, tk: lk.bf16_dequant_matmul_plain(ops[0], w),
        "bf16", (lk.bf16_dequant_matmul, "launches")),
    "w16dot": Variant(
        "L12", "w16", None,
        lambda ops, w, tk: lk.w16_matmul(ops[0], w),
        lambda ops, w, tk: lk.w16_matmul_plain(ops[0], w["w16"]),
        "bf16", (lk.w16_matmul, "launches")),
    "decode_only": _probe("decode_only"),
    "decode_bitcast": _probe("decode_bitcast"),
    "dma_only": _probe("dma_only"),
    "dma_pure": _probe("dma_pure"),
    "bitcast_i4": Variant(
        "L9", "q4", None,
        lambda ops, w, tk: lk.bitcast_i4_matmul(ops[0], w),
        lambda ops, w, tk: lk.i4_matmul_plain(ops[0], w["q4"], w["s"]),
        "bf16", (lk.bitcast_i4_matmul, "launches")),
    "bitcast_i4_bf16": Variant(
        "L9", "q4", None,
        lambda ops, w, tk: lk.bitcast_i4_matmul(ops[0], w, bf16=True),
        lambda ops, w, tk: lk.i4_matmul_plain(ops[0], w["q4"], w["s"], True),
        "bf16", (lk.bitcast_i4_matmul, "launches")),
    "bitcast_i4_i8dot": _l10("a8full", False),
    "bitcast_i4_i4dot": _l10("a8full", False),
    "bitcast_i4_i8dot_g128": _l10("a8g128", True),
    "bitcast_i4_i8dot_g128_lazy": _l10("a8g128", True),
}


# -------------------------------------------------------------------- weights

def make_leaf(w: torch.Tensor, fmt: str) -> dict:
    """A weight [K, N] in the lab's format `fmt`."""
    if fmt == "w16":
        k, n = w.shape
        return {"w16": w.to(torch.bfloat16).contiguous(),
                "s": torch.ones((k // QK, n), dtype=torch.bfloat16, device=w.device)}
    leaf = quant.quantize(w, 8 if fmt == "q8" else 4)
    return lk.to_i4(leaf) if fmt == "i4" else leaf


def make_layers(fmt: str, k: int, n: int, layers: int, device, seed: int = 0) -> list[dict]:
    """`layers` distinct leaves of normal weights (std 0.02, rounded to
    bf16 first, as the JAX lab draws them) from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(layers):
        w = (torch.randn((k, n), generator=gen, device=device) * 0.02).to(torch.bfloat16)
        out.append(make_leaf(w, fmt))
    return out


def variant_work(name: str, k: int, n: int, tm: int, tk: int) -> tuple[int, float]:
    """(bytes, operations) of one call of the variant. Bytes: what the
    function has to read of the weights (the packed integers; the scale rows
    it uses) and of its x operands, and the f32 output, each once.
    Operations: 2 tm K N products and sums; a decode probe 2 K N; a byte
    probe none."""
    v = VARIANTS[name]
    q_bytes = {"q4": k * n // 2, "i4": k * n // 2, "q8": k * n, "w16": 2 * k * n}[v.fmt]
    if v.row in ("L8", "L10"):
        group = lk.G128 if v.hoist == "a8g128" else tk
        s_rows = k // group
    elif v.fmt == "w16" or name.startswith("dma_"):
        s_rows = 0
    else:
        s_rows = k // QK
    x_bytes = tm * k * (2 if v.hoist in (None, "split") else 1)
    if v.hoist in ("a8", "a8full", "a8g128"):
        x_bytes += 4 * tm * k // {"a8": QK, "a8full": tk, "a8g128": lk.G128}[v.hoist]
    if v.row == "L11":
        x_bytes = 0
    nbytes = q_bytes + 2 * s_rows * n + x_bytes + 4 * tm * n
    if v.rate is None:
        return nbytes, 0.0
    return nbytes, 2.0 * k * n * (1 if v.row == "L11" else tm)


def variant_bound(name: str, k: int, n: int, tm: int, tk: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time one call of the variant
    could take on the card, its bytes at 3.35 TB/s against its operations at
    the peak rate of their type."""
    nbytes, ops = variant_work(name, k, n, tm, tk)
    rate = VARIANTS[name].rate
    return timing.bound_ms(nbytes, ops, _RATES[rate]) if rate else timing.bound_ms(nbytes, 0.0)


# ---------------------------------------------------------------- correctness

def correctness(name: str, device="cuda", k: int = 512, n: int = 512, m: int = 8,
                tk: int = 256) -> float | None:
    """Check the variant against x @ dequantize(w): relative error (of
    max|ref|) below 2e-2, or 5e-2 for names containing `a8`, whose
    activations are rounded to int8 too. Returns the error, or None for a
    name on `SKIP_CHECK`; raises AssertionError on a failure."""
    if name in SKIP_CHECK:
        return None
    v = VARIANTS[name]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.randn((k, n), generator=gen, device=dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    leaf = quant.quantize(w, 8 if v.fmt == "q8" else 4)
    ref = x.to(torch.float32) @ quant.dequantize(leaf, torch.float32)
    if v.fmt == "i4":
        leaf = lk.to_i4(leaf)
    out = v.fn(HOISTS[v.hoist](x, tk), leaf, tk)
    tol = 5e-2 if "a8" in name else 2e-2
    err = ((out - ref).abs().max() / (ref.abs().max() + 1e-9)).item()
    status = "OK" if err < tol else "FAIL"
    print(f"{name:>14s}  correctness rel-err {err:.2e} {status}", flush=True)
    if not err < tol:
        raise AssertionError(f"{name}: rel-err {err:.3g} >= {tol}")
    return err


# ----------------------------------------------------------------- the sweep

def _chain(o: torch.Tensor, k: int) -> torch.Tensor:
    """[tm, N] f32 -> the next layer's x bf16 [tm, K] without a
    back-projection: cast, slice or tile, tanh, halve."""
    o = o.to(torch.bfloat16)
    n = o.shape[1]
    nxt = o[:, :k] if k <= n else torch.cat([o] * -(-k // n), dim=1)[:, :k]
    return torch.tanh(nxt) * 0.5


def run_variant(name: str, k: int = 8192, n: int = 7168, m: int = 8, layers: int = 24,
                steps: int = 8, tk: int | None = None, reps: int = 8, device="cuda",
                weights: list[dict] | None = None) -> dict:
    """Time the variant: `reps` sweeps of `steps` passes over `layers`
    distinct leaves (made here from seed 0 unless `weights` brings them),
    x chained from layer to layer. Prints one line and returns the numbers:
    on the card the device time per launch of the variant's kernels
    (`kernel_ms`) and of everything else (`other_device_ms`), the rates and
    the bound; on the CPU the host clock only."""
    v = VARIANTS[name]
    dev = resolve_device(device)
    tk = tk or lk.default_tk(k)
    if k % tk or k % QK:
        raise ValueError(f"run_variant: K={k} does not divide into k-tiles of {tk}")
    tm = max(8, m)
    ws = weights if weights is not None else make_layers(v.fmt, k, n, layers, dev)
    hoist = HOISTS[v.hoist]

    def sweep(x):
        for _ in range(steps):
            for leaf in ws:
                x = _chain(v.fn(hoist(x, tk), leaf, tk), k)
        return x

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    x = sweep(torch.ones((tm, k), dtype=torch.bfloat16, device=dev))
    sync()
    state = {"x": x, "before": 0}

    def timed_sweeps():  # run again from its start if a trace has to be retaken
        state["before"] = getattr(*v.counter) if v.counter else 0
        for _ in range(reps):
            state["x"] = sweep(state["x"])

    t0 = time.perf_counter()
    events = timing.profiled(timed_sweeps) if dev.type == "cuda" else timed_sweeps()
    sync()
    dt = (time.perf_counter() - t0) / reps
    calls = reps * steps * len(ws)
    bnd, by = variant_bound(name, k, n, tm, tk)
    out = {"name": name, "row": v.row, "fmt": v.fmt, "k": k, "n": n, "m": m, "tk": tk,
           "layers": len(ws), "steps": steps, "reps": reps, "device": dev.type,
           "seconds_per_sweep": dt, "bound_ms": bnd, "bound_by": by,
           "launches": (getattr(*v.counter) - state["before"]) if v.counter else 0}
    head = f"{name:>14s}  k={k} n={n} tk={tk} m={m}: "
    if not torch.isfinite(state["x"].to(torch.float32)).all():
        raise AssertionError(f"{name}: the chained x is not finite after the sweep")
    if dev.type != "cuda":
        print(f"{head}cpu, plain versions: {dt:.3f}s/sweep on the host clock, no device "
              f"rate (bound on an H100 {bnd:.4f} ms by {by})", flush=True)
        return out
    by_name = timing.device_us_by_name(events)
    total_us = sum(by_name.values())
    if v.counter is None:  # no kernel: all of it is the plain function
        kern_us = total_us
    else:
        kern_us = sum(us for nm, us in by_name.items() if any(p in nm for p in v.kernels))
        if out["launches"] != calls or kern_us <= 0:
            raise AssertionError(f"{name}: {out['launches']} launches counted for {calls} "
                                 f"calls, {kern_us} us of kernel time in the trace")
    kernel_ms = kern_us / 1e3 / calls
    out.update(kernel_ms=kernel_ms, other_device_ms=(total_us - kern_us) / 1e3 / calls,
               gbps=variant_work(name, k, n, tm, tk)[0] / (kernel_ms * 1e-3) / 1e9,
               gelems=k * n / (kernel_ms * 1e-3) / 1e9, bound_share=bnd / kernel_ms)
    print(f"{head}{out['gbps']:7.1f} GB/s  {out['gelems']:7.1f} G elem/s  "
          f"({dt:.3f}s/sweep)  kernel {kernel_ms:.4f} ms/launch, bound {bnd:.4f} ms "
          f"({by}) = {out['bound_share']:.1%}, other device "
          f"{out['other_device_ms']:.4f} ms/launch", flush=True)
    return out


def run(names, device="cuda", k: int = 8192, n: int = 7168, m: int = 8, layers: int = 24,
        steps: int = 8, reps: int = 8, tk: int | None = None,
        time_dropped: bool = False) -> dict:
    """The lab's sweep over `names`: check each, then time those that passed
    or are not checked (with `time_dropped`, those that failed the check
    too). One set of layers per weight format serves every variant of that
    format. Returns {"checked": {name: rel-err}, "skipped": [...],
    "dropped": {name: reason}, "timed": [run_variant's dicts], "layers":
    {format: the leaves}}. A kernel that fails to build or launch raises."""
    dev = resolve_device(device)
    checked, skipped, dropped = {}, [], {}
    for nm in names:
        try:
            err = correctness(nm, dev)
        except AssertionError as e:
            reason = (str(e).splitlines() or [repr(e)])[0][:100]
            print(f"{nm:>14s}  SKIP (correctness failed: {reason})", flush=True)
            dropped[nm] = reason
            continue
        if err is None:
            skipped.append(nm)
        else:
            checked[nm] = err
    timed, cache = [], {}
    for nm in names:
        if nm in dropped and not time_dropped:
            continue
        fmt = VARIANTS[nm].fmt
        base = "q4" if fmt == "i4" else fmt
        if base not in cache:
            cache[base] = make_layers(base, k, n, layers, dev)
        if fmt == "i4" and "i4" not in cache:
            cache["i4"] = [lk.to_i4(leaf) for leaf in cache["q4"]]
        timed.append(run_variant(nm, k, n, m, layers, steps, tk, reps, dev, cache[fmt]))
    return {"checked": checked, "skipped": skipped, "dropped": dropped, "timed": timed,
            "layers": cache}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m llamago_tpu_torch.kernel_lab",
        description="A/B variants of the small-m int4/int8 matmul on one GPU.")
    ap.add_argument("variants", nargs="*", help="variant names (default: all 32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    names = args.variants or list(VARIANTS)
    unknown = [nm for nm in names if nm not in VARIANTS]
    if unknown:
        print(f"kernel_lab: unknown variants {unknown}; known: {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"kernel_lab: device {args.device!r}: {e}", file=sys.stderr)
        return 2
    env = os.environ
    shape = dict(k=int(env.get("LAB_K", 8192)), n=int(env.get("LAB_N", 7168)),
                 m=int(env.get("LAB_M", 8)), layers=int(env.get("LAB_LAYERS", 24)),
                 steps=int(env.get("LAB_STEPS", 8)), reps=int(env.get("LAB_REPS", 8)),
                 tk=int(env["LAB_TK"]) if env.get("LAB_TK") else None)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={dev.type} dev={kind}", flush=True)
    run(names, dev, **shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
