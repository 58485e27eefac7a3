"""K10, the fused RMSNorm, in one trip to memory: its plan, the C entry
point and what the wrapper hands it, and a numpy emulation of its order of
sums, against the plain version and the JAX kernel in interpret mode.

On the card `fused_rms_norm` (ops/kernels.py) launches `rms_norm_onepass`
(csrc/rms_norm.cu) in the launch `norm_plan` gives: a row's threads each
load all their vectors of x and of w (up to four of each) before the
reduction, square and sum their values in f32 (one FMA a value, vector by
vector), reduce through a butterfly of shuffles, meet one barrier, and every
warp of the row then sums the row's warp sums itself; 1 / sqrt(ms + eps)
times x times w in f32, rounded once. Vectors past what the registers hold
are read again. Here, without a card, the wrapper takes the plain version;
the tests pin the plan, the C signature, the launcher on meta tensors and
the emulated order of sums within one bf16 step (f32: 1e-5 relative) of the
plain version and of JAX's `_rms_norm_kernel`.
"""

import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch.ops import _build, kernels

torch.set_num_threads(1)

SRC = (pathlib.Path(__file__).resolve().parent.parent / "llamago_tpu_torch" / "csrc"
       / "rms_norm.cu")
EPS = 1e-5
F32_RTOL = 1e-5  # of the value: the f32 sum of squares in another order, 1/sqrt vs rsqrt
BF16_STEP = 2.0 ** -7  # of the value: bf16 spaces its values by at most this much


@pytest.fixture(autouse=True)
def _interpret_kernels():
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    yield
    jkernels.FORCE_INTERPRET = old


def _f32(v):
    return np.asarray(v, np.float32)


def _fma(a, b, c):
    """fmaf(a, b, c) on f32 arrays: the product exact in f64, then one
    rounding to f32 of the f64 sum (f64 holds a*b exactly; the sum is rounded
    twice, which can differ from a true FMA in the last bit only)."""
    return _f32(a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64))


def _butterfly(v: np.ndarray) -> np.ndarray:
    """__shfl_xor_sync sums over the last axis of 32 lanes, in f32."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = _f32(v + v[..., lanes ^ o])
    return v


def bf16_round(x: np.ndarray) -> np.ndarray:
    u = _f32(x).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def emulate_k10(x: np.ndarray, w: np.ndarray, bf16_out: bool, plan) -> np.ndarray:
    """csrc/rms_norm.cu on the card, emulated: x [rows, d] and w [d] as
    f32 values, the plan (threads a row, values a vector), one block a row.
    Thread t of a row sums its vectors t, t + tpr, ... (the first
    `_NORM_KEEP` from registers, the rest read again) value by value with
    FMA; each warp's butterfly; lanes below the row's warps read the warp
    sums, the rest 0, and a second butterfly; r = 1 / sqrt(sum / d + eps);
    y = x * r * w, rounded once. Every row, each once."""
    rows, d = x.shape
    tpr, vec = plan
    assert tpr % 32 == 0 and tpr <= kernels._NORM_MAX_BLOCK
    nvec = d // vec
    assert nvec * vec == d
    out = np.full_like(x, np.nan)
    for row in range(rows):
        xr = _f32(x[row]).reshape(nvec, vec)
        ss = np.zeros(tpr, np.float32)
        for j0 in range(0, nvec, tpr):  # kept vectors first, then the ones read again
            t = np.arange(tpr)
            live = j0 + t < nvec
            for e in range(vec):
                v = np.where(live, xr[np.minimum(j0 + t, nvec - 1), e], 0)
                ss = np.where(live, _fma(v, v, ss), ss)
        warp_sums = _butterfly(ss.reshape(-1, 32))[:, 0]
        total = _butterfly(np.pad(warp_sums, (0, 32 - len(warp_sums))))[0]
        r = np.float32(1.0) / np.sqrt(_f32(_f32(total / np.float32(d)) + np.float32(EPS)))
        y = _f32(_f32(_f32(x[row]) * r) * _f32(w))
        out[row] = bf16_round(y) if bf16_out else y
    assert not np.isnan(out).any()
    return out


def _inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 2).astype(np.float32)
    w = (rng.random(d) + 0.5).astype(np.float32)
    return x, w


def _close(got, want, bf16):
    tol = np.abs(want) * (BF16_STEP if bf16 else F32_RTOL)
    assert (np.abs(got - want) <= tol + 1e-30).all()


# ------------------------------------------------------------------ the plan

@pytest.mark.parametrize("d,rows,want_bf16,want_f32", [
    (64, 4, (32, 8), (32, 4)),
    (100, 4, (32, 4), (32, 4)),
    (1000, 3, (128, 8), (128, 4)),
    (4096, 4, (128, 8), (256, 4)),
    (4096, 64, (128, 8), (256, 4)),
    (4096, 256, (128, 8), (256, 4)),
    (5000, 5, (160, 8), (320, 4)),
    (20000, 2, (512, 8), (512, 4)),
])
def test_plan(d, rows, want_bf16, want_f32):
    """At d = 4096 in bf16 a row is 512 vectors of 16 bytes: 128 threads
    keep four each (f32 x: 1024 vectors, 256 threads); the fewest warps that
    keep the row, at least 128 threads, at most 512 (d = 20000: read again),
    never more warps than the row has vectors for (d = 64, 100: one warp);
    the same at any row count, since a block takes one row."""
    assert kernels.norm_plan(rows, d, torch.bfloat16, torch.bfloat16) == want_bf16
    assert kernels.norm_plan(rows, d, torch.float32, torch.float32) == want_f32


@pytest.mark.parametrize("align,x_dtype,w_dtype,vec", [
    (16, torch.bfloat16, torch.float32, 8), (8, torch.bfloat16, torch.bfloat16, 4),
    (8, torch.bfloat16, torch.float32, 2), (4, torch.float32, torch.float32, 1),
    (2, torch.bfloat16, torch.bfloat16, 1), (16, torch.float32, torch.bfloat16, 4)])
def test_plan_vector_follows_the_pointers(align, x_dtype, w_dtype, vec):
    """Each of x, w and out must start aligned to its loads (up to 16
    bytes); a narrower alignment takes narrower vectors, not a copy."""
    assert kernels.norm_plan(4, 4096, x_dtype, w_dtype, align)[1] == vec


@pytest.mark.parametrize("d,vec", [(1001, 1), (1002, 2), (1004, 4), (1000, 8)])
def test_plan_vector_divides_d(d, vec):
    assert kernels.norm_plan(3, d, torch.bfloat16, torch.bfloat16)[1] == vec


def test_alignment_of_the_pointers():
    base = torch.zeros(64, dtype=torch.bfloat16)
    assert kernels._alignment(base) == 16
    assert kernels._alignment(base, base[1:]) == 2
    assert kernels._alignment(base[4:], base[8:]) == 8


# ------------------------------------------------------- the order of sums

@pytest.mark.parametrize("d", [64, 100, 1000, 4096, 5000])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_emulated_order_within_tolerance_of_plain_and_jax(d, dtype):
    """The kernel's order of sums, emulated at the plan's launch, within one
    bf16 step (f32: 1e-5) of the plain version and of JAX's kernel in
    interpret mode, weights in bf16."""
    rows = 4
    x, w = _inputs(rows, d, seed=d)
    tdt = getattr(torch, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(torch.bfloat16)
    plan = kernels.norm_plan(rows, d, tdt, torch.bfloat16)
    got = emulate_k10(tx.float().numpy(), tw.float().numpy(), tdt == torch.bfloat16, plan)
    plain = kernels.fused_rms_norm_plain(tx, tw, EPS).float().numpy()
    _close(got, plain, tdt == torch.bfloat16)
    want = np.asarray(jkernels.fused_rms_norm(jnp.asarray(tx.float().numpy()).astype(dtype),
                                              jnp.asarray(tw.float().numpy())
                                              .astype(jnp.bfloat16), EPS), np.float32)
    _close(got, want, tdt == torch.bfloat16)
    if tdt == torch.bfloat16:
        assert (got == plain).mean() > 0.98  # nearly all to the bit


@pytest.mark.parametrize("rows,d", [(2, 20000), (3, 40000)])
def test_rows_longer_than_the_registers_are_read_again(rows, d):
    """More vectors than a row's threads keep (4 each): the rest are read
    again, summed after the kept ones; still within one bf16 step."""
    x, w = _inputs(rows, d, seed=rows)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    plan = kernels.norm_plan(rows, d, torch.bfloat16, torch.bfloat16)
    assert d // plan[1] > kernels._NORM_KEEP * plan[0]
    got = emulate_k10(tx.float().numpy(), tw.float().numpy(), True, plan)
    _close(got, kernels.fused_rms_norm_plain(tx, tw, EPS).float().numpy(), True)


# ---------------------------------------------------------- the C side

def test_entry_point_matches_the_argtypes(monkeypatch):
    class Lib:
        llamago_rms_norm = type("Fn", (), {})()

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    fn = kernels._lib_norm.__wrapped__()
    sig = re.search(r'extern "C" int llamago_rms_norm\(([^)]*)\)', SRC.read_text())
    params = [p.split() for p in sig.group(1).split(",")]
    assert [p[-1] for p in params] == ["x", "w", "out", "rows", "d", "eps", "x_bf16", "w_bf16",
                                       "vec", "tpr", "stream"]
    types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    assert fn.argtypes == [types[" ".join(p[:-1])] for p in params]
    assert fn.restype is ctypes.c_int


def test_one_barrier_and_the_constants_the_plan_mirrors():
    src = SRC.read_text()
    assert src.count("__syncthreads()") == 1
    assert f"constexpr int kKeep = {kernels._NORM_KEEP};" in src
    assert "tpr = blockDim.x, row = blockIdx.x" in src
    assert "<<<rows, tpr, 0, st>>>" in src
    assert f"constexpr int kMaxThreads = {kernels._NORM_MAX_BLOCK};" in src
    assert "1.0f / sqrtf(total / (float)d + eps)" in src


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __call__(self, x, w, out, rows, d, eps, x_bf16, w_bf16, vec, tpr, stream):
        self.calls.append((rows, d, x_bf16, w_bf16, vec, tpr))
        return 0


@pytest.mark.parametrize("rows", [1, 4, 7, 64, 256])
def test_launcher_hands_the_plan(monkeypatch, rows):
    """On meta tensors: one call with the plan, the output in x's shape
    and dtype, one launch counted."""
    fake = _FakeLib()
    monkeypatch.setattr(kernels, "_lib_norm", lambda: fake)
    monkeypatch.setattr(kernels, "_cuda_or_raise", lambda x, what: None)
    monkeypatch.setattr(kernels, "_stream", lambda x2: 0)
    monkeypatch.setattr(kernels.fused_rms_norm, "launches", 0)
    meta = torch.device("meta")
    x = torch.empty((1, rows, 4096), dtype=torch.bfloat16, device=meta)
    w = torch.empty((4096,), dtype=torch.bfloat16, device=meta)
    out = kernels.fused_rms_norm(x, w, EPS)
    assert out.shape == x.shape and out.dtype == x.dtype
    tpr, vec = kernels.norm_plan(rows, 4096, torch.bfloat16, torch.bfloat16)
    assert fake.calls == [(rows, 4096, 1, 1, vec, tpr)]
    assert kernels.fused_rms_norm.launches == 1
