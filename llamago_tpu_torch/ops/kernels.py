"""The quantized matmuls: K1, K5, K6 and K9, their plain versions and their
launch counts.

`dequant_matmul(x, w)` computes x [..., K] @ dequantized w -> [..., N] in
x.dtype and dispatches on the leaf as the JAX package's `dequant_matmul`
does (llamago_tpu/ops/kernels.py):

  {"q4x", "s"}  w4x8 leaf -> `w4x8_matmul`: K5, the W4A8 decode matmul, when
                the row count m is at most `_W4X8_A8_MAX_M` (16, env
                LLAMAGO_W4X8_A8_MAX_M), replacing `_w4x8_decode_kernel`;
                else K6, the f32 stream matmul, replacing
                `_w4x8_stream_kernel`. CUDA: `csrc/w4x8_matmul.cu`.
  {"q8"|"q4", "s"}  Q8_0 / Q4_0 leaf -> K9, the scale-on-output matmul
                (`dequant_matmul_so`, replacing `_dequant_mm_kernel_so`,
                CUDA: `csrc/dequant_matmul_so.cu`), when max(8, m) is at most
                `SCALE_ON_OUTPUT_MAX_M` (0 = off, env
                LLAMAGO_KERNEL_SO_MAX_M); else K1, the dequant-matmul
                (replacing `_dequant_mm_kernel`, bits 8 and 4, CUDA:
                `csrc/dequant_matmul.cu`).

A Q4_1 leaf (with mins "m") never comes here: `ops/quant.py:quant_matmul`
dequantizes it, as the JAX package does. The TPU launchers' VMEM gates
(`_plan_tiles`, `can_fuse`, the m > 1024 cut-off) are not carried over: the
CUDA kernels take any m.

Each `.cu` header says what bounds its kernel on the card and what the
design does about it. A CPU tensor takes the kernel's plain version
(`*_plain`); a CUDA tensor takes the kernel, or the wrapper raises. Each
wrapper counts its launches (`dequant_matmul.launches` for Q8_0 and
`.launches_q4` for Q4_0, `w4x8_matmul.launches_a8` and `.launches_stream`,
`dequant_matmul_so.launches`).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from llamago_tpu_torch.ops import _build
from llamago_tpu_torch.ops.quant import G4X8, QK, dequantize, unpack_q4, unpack_w4x8

# Blocks the GEMV paths aim to have in flight: four per SM of an H100.
_TARGET_BLOCKS = 4 * 132
_GEMV_MAX_M = 8
_GEMV_COLS = 512  # columns per GEMV block (csrc/dequant_matmul.cu)

# Rows up to which a w4x8 leaf takes K5, whose int8 activation rounding
# changes the numerics; above it K6 (exact given the format).
_W4X8_A8_MAX_M = int(os.environ.get("LLAMAGO_W4X8_A8_MAX_M", "16"))
_A8_WARPS = 4  # warps per K5 block, one scale group each (csrc/w4x8_matmul.cu)

# Rows (padded up to 8, as the TPU launcher pads them) at or below which a
# Q8_0 / Q4_0 leaf takes K9. Off by default, as in the JAX package.
SCALE_ON_OUTPUT_MAX_M = int(os.environ.get("LLAMAGO_KERNEL_SO_MAX_M", "0"))

# 1/127 rounded to f32: XLA compiles JAX's `amax / 127.0` to this product
_INV_127 = float(torch.tensor(1.0, dtype=torch.float32) / 127.0)


# ------------------------------------------------------------ plain versions

def dequant_matmul_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain PyTorch K1 (Q8_0 or Q4_0 leaf; any leaf `dequantize` takes):
    dequantize to f32, f32 product, cast to x.dtype."""
    k = x.shape[-1]
    deq = dequantize(w, torch.float32)
    out = x.reshape(-1, k).to(torch.float32) @ deq
    return out.reshape(*x.shape[:-1], deq.shape[-1]).to(x.dtype)


def dequant_matmul_so_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain PyTorch K9: per 32-block, the raw integers (int8, or nibbles
    0..15) dotted with the block's x in f32; a Q4_0 block then subtracts
    8 * sum(x_block); times the block's scale; summed over the blocks."""
    k = x.shape[-1]
    nb = k // QK
    xb = x.reshape(-1, nb, QK).to(torch.float32)  # [m, nb, 32]
    if "q8" in w:
        q = w["q8"].to(torch.float32)
    else:
        q = unpack_q4(w["q4"]).to(torch.float32) + 8.0  # raw nibbles
    n = q.shape[-1]
    part = torch.einsum("mbk,bkn->mbn", xb, q.reshape(nb, QK, n))
    if "q4" in w:
        part = part - 8.0 * xb.sum(dim=-1)[..., None]
    out = (part * w["s"].to(torch.float32)[None]).sum(dim=1)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)


def quantize_activations_a8(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's activation quantization of x [m, K], plain PyTorch: per (row,
    128-group) sx = amax * fl(1/127) (1 where amax is 0) and xq =
    clip(round_half_even(x / sx), +-127). Returns xq int8 [m, K] and sx f32
    [m, K/128], bit for bit what the JAX launcher computes."""
    m, k = x2.shape
    x3 = x2.to(torch.float32).reshape(m, k // G4X8, G4X8)
    amax = x3.abs().amax(dim=-1)
    sx = torch.where(amax > 0, amax * _INV_127, torch.ones_like(amax))
    xq = torch.clamp(torch.round(x3 / sx[..., None]), -127, 127).to(torch.int8)
    return xq.reshape(m, k), sx


def w4x8_matmul_a8_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain PyTorch K5: x quantized to int8 per (row, 128-group), an exact
    integer dot with the centered int4 weights per group (f32 einsum: a
    group's dot stays below 2^24), then acc += d * sx[g] * s[g] in f32."""
    k = x.shape[-1]
    g = k // G4X8
    xq, sx = quantize_activations_a8(x.reshape(-1, k))
    m = xq.shape[0]
    wq = unpack_w4x8(w["q4x"]).to(torch.float32)  # [K, N]
    n = wq.shape[-1]
    d = torch.einsum("mgk,gkn->mgn", xq.to(torch.float32).reshape(m, g, G4X8),
                     wq.reshape(g, G4X8, n))
    sg = w["s"][0::2].to(torch.float32)  # [G, N]: row 2g of the duplicated rows
    out = (d * sx[..., None] * sg[None]).sum(dim=1)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)


def w4x8_matmul_stream_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain PyTorch K6: f32(int4) * f32(s) over 64-row spans, f32 product
    with f32(x), cast to x.dtype. No activation quantization: K1's plain
    version on a w4x8 leaf."""
    return dequant_matmul_plain(x, w)


# ------------------------------------------------------------------ launchers

def ksplit_for(m: int, k: int, n: int) -> int:
    """K-split of the K1 / K9 GEMV path: enough blocks to fill the card, and
    at least eight quant blocks (one per warp) in each split."""
    if m > _GEMV_MAX_M:
        return 1
    col_blocks = -(-n // _GEMV_COLS)
    return max(1, min((k // QK) // 8, -(-_TARGET_BLOCKS // col_blocks)))


def a8_cols_per_thread(m: int) -> int:
    """Columns each K5 thread owns: 8 up to 8 rows, 4 above (the integer and
    f32 sums of every row and column live in registers)."""
    return 8 if m <= 8 else 4


def a8_split_for(m: int, k: int, n: int) -> tuple[int, int]:
    """(ksplit, groups per split) of K5: splits cut at whole 128-groups,
    each holds at least one group per warp where K allows, none is empty."""
    groups = k // G4X8
    col_blocks = -(-n // (32 * a8_cols_per_thread(m)))
    ksplit = max(1, min(groups // _A8_WARPS, -(-_TARGET_BLOCKS // col_blocks)))
    per = -(-groups // ksplit)
    return -(-groups // per), per


@functools.cache
def _lib():
    fn = _build.library("dequant_matmul").llamago_dequant_matmul
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_so():
    fn = _build.library("dequant_matmul_so").llamago_dequant_matmul_so
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_w4x8():
    lib = _build.library("w4x8_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.llamago_w4x8_quantize_x.argtypes = [p, p, p, i, i, i, p]
    lib.llamago_w4x8_matmul_a8.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.llamago_w4x8_matmul_stream.argtypes = [p, p, p, p, i, i, i, i, p]
    for fn in (lib.llamago_w4x8_quantize_x, lib.llamago_w4x8_matmul_a8,
               lib.llamago_w4x8_matmul_stream):
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     key: str = "q8") -> None:
    """What the CUDA kernels take: x [m, K] f32 or bf16; `key` "q8": int8
    [K, N] with s [K/32, N]; "q4": uint8 [K/2, N] with s [K/32, N]; "q4x":
    uint8 [K/2, N] with bf16 s [K/64, N], K a multiple of 128. N a multiple
    of 16, everything contiguous, 16-byte aligned and on x's device."""
    m, k = x2.shape
    if q.dim() != 2 or s.dim() != 2:
        raise ValueError(f"dequant_matmul: want 2-D {key}/s, got {tuple(q.shape)}, "
                         f"{tuple(s.shape)}")
    n = q.shape[1]
    unit = G4X8 if key == "q4x" else QK
    q_rows = k if key == "q8" else k // 2
    s_rows = k // 64 if key == "q4x" else k // QK
    if q.shape[0] != q_rows or k % unit or s.shape != (s_rows, n):
        raise ValueError(f"dequant_matmul: shapes x{tuple(x2.shape)} "
                         f"{key}{tuple(q.shape)} s{tuple(s.shape)} do not agree")
    if n % 16:
        raise ValueError(f"dequant_matmul: N={n} must be a multiple of 16")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dequant_matmul: x dtype {x2.dtype} not supported")
    s_dtypes = (torch.bfloat16,) if key == "q4x" else (torch.bfloat16, torch.float32)
    if s.dtype not in s_dtypes or q.dtype != (torch.int8 if key == "q8" else torch.uint8):
        raise ValueError(f"dequant_matmul: {key} {q.dtype} / s {s.dtype} not supported")
    for name, t in (("x", x2), (key, q), ("s", s)):
        if t.device != x2.device:
            raise ValueError(f"dequant_matmul: {name} on {t.device}, x on {x2.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"dequant_matmul: {name} must be contiguous and "
                             "16-byte aligned")


def _rows(x: torch.Tensor) -> torch.Tensor:
    x2 = x.reshape(-1, x.shape[-1])
    return x2 if x2.is_contiguous() else x2.contiguous()


def _stream(x2: torch.Tensor) -> int:
    return torch.cuda.current_stream(x2.device).cuda_stream


def _cuda_or_raise(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")


def w4x8_quantize_x(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's activation quantization alone, on the card (the kernel K5 runs
    first): xq int8 [m, K], sx f32 [m, K/128]. For checking it against
    `quantize_activations_a8`; the serving path goes through `w4x8_matmul`."""
    _cuda_or_raise(x2, "w4x8_quantize_x")
    m, k = x2.shape
    if k % G4X8 or x2.dtype not in (torch.bfloat16, torch.float32) \
            or not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError(f"w4x8_quantize_x: x {tuple(x2.shape)} {x2.dtype} not supported")
    xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m, k // G4X8), dtype=torch.float32, device=x2.device)
    err = _lib_w4x8().llamago_w4x8_quantize_x(
        x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
        int(x2.dtype == torch.bfloat16), _stream(x2))
    _build.check(err, "w4x8_quantize_x")
    return xq, sx


def w4x8_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [..., K] @ w4x8 w {"q4x": uint8 [K/2, N], "s": bf16 [K/64, N]} ->
    [..., N] in x.dtype: K5 up to `_W4X8_A8_MAX_M` rows, K6 above."""
    k = x.shape[-1]
    m = x.numel() // k
    a8 = max(8, m) <= _W4X8_A8_MAX_M  # the TPU launcher pads m up to 8
    if x.device.type == "cpu":
        return (w4x8_matmul_a8_plain if a8 else w4x8_matmul_stream_plain)(x, w)
    _cuda_or_raise(x, "w4x8_matmul")
    q, s = w["q4x"], w["s"]
    x2 = _rows(x)
    _check_cuda_args(x2, q, s, "q4x")
    n = q.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    x_bf16 = int(x2.dtype == torch.bfloat16)
    lib = _lib_w4x8()
    if a8:
        ksplit, per = a8_split_for(m, k, n)
        # one scratch allocation: sx f32 [m, K/128], the split-K partial sums
        # f32 [ksplit, m, N], then xq int8 [m, K]
        sx_bytes, ws_bytes = 4 * m * (k // G4X8), 4 * ksplit * m * n
        scratch = torch.empty(sx_bytes + ws_bytes + m * k, dtype=torch.uint8,
                              device=x2.device)
        sx_ptr = scratch.data_ptr()
        ws_ptr = sx_ptr + sx_bytes
        err = lib.llamago_w4x8_matmul_a8(
            x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), ws_ptr + ws_bytes,
            sx_ptr, ws_ptr, m, k, n, x_bf16, ksplit, per, _stream(x2))
        _build.check(err, "w4x8_matmul (W4A8)")
        w4x8_matmul.launches_a8 += 1
    else:
        err = lib.llamago_w4x8_matmul_stream(
            x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n, x_bf16,
            _stream(x2))
        _build.check(err, "w4x8_matmul (stream)")
        w4x8_matmul.launches_stream += 1
    return out.reshape(*x.shape[:-1], n)


w4x8_matmul.launches_a8 = 0
w4x8_matmul.launches_stream = 0


def _launch_q(lib_fn, what: str, x: torch.Tensor, w: dict, gemv_rows: int) -> torch.Tensor:
    """Shared launcher of K1 and K9: both C entry points take the same
    arguments (x, q, s, out, workspace, m, K, N, bits, dtypes, ksplit).
    `gemv_rows`: the row count the split-K GEMV is launched with (K1 takes
    its tiled kernel above 8 rows; K9 walks all rows a few at a time)."""
    key = "q8" if "q8" in w else "q4"
    q, s = w[key], w["s"]
    x2 = _rows(x)
    _check_cuda_args(x2, q, s, key)
    (m, k), n = x2.shape, q.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    ksplit = ksplit_for(gemv_rows, k, n)
    ws = (torch.empty(ksplit * m * n, dtype=torch.float32, device=x2.device)
          if gemv_rows <= _GEMV_MAX_M else out)
    err = lib_fn()(x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                   ws.data_ptr(), m, k, n, 8 if key == "q8" else 4,
                   int(x2.dtype == torch.bfloat16), int(s.dtype == torch.bfloat16),
                   ksplit, _stream(x2))
    _build.check(err, what)
    return out.reshape(*x.shape[:-1], n)


def dequant_matmul_so(x: torch.Tensor, w: dict) -> torch.Tensor:
    """K9: x [..., K] @ Q8_0 / Q4_0 w with the block scales folded into the
    output -> [..., N] in x.dtype."""
    if x.device.type == "cpu":
        return dequant_matmul_so_plain(x, w)
    _cuda_or_raise(x, "dequant_matmul_so")
    out = _launch_q(_lib_so, "dequant_matmul_so", x, w, gemv_rows=1)
    dequant_matmul_so.launches += 1
    return out


dequant_matmul_so.launches = 0


def dequant_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [..., K] @ quantized w -> [..., N] in x.dtype; w is a Q8_0 leaf
    {"q8": int8 [K, N], "s": [K/32, N]}, a Q4_0 leaf {"q4": uint8 [K/2, N],
    "s": [K/32, N]} or a w4x8 leaf {"q4x", "s"} (module docstring)."""
    if "q4x" in w:
        return w4x8_matmul(x, w)
    k = x.shape[-1]
    if max(8, x.numel() // k) <= SCALE_ON_OUTPUT_MAX_M:
        return dequant_matmul_so(x, w)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, w)
    _cuda_or_raise(x, "dequant_matmul")
    out = _launch_q(_lib, "dequant_matmul", x, w, gemv_rows=x.numel() // k)
    if "q8" in w:
        dequant_matmul.launches += 1
    else:
        dequant_matmul.launches_q4 += 1
    return out


dequant_matmul.launches = 0
dequant_matmul.launches_q4 = 0
