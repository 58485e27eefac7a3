"""K1: the Q8_0 dequant-matmul, its plain version and its launch count.

`dequant_matmul(x, {"q8", "s"})` computes x [..., K] @ (q8 * s) with the
weight dequantized to f32 and an f32 accumulation, cast back to x.dtype.

Replaces llamago_tpu/ops/kernels.py `_dequant_mm_kernel` (bits=8). The
CUDA kernel is `csrc/dequant_matmul.cu`; its header note says what bounds
it on the card (the int8 weight stream at decode) and how its design
answers that. A CPU tensor takes `dequant_matmul_plain`; a CUDA tensor
takes the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llamago_tpu_torch.ops import _build

QK = 32
# Blocks the GEMV path aims to have in flight: four per SM of an H100.
_TARGET_BLOCKS = 4 * 132
_GEMV_MAX_M = 8
_GEMV_COLS = 512  # columns per GEMV block (csrc/dequant_matmul.cu)


def dequant_matmul_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain PyTorch K1: dequantize to f32, f32 product, cast to x.dtype."""
    k = x.shape[-1]
    q, s = w["q8"], w["s"]
    deq = q.to(torch.float32) * torch.repeat_interleave(
        s.to(torch.float32), QK, dim=-2)
    out = x.reshape(-1, k).to(torch.float32) @ deq
    return out.reshape(*x.shape[:-1], q.shape[-1]).to(x.dtype)


def ksplit_for(m: int, k: int, n: int) -> int:
    """K-split of the GEMV path: enough blocks to fill the card, and at
    least eight quant blocks (one per warp) in each split."""
    if m > _GEMV_MAX_M:
        return 1
    col_blocks = -(-n // _GEMV_COLS)
    return max(1, min((k // QK) // 8, -(-_TARGET_BLOCKS // col_blocks)))


@functools.cache
def _lib():
    fn = _build.library("dequant_matmul").llamago_dequant_matmul
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    m, k = x2.shape
    if q.dim() != 2 or s.dim() != 2:
        raise ValueError(f"dequant_matmul: want 2-D q8/s, got {tuple(q.shape)}, "
                         f"{tuple(s.shape)}")
    n = q.shape[1]
    if q.shape[0] != k or k % QK or s.shape != (k // QK, n):
        raise ValueError(f"dequant_matmul: shapes x{tuple(x2.shape)} "
                         f"q8{tuple(q.shape)} s{tuple(s.shape)} do not agree")
    if n % 16:
        raise ValueError(f"dequant_matmul: N={n} must be a multiple of 16")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dequant_matmul: x dtype {x2.dtype} not supported")
    if s.dtype not in (torch.bfloat16, torch.float32) or q.dtype != torch.int8:
        raise ValueError(f"dequant_matmul: q8 {q.dtype} / s {s.dtype} not supported")
    for name, t in (("x", x2), ("q8", q), ("s", s)):
        if t.device != x2.device:
            raise ValueError(f"dequant_matmul: {name} on {t.device}, x on {x2.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"dequant_matmul: {name} must be contiguous and "
                             "16-byte aligned")


def dequant_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [..., K] @ Q8_0 w {"q8": int8 [K, N], "s": [K/32, N]} -> [..., N]
    in x.dtype."""
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul: unsupported device {x.device}")
    q, s = w["q8"], w["s"]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    _check_cuda_args(x2, q, s)
    m, n = x2.shape[0], q.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    ksplit = ksplit_for(m, k, n)
    ws = (torch.empty(ksplit * m * n, dtype=torch.float32, device=x2.device)
          if m <= _GEMV_MAX_M else out)
    err = _lib()(x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), m, k, n, int(x2.dtype == torch.bfloat16),
                 int(s.dtype == torch.bfloat16), ksplit,
                 torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "dequant_matmul")
    dequant_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


dequant_matmul.launches = 0
