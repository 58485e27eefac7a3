"""Weight-only block quantization: Q8_0, Q4_0 / Q4_1 (block size 32) and
the w4x8 int4 execution format (group size 128).

Counterpart of the JAX package's `ops/quant.py`; every function here gives
the JAX function's result bit for bit (tests/test_torch_ops.py,
tests/test_torch_int4.py).

Formats:
  Q8_0: per 32-block scale d = absmax/127, q = round(x/d) in int8.
  Q4_0: per 32-block scale d = signed extreme / -8, q = round(x/d)+8 in
        [0, 15], two nibbles per byte.
  Q4_1: affine blocks from a file: x = nibble * d + m (leaf key "m").
  w4x8: centered nibbles -8..7, one scale per 128-row group.

Layout: weights live [in, out]; blocks run along the INPUT (contraction)
dim:
  q8:  int8  [in, out],     s: [in/32, out]
  q4:  uint8 [in/2, out],   s: [in/32, out] (and m: [in/32, out]); within a
       32-row block byte j holds rows j (lo nibble) and j+16 (hi nibble)
  q4x: uint8 [in/2, out],   s: bf16 [in/64, out]; byte r holds rows 2r (lo)
       and 2r+1 (hi); the group-128 scales are stored as duplicated
       group-64 rows (rows 2g and 2g+1 equal), the JAX leaf layout, so a
       tree from either package means the same. The CUDA kernels read row
       2g only.
Scales are bf16 from `quantize` / `quantize_w4x8` and f32 from a file: each
leaf keeps its own scale dtype.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

QK = 32
G4X8 = 128  # w4x8 scale-group size along the input dim

_INT4_EXEC_ENV = "LLAMAGO_INT4_EXEC"


def int4_exec_format(device="cuda") -> str:
    """The format int4 weights run in: $LLAMAGO_INT4_EXEC if it is "w4x8"
    or "q4_0"; else "w4x8" on a CUDA device (re-laid at load for the W4A8
    decode kernel) and "q4_0" (the file format) on the CPU."""
    v = os.environ.get(_INT4_EXEC_ENV)
    if v in ("w4x8", "q4_0"):
        return v
    return "w4x8" if torch.device(device).type == "cuda" else "q4_0"


# parameter leaves that get quantized (matmul weights only)
QUANT_LEAVES = {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "output"}

# LM-head column padding (int8 only): the head is padded to a multiple of
# LM_HEAD_PAD columns (32000 -> 32768 for LLaMA) when that adds at most 5%
# columns. Pad columns quantize to scale 0, so they dequantize to exactly
# 0, and forward_impl slices logits back to vocab_size before any consumer.
LM_HEAD_PAD = 4096
_LM_HEAD_PAD_MAX_OVERHEAD = 0.05


def lm_head_pad_cols(n: int) -> int:
    """Padded column count for an int8 lm head (0 = leave unpadded)."""
    pad = (-n) % LM_HEAD_PAD
    if pad == 0 or pad > n * _LM_HEAD_PAD_MAX_OVERHEAD:
        return 0
    return pad


def pad_lm_head(leaf, vocab_size: int | None = None):
    """Column-pad a Q8_0 leaf to the aligned width (no-op otherwise).
    With `vocab_size`, pad only a head whose width equals it: wider heads
    carried by converted checkpoints stay addressable."""
    if not (is_quantized(leaf) and "q8" in leaf and "m" not in leaf):
        return leaf
    n = leaf["q8"].shape[-1]
    if vocab_size is not None and n != vocab_size:
        return leaf
    pad = lm_head_pad_cols(n)
    if not pad:
        return leaf
    return {"q8": F.pad(leaf["q8"], (0, pad)), "s": F.pad(leaf["s"], (0, pad))}


def lm_head_padded_cols(vocab_size: int) -> int:
    """The width pad_lm_head produces for a vocab_size-wide head — the
    only head width forward_impl may slice back down."""
    return vocab_size + lm_head_pad_cols(vocab_size)


def is_quantized(w) -> bool:
    return (isinstance(w, dict) and "s" in w
            and ("q8" in w or "q4" in w or "q4x" in w))


def _signed_extreme_scale(xb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """ggml's Q4_0 sign trick over dim -2 of xb [..., blocks, rows, n]: the
    bf16 scale d = (the element of largest |x|, the first of equals) / -8
    and its f32 reciprocal (0 where d is 0)."""
    idx = torch.argmax(torch.abs(xb), dim=-2, keepdim=True)
    signed_max = torch.take_along_dim(xb, idx, dim=-2)[..., 0, :]
    d = (signed_max / -8.0).to(torch.bfloat16)
    df = d.to(torch.float32)
    nz = df != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, df, torch.ones_like(df)),
                      torch.zeros_like(df))
    return d, inv


def quantize(w: torch.Tensor, bits: int = 8) -> dict:
    """Block-quantize a weight [..., in, out] along the `in` dim. The scale
    is rounded to bf16 FIRST and q is computed against the rounded scale,
    so the result matches the JAX package bit for bit."""
    *lead, k, n = w.shape
    assert k % QK == 0, f"in-dim {k} not divisible by block size {QK}"
    xb = w.to(torch.float32).reshape(*lead, k // QK, QK, n)
    if bits == 8:
        absmax = torch.amax(torch.abs(xb), dim=-2)  # [..., blocks, n]
        d = (absmax / 127.0).to(torch.bfloat16)
        df = d.to(torch.float32)
        pos = df > 0
        inv = torch.where(pos, 1.0 / torch.where(pos, df, torch.ones_like(df)),
                          torch.zeros_like(df))
        q = torch.clamp(torch.round(xb * inv[..., None, :]), -127, 127).to(torch.int8)
        return {"q8": q.reshape(*lead, k, n), "s": d}
    if bits == 4:
        d, inv = _signed_extreme_scale(xb)
        q = torch.clamp(torch.round(xb * inv[..., None, :]) + 8, 0, 15).to(torch.uint8)
        # block-local packing: byte j of a block holds rows j and j+16
        packed = q[..., :16, :] | (q[..., 16:, :] << 4)
        return {"q4": packed.reshape(*lead, k // 2, n), "s": d}
    raise ValueError(f"unsupported bits: {bits}")


def quantize_w4x8(w: torch.Tensor) -> dict:
    """Quantize [..., in, out] to the w4x8 format: centered nibbles -8..7
    (no +8 offset) packed interleaved, byte r holding rows 2r (lo) and 2r+1
    (hi); one bf16 scale per 128-row group (signed extreme / -8), stored as
    duplicated group-64 rows [in/64, out]."""
    *lead, k, n = w.shape
    assert k % G4X8 == 0, f"in-dim {k} not divisible by group {G4X8}"
    xb = w.to(torch.float32).reshape(*lead, k // G4X8, G4X8, n)
    d, inv = _signed_extreme_scale(xb)
    q = torch.clamp(torch.round(xb * inv[..., None, :]), -8, 7).to(torch.int32)
    pairs = q.reshape(*lead, k // 2, 2, n)
    packed = ((pairs[..., 0, :] & 0xF) | ((pairs[..., 1, :] & 0xF) << 4)).to(torch.uint8)
    return {"q4x": packed, "s": torch.repeat_interleave(d, 2, dim=-2)}


def unpack_w4x8(packed: torch.Tensor) -> torch.Tensor:
    """Packed w4x8 uint8 [..., in/2, out] -> centered int8 [..., in, out]
    (byte r -> rows 2r, 2r+1)."""
    *lead, half, n = packed.shape
    p = packed.to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo).to(torch.int8)
    hi = torch.where(hi > 7, hi - 16, hi).to(torch.int8)
    return torch.stack([lo, hi], dim=-2).reshape(*lead, half * 2, n)


def unpack_q4(packed: torch.Tensor) -> torch.Tensor:
    """Packed Q4 uint8 [..., in/2, out] -> centered int8 [..., in, out]
    (nibble - 8; within each 32-row block byte j -> rows j, j+16)."""
    *lead, half, n = packed.shape
    pb = packed.reshape(*lead, half // (QK // 2), QK // 2, n)
    lo = (pb & 0xF).to(torch.int8) - 8
    hi = ((pb >> 4) & 0xF).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-2).reshape(*lead, half * 2, n)


def w4x8_from_leaf(w: dict) -> dict:
    """Re-lay a Q4_0 leaf into the w4x8 format: exact dequantization of the
    32-blocks, then group-128 requantization. Q4_1 leaves, Q8_0 leaves and
    leaves whose in-dim is not a multiple of 128 come back as they are."""
    if "q4" not in w or "m" in w:
        return w
    if (w["q4"].shape[-2] * 2) % G4X8 != 0:
        return w
    return quantize_w4x8(dequantize(w, torch.float32))


def dequantize(w: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reference dequantization, in f32, then cast: Q8_0, Q4_0, Q4_1 (the
    leaf has mins "m" and its nibbles are raw 0..15) and w4x8 leaves."""
    if "q4x" in w:
        q = unpack_w4x8(w["q4x"]).to(torch.float32)
        s = torch.repeat_interleave(w["s"].to(torch.float32), G4X8 // 2, dim=-2)
        return (q * s).to(dtype)
    if "q8" in w:
        q = w["q8"].to(torch.float32)
    else:
        q = unpack_q4(w["q4"]).to(torch.float32)
        if "m" in w:
            q = q + 8.0
    out = q * torch.repeat_interleave(w["s"].to(torch.float32), QK, dim=-2)
    if "m" in w:
        out = out + torch.repeat_interleave(w["m"].to(torch.float32), QK, dim=-2)
    return out.to(dtype)


def quant_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [..., in] @ quantized w -> [..., out]. Q8_0, Q4_0 and w4x8 leaves
    go to the kernels of ops/kernels.py (the CUDA kernel on a CUDA tensor,
    its plain version on a CPU tensor). A Q4_1 leaf is dequantized to
    x.dtype and multiplied by torch.matmul: the JAX package has no kernel
    for it either."""
    if "m" in w:
        return torch.matmul(x, dequantize(w, x.dtype))
    from llamago_tpu_torch.ops import kernels

    return kernels.dequant_matmul(x, w)
