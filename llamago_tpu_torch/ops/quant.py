"""Weight-only Q8_0 block quantization (block size 32).

Counterpart of the JAX package's `ops/quant.py`, Q8_0 only (Q4_0 and the
int4 execution formats come with the int4 slice of the port).

Format: per 32-block scale d = absmax/127, q = round(x/d) in int8.
Layout: weights live [in, out]; blocks run along the INPUT (contraction)
dim:  q8: int8 [in, out],  s: [in/32, out] (bf16 from `quantize`, f32
from a Q8_0 file — each leaf keeps its own scale dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

QK = 32

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


def quantize(w: torch.Tensor, bits: int = 8) -> dict:
    """Block-quantize a weight [..., in, out] along the `in` dim. The scale
    is rounded to bf16 FIRST and q is computed against the rounded scale,
    so the result matches the JAX package bit for bit."""
    if bits != 8:
        raise NotImplementedError(
            "int4 weights are not yet ported (int4 slice of the port)")
    *lead, k, n = w.shape
    assert k % QK == 0, f"in-dim {k} not divisible by block size {QK}"
    xb = w.to(torch.float32).reshape(*lead, k // QK, QK, n)
    absmax = torch.amax(torch.abs(xb), dim=-2)  # [..., blocks, n]
    d = (absmax / 127.0).to(torch.bfloat16)
    df = d.to(torch.float32)
    pos = df > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, df, torch.ones_like(df)),
                      torch.zeros_like(df))
    q = torch.clamp(torch.round(xb * inv[..., None, :]), -127, 127).to(torch.int8)
    return {"q8": q.reshape(*lead, k, n), "s": d}


def dequantize(w: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reference Q8_0 dequantization: q * s, in f32, then cast."""
    if "q8" not in w:
        raise NotImplementedError(
            "only Q8_0 leaves are ported; int4 comes with the int4 slice")
    q = w["q8"].to(torch.float32)
    s = torch.repeat_interleave(w["s"].to(torch.float32), QK, dim=-2)
    return (q * s).to(dtype)


def quant_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [..., in] @ quantized w -> [..., out] through the dequant-matmul
    (ops/kernels.py): the CUDA kernel on a CUDA tensor, its plain version
    on a CPU tensor."""
    if "q8" not in w or "m" in w:
        raise NotImplementedError(
            "only Q8_0 weights are ported; int4 comes with the int4 slice")
    from llamago_tpu_torch.ops import kernels

    return kernels.dequant_matmul(x, w)
