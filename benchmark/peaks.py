"""The chip's peaks, from NVIDIA's H100 SXM data sheet (dense rates, no
sparsity, at the full 700 W power limit; the run reports the card's limit
beside its numbers): 3.35 TB/s of HBM3, 989 TFLOP/s in bf16 and fp16 on the
tensor cores, 495 TFLOP/s in TF32, 67 TFLOP/s in f32 outside them. A copy of
the figures the port keeps in `utils/timing.py`, frozen here with the
yardstick.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
F32_FLOPS_PER_S = 67e12

PEAK_FLOPS_PER_S = {"bfloat16": BF16_FLOPS_PER_S, "float32": F32_FLOPS_PER_S}


def least_s(flops: float, nbytes: float, flops_per_s: float = BF16_FLOPS_PER_S) -> float:
    """The least time the chip can take for the work: the larger of its
    operations over the peak rate and its bytes over the memory's."""
    return max(flops / flops_per_s, nbytes / HBM_BYTES_PER_S)
