"""ggml-bit-compatible Q8_0 / Q4_0 / Q4_1 tensor blocks in ggjt files (numpy
only).

The port's own copy of the reading half of the JAX package's
`checkpoint/quant_file.py` (the writers come with the checkpoint-tools
slice of the port):

  Q8_0 block (34 bytes / 32 elems): f16 d, int8 qs[32];  x = qs*d
  Q4_0 block (18 bytes / 32 elems): f16 d, uint8 qs[16];
      qs[j] holds elem j (lo nibble) and elem j+16 (hi nibble),
      x = (nibble - 8) * d
  Q4_1 block (20 bytes / 32 elems): f16 d, f16 m, uint8 qs[16];
      x = nibble * d + m

Blocks run along the file's contiguous dim (in_features); the device
layout ({"q8": int8 [in, out] | "q4": uint8 [in/2, out], "s": f32
[in/32, out], and "m" for Q4_1; ops/quant.py) is a transpose, because the
in-memory nibble pairing matches ggml's (j, j+16).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

QK = 32
Q8_BLOCK_BYTES = 2 + QK  # f16 scale + 32 int8
Q4_BLOCK_BYTES = 2 + QK // 2
Q41_BLOCK_BYTES = 4 + QK // 2  # f16 d + f16 m + 16 nibble bytes

DTYPE_Q4_0 = 2  # ggml type ids
DTYPE_Q4_1 = 3
DTYPE_Q8_0 = 8

_BLOCK_BYTES = {"q8_0": Q8_BLOCK_BYTES, "q4_0": Q4_BLOCK_BYTES,
                "q4_1": Q41_BLOCK_BYTES}


@dataclass
class QuantTensor:
    """A quantized tensor as stored in a ggjt file: raw blocks, row-major
    [out, in] logical shape."""

    kind: str  # "q8_0" | "q4_0" | "q4_1"
    raw: np.ndarray  # uint8 [out, row_bytes]
    shape: tuple[int, int]  # (out, in)

    @property
    def ndim(self) -> int:
        return 2


def row_bytes(kind: str, in_dim: int) -> int:
    return (in_dim // QK) * _BLOCK_BYTES[kind]


def split_blocks(qt: QuantTensor):
    """raw blocks -> (q, d[, m]): q int8 [out, in] (q8) or uint8
    [out, in/2] (q4), d float32 [out, in/32]; Q4_1 also returns m (mins)."""
    out, k = qt.shape
    nb = k // QK
    hdr = 4 if qt.kind == "q4_1" else 2
    blocks = qt.raw.reshape(out, nb, _BLOCK_BYTES[qt.kind])
    d = np.ascontiguousarray(blocks[:, :, :2]).view(np.float16).astype(np.float32)
    d = d.reshape(out, nb)
    qs = np.ascontiguousarray(blocks[:, :, hdr:])
    if qt.kind == "q8_0":
        return qs.view(np.int8).reshape(out, k), d
    if qt.kind == "q4_1":
        m = np.ascontiguousarray(blocks[:, :, 2:4]).view(np.float16)
        return qs.reshape(out, k // 2), d, m.astype(np.float32).reshape(out, nb)
    return qs.reshape(out, k // 2), d


def dequantize_rows(qt: QuantTensor) -> np.ndarray:
    """Numpy reference dequantization -> f32 [out, in]."""
    parts = split_blocks(qt)
    q, d = parts[0], parts[1]
    out, k = qt.shape
    nb = k // QK
    if qt.kind == "q8_0":
        return (q.astype(np.float32).reshape(out, nb, QK)
                * d[..., None]).reshape(out, k)
    lo = (q & 0xF).astype(np.int16)
    hi = ((q >> 4) & 0xF).astype(np.int16)
    qf = np.concatenate(
        [lo.reshape(out, nb, 16), hi.reshape(out, nb, 16)], axis=-1
    ).astype(np.float32)
    if qt.kind == "q4_1":
        return (qf * d[..., None] + parts[2][..., None]).reshape(out, k)
    return ((qf - 8.0) * d[..., None]).reshape(out, k)
