"""ggml-bit-compatible Q8_0 tensor blocks in ggjt files (numpy only).

The port's own copy of the Q8_0 subset of the JAX package's
`checkpoint/quant_file.py`:

  Q8_0 block (34 bytes / 32 elems): f16 d, int8 qs[32];  x = qs*d

Blocks run along the file's contiguous dim (in_features); the device
layout ({"q8": int8 [in, out], "s": f32 [in/32, out]}) is a transpose.
Q4_0/Q4_1 blocks come with the int4 slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

QK = 32
Q8_BLOCK_BYTES = 2 + QK  # f16 scale + 32 int8
DTYPE_Q8_0 = 8  # ggml type id

_BLOCK_BYTES = {"q8_0": Q8_BLOCK_BYTES}


@dataclass
class QuantTensor:
    """A quantized tensor as stored in a ggjt file: raw blocks, row-major
    [out, in] logical shape."""

    kind: str  # "q8_0"
    raw: np.ndarray  # uint8 [out, row_bytes]
    shape: tuple[int, int]  # (out, in)

    @property
    def ndim(self) -> int:
        return 2


def row_bytes(kind: str, in_dim: int) -> int:
    return (in_dim // QK) * _BLOCK_BYTES[kind]


def split_blocks(qt: QuantTensor):
    """raw Q8_0 blocks -> (q int8 [out, in], d float32 [out, in/32])."""
    if qt.kind != "q8_0":
        raise NotImplementedError(
            f"{qt.kind} blocks are not yet ported (int4 slice of the port)")
    out, k = qt.shape
    nb = k // QK
    blocks = qt.raw.reshape(out, nb, Q8_BLOCK_BYTES)
    d = np.ascontiguousarray(blocks[:, :, :2]).view(np.float16).astype(np.float32)
    qs = np.ascontiguousarray(blocks[:, :, 2:])
    return qs.view(np.int8).reshape(out, k), d.reshape(out, nb)


def dequantize_rows(qt: QuantTensor) -> np.ndarray:
    """Numpy reference dequantization -> f32 [out, in]."""
    q, d = split_blocks(qt)
    out, k = qt.shape
    return (q.astype(np.float32).reshape(out, k // QK, QK)
            * d[..., None]).reshape(out, k)
