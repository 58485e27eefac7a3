"""ggml-bit-compatible Q8_0 / Q4_0 / Q4_1 tensor blocks in ggjt and GGUF files.

The port's own copy of the JAX package's `checkpoint/quant_file.py`, with
llama.cpp's exact bit layout so files interoperate both ways:

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

The quantizers give the JAX package's bytes. The hot loops dispatch to the
native C++ library (native/) when g++ can build it, with these numpy
versions as the reference and fallback; both give the same bytes.
`quantize_ggjt` is the `quantize` subcommand.
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


def quantize_rows_q8_0(x: np.ndarray) -> np.ndarray:
    """f32/f16 [out, in] -> uint8 [out, in//32 * 34] (numpy reference)."""
    out, k = x.shape
    nb = k // QK
    xb = np.ascontiguousarray(x, np.float32).reshape(out, nb, QK)
    absmax = np.abs(xb).max(axis=-1)
    d = (absmax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1), 0.0)
    q = np.clip(np.rint(xb * inv[..., None]), -127, 127).astype(np.int8)
    blocks = np.empty((out, nb, Q8_BLOCK_BYTES), np.uint8)
    blocks[:, :, :2] = d.astype(np.float16)[..., None].view(np.uint8)
    blocks[:, :, 2:] = q.view(np.uint8)
    return blocks.reshape(out, nb * Q8_BLOCK_BYTES)


def quantize_rows_q4_0(x: np.ndarray) -> np.ndarray:
    """Q4_0 blocks, ggml's sign trick: d = signed absmax / -8, nibble =
    round(x / d) + 8 clipped to [0, 15] (numpy reference)."""
    out, k = x.shape
    nb = k // QK
    xb = np.ascontiguousarray(x, np.float32).reshape(out, nb, QK)
    idx = np.abs(xb).argmax(axis=-1)
    signed_max = np.take_along_axis(xb, idx[..., None], axis=-1)[..., 0]
    d = (signed_max / -8.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0.0)
    q = np.clip(np.rint(xb * inv[..., None]) + 8, 0, 15).astype(np.uint8)
    packed = q[:, :, :16] | (q[:, :, 16:] << 4)
    blocks = np.empty((out, nb, Q4_BLOCK_BYTES), np.uint8)
    blocks[:, :, :2] = d.astype(np.float16)[..., None].view(np.uint8)
    blocks[:, :, 2:] = packed
    return blocks.reshape(out, nb * Q4_BLOCK_BYTES)


def quantize_rows_q4_1(x: np.ndarray) -> np.ndarray:
    """Q4_1 affine blocks: x ~ nibble*d + m (numpy only: the native library
    has no Q4_1 path)."""
    out, k = x.shape
    nb = k // QK
    xb = np.ascontiguousarray(x, np.float32).reshape(out, nb, QK)
    mn = xb.min(axis=-1)
    mx = xb.max(axis=-1)
    d = ((mx - mn) / 15.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0.0)
    q = np.clip(np.rint((xb - mn[..., None]) * inv[..., None]), 0, 15).astype(np.uint8)
    packed = q[:, :, :16] | (q[:, :, 16:] << 4)
    blocks = np.empty((out, nb, Q41_BLOCK_BYTES), np.uint8)
    blocks[:, :, :2] = d.astype(np.float16)[..., None].view(np.uint8)
    blocks[:, :, 2:4] = mn.astype(np.float16)[..., None].view(np.uint8)
    blocks[:, :, 4:] = packed
    return blocks.reshape(out, nb * Q41_BLOCK_BYTES)


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


def to_device_leaf(qt: QuantTensor, device) -> dict:
    """File blocks ([out, in] row-major) -> a quantized leaf of torch tensors
    on `device` ({q8 int8 [in, out] | q4 uint8 [in/2, out], s f32 [in/32,
    out]}, and m for Q4_1; ops/quant.py). The nibble pairing matches, so
    this is a transpose. The raw blocks cross to the device as bytes and
    are split and transposed there (split_blocks's bits: the f16 scales
    widen exactly), so a multi-GB file loads at the copy's rate. The device
    is explicit: "cuda" or "cpu"."""
    import torch

    from llamago_tpu_torch.utils.device import resolve_device

    out, k = qt.shape
    nb = k // QK
    raw = np.asarray(qt.raw)
    raw = np.ascontiguousarray(raw) if raw.flags.writeable else raw.copy()  # a file mapping
    blocks = torch.from_numpy(raw).to(resolve_device(device)).view(out, nb, -1)

    def half(at):  # the f16 field at byte `at` of every block, as f32 [nb, out]
        f16 = blocks[:, :, at:at + 2].contiguous().view(torch.float16)
        return f16.reshape(out, nb).float().T.contiguous()

    qs = blocks[:, :, (4 if qt.kind == "q4_1" else 2):].contiguous()
    if qt.kind == "q8_0":
        leaf = {"q8": qs.view(torch.int8).reshape(out, k).T.contiguous()}
    else:
        leaf = {"q4": qs.reshape(out, k // 2).T.contiguous()}
    leaf["s"] = half(0)
    if qt.kind == "q4_1":
        leaf["m"] = half(2)
    return leaf


_MATMUL_MARKERS = (".wq.", ".wk.", ".wv.", ".wo.", ".w1.", ".w2.", ".w3.")


def quantize_ggjt(in_path: str, out_path: str, kind: str = "q8_0") -> str:
    """ggjt or GGUF f32/f16 -> ggjt with Q8_0 / Q4_0 / Q4_1 matmul weights,
    or -> GGUF when `out_path` ends in .gguf (the `quantize` subcommand).
    Norms and embeddings stay dense, and so does a matmul whose in-dim is no
    multiple of 32 (quantizing it would drop its trailing elements). A
    byte-level BPE model must be written to .gguf: ggjt's scored-piece
    vocab cannot carry merges. ftype codes follow llama.cpp: 2 = mostly
    Q4_0, 3 = mostly Q4_1, 7 = mostly Q8_0; the sidecar carries what the
    ggjt v1 header cannot (rope_theta, norm_eps)."""
    from llamago_tpu_torch.checkpoint.ggjt import write_ggjt, write_meta_sidecar
    from llamago_tpu_torch.checkpoint.gguf import read_checkpoint, write_gguf
    from llamago_tpu_torch.tokenizer_bpe import BPEVocab

    ckpt = read_checkpoint(in_path)
    out: dict = {}
    for name, arr in ckpt.tensors.items():
        is_mat = name == "output.weight" or any(m in name for m in _MATMUL_MARKERS)
        if isinstance(arr, QuantTensor):
            out[name] = arr  # already quantized
        elif is_mat and getattr(arr, "ndim", 0) == 2 and arr.shape[1] % QK == 0:
            out[name] = quantize_array(np.asarray(arr, np.float32), kind)
        else:
            out[name] = np.asarray(arr)
    if isinstance(ckpt.vocab, BPEVocab) and not out_path.endswith(".gguf"):
        raise ValueError(
            "BPE-tokenizer models must quantize to a .gguf output "
            "(ggjt's scored-piece vocab cannot carry BPE merges)")
    if out_path.endswith(".gguf"):
        write_gguf(out_path, ckpt.config, ckpt.vocab, out)
        return out_path
    write_ggjt(out_path, ckpt.config, ckpt.vocab, out,
               ftype={"q8_0": 7, "q4_0": 2, "q4_1": 3}[kind])
    write_meta_sidecar(out_path, ckpt.config)
    return out_path


def quantize_array(x: np.ndarray, kind: str) -> QuantTensor:
    """Quantize a dense [out, in] array into file blocks (native C++ when
    available, numpy otherwise; the same bytes)."""
    from llamago_tpu_torch import native

    fn = native.quantize_rows(kind)  # the native path covers q8_0 and q4_0
    if fn is None:
        fn = {"q8_0": quantize_rows_q8_0, "q4_0": quantize_rows_q4_0,
              "q4_1": quantize_rows_q4_1}[kind]
    return QuantTensor(kind=kind, raw=fn(x), shape=tuple(x.shape))
