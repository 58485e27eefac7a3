"""ggjt v1 checkpoint reader (numpy only).

The port's own copy of the reading half of the JAX package's
`checkpoint/ggjt.py` (reference loader: pkg/llama/llama.go:712-976):

  header:  int32 magic 0x67676a74 ('ggjt'), int32 version 1,
           int32 vocab_size, dim, multiple_of, n_heads, n_layers,
           rot (= dim // n_heads, obsolete), ftype (0=f32, 1=f16)
  vocab:   vocab_size x { int32 len, len bytes piece, f32 score }
  tensors: repeated { int32 n_dims (1|2), int32 name_len, int32 dtype,
                      int32 ne[n_dims]  (ne[0] = contiguous/fastest dim),
                      name bytes, pad to 32-byte file alignment,
                      raw data } until EOF

A 2-D tensor with file dims ne=[in, out] is row-major [out, in] as a numpy
array. F32, F16, Q8_0, Q4_0 and Q4_1 tensors load; GGUF files belong to the
GGUF/BPE slice of the port.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass

import numpy as np

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.tokenizer import Vocab

GGJT_MAGIC = 0x67676A74
GGJT_VERSION = 1
GGUF_MAGIC = 0x46554747  # b"GGUF" read as little-endian int32
ALIGNMENT = 32

DTYPE_F32 = 0
DTYPE_F16 = 1
DTYPE_Q4_0 = 2
DTYPE_Q4_1 = 3
DTYPE_Q8_0 = 8
_DTYPE_TO_NP = {DTYPE_F32: np.float32, DTYPE_F16: np.float16}
_QUANT_KINDS = {DTYPE_Q4_0: "q4_0", DTYPE_Q4_1: "q4_1", DTYPE_Q8_0: "q8_0"}


@dataclass
class GGJTCheckpoint:
    config: ModelConfig
    vocab: Vocab
    # name -> numpy array in the file's row-major layout ([out, in] for
    # 2-D weights, f32 or f16) or a quant_file.QuantTensor
    tensors: dict
    ftype: int = 0


def expected_tensor_names(n_layers: int) -> list[str]:
    """The full tensor name set (reference: pkg/llama/llama.go:819-863)."""
    names = ["tok_embeddings.weight", "norm.weight", "output.weight"]
    for i in range(n_layers):
        p = f"layers.{i}."
        names += [p + s for s in (
            "attention_norm.weight", "attention.wq.weight", "attention.wk.weight",
            "attention.wv.weight", "attention.wo.weight", "ffn_norm.weight",
            "feed_forward.w1.weight", "feed_forward.w2.weight",
            "feed_forward.w3.weight")]
    return names


def read_ggjt(path: str, max_seq_len: int = 1024) -> GGJTCheckpoint:
    """Parse a ggjt v1 file; tensor data is memory-mapped and sliced."""
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    pos = 0

    def read_i32() -> int:
        nonlocal pos
        (v,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        return v

    magic = read_i32()
    if magic == GGUF_MAGIC:
        raise NotImplementedError(
            f"{path}: GGUF files are not yet ported (GGUF/BPE slice of the "
            "port); convert to ggjt or use the JAX package")
    if magic != GGJT_MAGIC:
        raise ValueError(f"{path}: bad magic {magic:#x}, want {GGJT_MAGIC:#x} ('ggjt')")
    version = read_i32()
    if version != GGJT_VERSION:
        raise ValueError(f"{path}: unsupported ggjt version {version}")

    vocab_size = read_i32()
    dim = read_i32()
    multiple_of = read_i32()
    n_heads = read_i32()
    n_layers = read_i32()
    _rot = read_i32()  # obsolete (= dim // n_heads)
    ftype = read_i32()

    tokens: list[tuple[bytes, float]] = []
    for _ in range(vocab_size):
        n = read_i32()
        piece = bytes(buf[pos: pos + n])
        pos += n
        (score,) = struct.unpack_from("<f", buf, pos)
        pos += 4
        tokens.append((piece, score))
    vocab = Vocab(tokens)

    tensors: dict = {}
    total = len(buf)
    while pos + 12 <= total:
        n_dims = read_i32()
        if n_dims < 1 or n_dims > 2:
            raise ValueError(f"{path}: bad tensor n_dims={n_dims} at offset {pos - 4}")
        name_len = read_i32()
        dtype = read_i32()
        ne = [read_i32() for _ in range(n_dims)]
        name = bytes(buf[pos: pos + name_len]).decode("utf-8")
        pos += name_len
        pos = (pos + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT

        if dtype in _QUANT_KINDS:
            from llamago_tpu_torch.checkpoint.quant_file import QuantTensor, row_bytes

            kind = _QUANT_KINDS[dtype]
            in_dim, out_dim = ne[0], (ne[1] if n_dims == 2 else 1)
            rb = row_bytes(kind, in_dim)
            nbytes = out_dim * rb
            raw = buf[pos: pos + nbytes].reshape(out_dim, rb)
            pos += nbytes
            tensors[name] = QuantTensor(kind=kind, raw=np.asarray(raw),
                                        shape=(out_dim, in_dim))
            continue
        np_dtype = _DTYPE_TO_NP.get(dtype)
        if np_dtype is None:
            raise ValueError(f"{path}: tensor '{name}' has unsupported dtype {dtype}")
        count = int(np.prod(ne))
        nbytes = count * np.dtype(np_dtype).itemsize
        data = buf[pos: pos + nbytes].view(np_dtype)
        pos += nbytes
        tensors[name] = data.reshape(tuple(reversed(ne)))

    if tensors:
        missing = set(expected_tensor_names(n_layers)) - set(tensors)
        if missing:
            raise ValueError(f"{path}: missing tensors: {sorted(missing)[:5]}...")

    # ftype -> weight storage (llama.cpp codes: 0 f32, 1 f16, 2 Q4_0,
    # 3 Q4_1, 7 Q8_0)
    weight_dtype = {0: "float32", 1: "bfloat16", 2: "int4", 3: "int4",
                    7: "int8"}.get(ftype, "bfloat16")
    # The v1 header predates GQA and non-default RoPE: n_kv_heads and the
    # FFN width are inferred from tensor shapes, and rope_theta/norm_eps
    # ride an optional `<model>.meta.json` sidecar.
    head_dim = dim // n_heads
    n_kv_heads = None
    ffn_dim = None
    wk = tensors.get("layers.0.attention.wk.weight")
    if wk is not None:
        kv_out = wk.shape[0]
        if kv_out % head_dim == 0 and kv_out // head_dim != n_heads:
            n_kv_heads = kv_out // head_dim
    w1 = tensors.get("layers.0.feed_forward.w1.weight")
    if w1 is not None:
        ffn_dim = int(w1.shape[0])
    extra = read_meta_sidecar(path)
    config = ModelConfig(
        vocab_size=vocab_size, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv_heads, ffn_dim=ffn_dim, multiple_of=multiple_of,
        max_seq_len=max_seq_len, weight_dtype=weight_dtype,
        rope_theta=float(extra.get("rope_theta", 10000.0)),
        norm_eps=float(extra.get("norm_eps", 1e-5)),
    )
    return GGJTCheckpoint(config=config, vocab=vocab, tensors=tensors, ftype=ftype)


def read_meta_sidecar(path: str) -> dict:
    """Optional `<model>.bin.meta.json` with fields the v1 header cannot
    carry (rope_theta, norm_eps)."""
    p = path + ".meta.json"
    if not os.path.exists(p):
        return {}
    with open(p, encoding="utf-8") as f:
        return json.load(f)
