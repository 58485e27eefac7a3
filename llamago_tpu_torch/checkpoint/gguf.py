"""GGUF checkpoint reader and writer — llama.cpp-ecosystem model files.

The port's own copy of the JAX package's `checkpoint/gguf.py`; the writer
emits the JAX package's bytes for the same inputs. Virtually every
publicly-distributed quantized LLaMA checkpoint ships as GGUF (llama.cpp's
successor to ggjt). The tensor payloads are the same ggml blocks the port
computes on (checkpoint/quant_file.py: Q8_0/Q4_0/Q4_1), so reading GGUF is
a header/metadata translation: `read_gguf` returns the GGJTCheckpoint the
ggjt reader produces, and everything downstream (loader, engine, kernels,
quantizer) is unchanged. `read_checkpoint` sniffs the magic and
dispatches. Tensor data is memory-mapped, never copied on read.

Format (v2/v3, little-endian):
  u32 magic "GGUF", u32 version, u64 n_tensors, u64 n_kv
  metadata kv: string key, u32 type, value (types below)
  tensor infos: string name, u32 n_dims, u64 dims[n] (dims[0] fastest),
                u32 ggml_type, u64 offset (relative to the data section)
  data section: aligned to metadata["general.alignment"] (default 32)

Name mapping (llama.cpp -> ggjt):
  token_embd.weight -> tok_embeddings.weight, output_norm -> norm,
  blk.N.attn_{q,k,v,output} -> layers.N.attention.w{q,k,v,o},
  blk.N.ffn_{gate,down,up} -> layers.N.feed_forward.w{1,2,3},
  blk.N.{attn_norm,ffn_norm} -> layers.N.{attention_norm,ffn_norm}.
llama.cpp's HF converter un-permutes q/k back to the Meta interleaved
RoPE layout, which is what the model expects (ops/basic.py).

Tokenizers: tokenizer.ggml.model = "llama" (sentencepiece scored pieces,
LLaMA-1/2) uses the reference-parity tokenizer; "gpt2" (byte-level BPE,
LLaMA-3 family) builds a tokenizer_bpe.BPEVocab from tokens + merges with
the file's pre-tokenizer pattern and bos/eos ids. K-quant tensors are
refused with the JAX package's message.
"""

from __future__ import annotations

import struct

import numpy as np

from llamago_tpu_torch.checkpoint.ggjt import (
    GGJTCheckpoint,
    expected_tensor_names,
    read_ggjt,
    write_array,
)
from llamago_tpu_torch.checkpoint.quant_file import QuantTensor, row_bytes
from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.tokenizer import Vocab
from llamago_tpu_torch.tokenizer_bpe import PATTERNS, BPEVocab, bpe_vocab_from_gguf

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL = range(8)
_T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = range(8, 13)
_SCALAR_FMT = {_T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
               _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<?",
               _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d"}

# ggml tensor type -> our kind / numpy dtype
_GGML_F32, _GGML_F16, _GGML_Q4_0, _GGML_Q4_1, _GGML_Q8_0 = 0, 1, 2, 3, 8
_QUANT_KIND = {_GGML_Q4_0: "q4_0", _GGML_Q4_1: "q4_1", _GGML_Q8_0: "q8_0"}

_NAME_MAP = {
    "token_embd.weight": "tok_embeddings.weight",
    "output_norm.weight": "norm.weight",
    "output.weight": "output.weight",
}
_BLK_MAP = {
    "attn_norm.weight": "attention_norm.weight",
    "attn_q.weight": "attention.wq.weight",
    "attn_k.weight": "attention.wk.weight",
    "attn_v.weight": "attention.wv.weight",
    "attn_output.weight": "attention.wo.weight",
    "ffn_norm.weight": "ffn_norm.weight",
    "ffn_gate.weight": "feed_forward.w1.weight",
    "ffn_down.weight": "feed_forward.w2.weight",
    "ffn_up.weight": "feed_forward.w3.weight",
}

# token_type codes (tokenizer.ggml.token_type)
_TOK_NORMAL, _TOK_UNKNOWN, _TOK_CONTROL = 1, 2, 3
_TOK_BYTE = 6


class _Reader:
    def __init__(self, buf: np.memmap):
        self.buf = buf
        self.pos = 0

    def scalar(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def string(self) -> bytes:
        n = self.scalar("<Q")
        s = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return s

    def value(self, vtype: int):
        if vtype in _SCALAR_FMT:
            return self.scalar(_SCALAR_FMT[vtype])
        if vtype == _T_STRING:
            return self.string()
        if vtype == _T_ARRAY:
            etype = self.scalar("<I")
            count = self.scalar("<Q")
            if etype in _SCALAR_FMT:
                fmt = _SCALAR_FMT[etype]
                size = struct.calcsize(fmt)
                arr = np.frombuffer(
                    self.buf, dtype=np.dtype(fmt[1]).newbyteorder("<"),
                    count=count, offset=self.pos,
                ).copy()
                self.pos += size * count
                return arr
            return [self.value(etype) for _ in range(count)]
        raise ValueError(f"unsupported GGUF metadata type {vtype}")


def _map_name(name: str) -> str | None:
    if name in _NAME_MAP:
        return _NAME_MAP[name]
    if name.startswith("blk."):
        _, idx, rest = name.split(".", 2)
        mapped = _BLK_MAP.get(rest)
        if mapped is not None:
            return f"layers.{idx}.{mapped}"
    return None


def _vocab_from_metadata(meta: dict) -> Vocab:
    """GGUF vocab (piece strings + scores + types) -> the ggjt byte-level
    piece conventions (same rules as convert.py:vocab_from_sp_model)."""
    tokens = meta.get("tokenizer.ggml.tokens", [])
    scores = meta.get("tokenizer.ggml.scores",
                      np.zeros(len(tokens), np.float32))
    types = meta.get("tokenizer.ggml.token_type",
                     np.full(len(tokens), _TOK_NORMAL, np.int32))
    out: list[tuple[bytes, float]] = []
    for i, piece in enumerate(tokens):
        text = piece if isinstance(piece, bytes) else str(piece).encode()
        t = int(types[i]) if i < len(types) else _TOK_NORMAL
        if t == _TOK_UNKNOWN:
            text = " ⁇ ".encode()
        elif t == _TOK_CONTROL:
            text = b""
        elif t == _TOK_BYTE:
            # "<0xXX>" pieces -> the raw byte
            s = text.decode("utf-8", "replace")
            text = bytes([int(s[1:-1], 16)]) if s.startswith("<0x") else text
        else:
            text = text.decode("utf-8", "replace").replace("▁", " ").encode()
        out.append((text, float(scores[i]) if i < len(scores) else 0.0))
    return Vocab(out)


def read_gguf(path: str, max_seq_len: int = 1024) -> GGJTCheckpoint:
    """Parse a GGUF v2/v3 file into the common checkpoint structure."""
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    r = _Reader(buf)
    magic = r.scalar("<I")
    if magic != GGUF_MAGIC:
        raise ValueError(f"{path}: bad magic {magic:#x}, want GGUF")
    version = r.scalar("<I")
    if version not in (2, 3):
        raise ValueError(f"{path}: unsupported GGUF version {version}")
    n_tensors = r.scalar("<Q")
    n_kv = r.scalar("<Q")

    meta: dict = {}
    for _ in range(n_kv):
        key = r.string().decode()
        vtype = r.scalar("<I")
        meta[key] = r.value(vtype)


    infos = []
    for _ in range(n_tensors):
        name = r.string().decode()
        n_dims = r.scalar("<I")
        dims = [r.scalar("<Q") for _ in range(n_dims)]
        ggml_type = r.scalar("<I")
        offset = r.scalar("<Q")
        infos.append((name, dims, ggml_type, offset))

    alignment = int(meta.get("general.alignment", 32))
    data_start = (r.pos + alignment - 1) // alignment * alignment

    tensors: dict[str, object] = {}
    ftype = 0
    for name, dims, ggml_type, offset in infos:
        mapped = _map_name(name)
        if mapped is None:
            continue  # rope_freqs etc.
        start = data_start + offset
        in_dim = dims[0]  # dims[0] is the fastest/contiguous dim
        out_dim = int(np.prod(dims[1:])) if len(dims) > 1 else 1
        if ggml_type in _QUANT_KIND:
            kind = _QUANT_KIND[ggml_type]
            rb = row_bytes(kind, in_dim)
            raw = buf[start:start + out_dim * rb].reshape(out_dim, rb)
            tensors[mapped] = QuantTensor(kind=kind, raw=np.asarray(raw),
                                          shape=(out_dim, in_dim))
            ftype = {"q4_0": 2, "q4_1": 3, "q8_0": 7}[kind]
        elif ggml_type in (_GGML_F32, _GGML_F16):
            np_dtype = np.float32 if ggml_type == _GGML_F32 else np.float16
            count = in_dim * out_dim
            data = buf[start:start + count * np_dtype().itemsize].view(np_dtype)
            shape = (out_dim, in_dim) if len(dims) > 1 else (in_dim,)
            tensors[mapped] = data.reshape(shape)
            if ggml_type == _GGML_F16 and ftype == 0:
                ftype = 1
        else:
            raise ValueError(
                f"{path}: tensor {name!r} has unsupported ggml type "
                f"{ggml_type} (supported: F32, F16, Q4_0, Q4_1, Q8_0 — "
                "K-quant GGUFs need requantization, e.g. via llama.cpp)"
            )

    n_layers_meta = int(meta["llama.block_count"])
    if "output.weight" not in tensors and "tok_embeddings.weight" in tensors:
        # tied embeddings: llama.cpp exports (e.g. LLaMA-3.2 1B/3B) omit
        # output.weight and reuse the embedding table as the lm head.
        # Both live [vocab, dim] in this layout, so a direct alias is the
        # correct tie (the loader transposes matmul weights uniformly).
        tensors["output.weight"] = tensors["tok_embeddings.weight"]
    # vocab-only GGUFs (llama.cpp --vocab-only) legitimately carry zero
    # tensors — same allowance as read_ggjt; only a PARTIAL tensor set
    # indicates a broken file
    if tensors:
        missing_names = set(expected_tensor_names(n_layers_meta)) - set(tensors)
        if missing_names:
            raise ValueError(
                f"{path}: missing tensors: {sorted(missing_names)[:5]}"
                f"{'...' if len(missing_names) > 5 else ''}"
            )

    tok_model = meta.get("tokenizer.ggml.model", b"llama")
    tok_model = tok_model.decode() if isinstance(tok_model, bytes) else tok_model
    if tok_model == "gpt2":
        # byte-level BPE (LLaMA-3 family) — own encoder, own bos/eos ids
        vocab = bpe_vocab_from_gguf(meta)
    elif tok_model == "llama":
        vocab = _vocab_from_metadata(meta)
    else:
        raise ValueError(
            f"{path}: unsupported tokenizer.ggml.model={tok_model!r} "
            "(supported: 'llama' sentencepiece, 'gpt2' byte-level BPE)"
        )
    dim = int(meta["llama.embedding_length"])
    n_heads = int(meta["llama.attention.head_count"])
    # embeddings may be padded past the tokenizer list; the optional
    # llama.vocab_size key (or the embedding row count) is authoritative
    emb = tensors.get("tok_embeddings.weight")
    emb_rows = emb.shape[0] if emb is not None else len(vocab)
    config = ModelConfig(
        vocab_size=int(meta.get("llama.vocab_size", emb_rows)),
        dim=dim,
        n_layers=int(meta["llama.block_count"]),
        n_heads=n_heads,
        n_kv_heads=int(meta.get("llama.attention.head_count_kv", n_heads)),
        ffn_dim=int(meta["llama.feed_forward_length"]),
        multiple_of=256,
        max_seq_len=max_seq_len,
        rope_theta=float(meta.get("llama.rope.freq_base", 10000.0)),
        norm_eps=float(meta.get("llama.attention.layer_norm_rms_epsilon", 1e-5)),
        weight_dtype={0: "float32", 1: "bfloat16", 2: "int4", 3: "int4",
                      7: "int8"}.get(ftype, "bfloat16"),
    )
    return GGJTCheckpoint(config=config, vocab=vocab, tensors=tensors,
                          ftype=ftype)


def is_gguf(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(4)
    return len(head) == 4 and struct.unpack("<I", head)[0] == GGUF_MAGIC


def read_checkpoint(path: str, max_seq_len: int = 1024) -> GGJTCheckpoint:
    """Magic-sniffing loader: GGUF or ggjt v1."""
    if is_gguf(path):
        return read_gguf(path, max_seq_len=max_seq_len)
    return read_ggjt(path, max_seq_len=max_seq_len)


def _sp_piece_fields(piece: bytes):
    """ggjt piece conventions -> (GGUF token text, token_type), inverse of
    _vocab_from_metadata so sentencepiece vocabs survive a GGUF
    round-trip (raw byte-fallback pieces become '<0xXX>' BYTE tokens —
    writing them as NORMAL would corrupt them through the reader's
    utf-8 'replace' decode)."""
    if piece == " ⁇ ".encode():
        return b"<unk>", _TOK_UNKNOWN
    if piece == b"":
        return b"", _TOK_CONTROL
    if len(piece) == 1 and piece[0] >= 0x80:
        return f"<0x{piece[0]:02X}>".encode(), _TOK_BYTE
    return piece, _TOK_NORMAL


def _build_kv(config: ModelConfig, vocab, extra_meta: dict | None):
    """Common metadata kv list. `vocab` is the sentencepiece Vocab
    ((bytes, score) pairs — piece types reconstructed) or a BPEVocab
    (model/merges/pre/bos/eos emitted so the tokenizer survives any
    GGUF round-trip); extra_meta entries override (the reader keeps the
    LAST occurrence of a key)."""
    kv: list[tuple[str, int, object]] = [
        ("general.architecture", _T_STRING, b"llama"),
        ("llama.context_length", _T_U32, config.max_seq_len),
        ("llama.vocab_size", _T_U32, config.vocab_size),
        ("llama.embedding_length", _T_U32, config.dim),
        ("llama.block_count", _T_U32, config.n_layers),
        ("llama.attention.head_count", _T_U32, config.n_heads),
        ("llama.attention.head_count_kv", _T_U32, config.kv_heads),
        ("llama.feed_forward_length", _T_U32, config.ffn_hidden),
        ("llama.rope.freq_base", _T_F32, config.rope_theta),
        ("llama.attention.layer_norm_rms_epsilon", _T_F32, config.norm_eps),
    ]
    if isinstance(vocab, BPEVocab):
        merges = [f"{a} {b}".encode() for (a, b), _ in
                  sorted(vocab.merges.items(), key=lambda kv_: kv_[1])]
        # prefer a NAME llama.cpp recognizes when the raw pattern is one
        # of the known ones; raw regexes pass through for our own reader
        pre = vocab.pattern
        for name, pat in PATTERNS.items():
            if pre == pat and name != "default":
                pre = name
                break
        kv += [
            ("tokenizer.ggml.model", _T_STRING, b"gpt2"),
            ("tokenizer.ggml.tokens", _T_ARRAY,
             (_T_STRING, [t.encode() for t in vocab.tokens])),
            ("tokenizer.ggml.merges", _T_ARRAY, (_T_STRING, merges)),
            ("tokenizer.ggml.pre", _T_STRING, pre.encode()),
            ("tokenizer.ggml.bos_token_id", _T_U32, vocab.bos_id),
            ("tokenizer.ggml.eos_token_id", _T_U32, vocab.eos_id),
            ("tokenizer.ggml.token_type", _T_ARRAY,
             (_T_I32, [_TOK_CONTROL if i in vocab.special_ids else _TOK_NORMAL
                       for i in range(len(vocab))])),
        ]
    else:
        texts, types = [], []
        for piece, _ in vocab.tokens:
            t, ty = _sp_piece_fields(piece)
            texts.append(t)
            types.append(ty)
        kv += [
            ("tokenizer.ggml.model", _T_STRING, b"llama"),
            ("tokenizer.ggml.tokens", _T_ARRAY, (_T_STRING, texts)),
            ("tokenizer.ggml.scores", _T_ARRAY,
             (_T_F32, [s for _, s in vocab.tokens])),
            ("tokenizer.ggml.token_type", _T_ARRAY, (_T_I32, types)),
        ]
    if extra_meta:
        kv += [(k, vtype, v) for k, (vtype, v) in extra_meta.items()]
    return kv


def _gguf_name(ggjt_name: str) -> str:
    rev_top = {v: k for k, v in _NAME_MAP.items()}
    rev_blk = {v: k for k, v in _BLK_MAP.items()}
    if ggjt_name in rev_top:
        return rev_top[ggjt_name]
    _, idx, rest = ggjt_name.split(".", 2)
    return f"blk.{idx}.{rev_blk[rest]}"


def _emit_string(f, b: bytes):
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _emit_value(f, vtype: int, v):
    if vtype in _SCALAR_FMT:
        f.write(struct.pack(_SCALAR_FMT[vtype], v))
    elif vtype == _T_STRING:
        _emit_string(f, v)
    elif vtype == _T_ARRAY:
        etype, items = v
        f.write(struct.pack("<IQ", etype, len(items)))
        for it in items:
            _emit_value(f, etype, it)


def write_gguf_header(path: str, config: ModelConfig, vocab, infos,
                      extra_meta: dict | None = None,
                      sizes: list[int] | None = None) -> list[int]:
    """Write a complete GGUF v3 header for tensors whose DATA will be
    streamed in afterwards. `infos` = [(ggjt_name, ne, ggml_type)],
    `sizes` = payload byte lengths. Reserves the data region and returns
    each tensor's absolute file offset (for seek-writes by the streaming
    converters)."""
    kv = _build_kv(config, vocab, extra_meta)
    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", GGUF_MAGIC, 3, len(infos), len(kv)))
        for key, vtype, v in kv:
            _emit_string(f, key.encode())
            f.write(struct.pack("<I", vtype))
            _emit_value(f, vtype, v)
        offsets = []
        rel = 0
        for (name, ne, ggml_type), nbytes in zip(infos, sizes):
            _emit_string(f, _gguf_name(name).encode())
            f.write(struct.pack("<I", len(ne)))
            for d in ne:
                f.write(struct.pack("<Q", d))
            rel = (rel + 31) // 32 * 32
            f.write(struct.pack("<IQ", ggml_type, rel))
            offsets.append(rel)
            rel += nbytes
        pos = f.tell()
        data_start = (pos + 31) // 32 * 32
        f.write(b"\x00" * (data_start - pos))
        f.seek(data_start + rel - 1)
        f.write(b"\x00")  # reserve the data region
    return [data_start + o for o in offsets]


def write_gguf(path: str, config: ModelConfig, vocab, tensors: dict,
               extra_meta: dict | None = None) -> None:
    """GGUF v3 writer. Tensors are the ggjt structures: numpy [out, in] / [n]
    float32 or float16 arrays, or QuantTensor. Thin wrapper over
    write_gguf_header + one seek-write a payload, straight from each
    array's memory (a multi-GB file is never assembled in RAM)."""
    infos, payloads = [], []
    for name, arr in tensors.items():
        if isinstance(arr, QuantTensor):
            ggml_type = {"q4_0": _GGML_Q4_0, "q4_1": _GGML_Q4_1,
                         "q8_0": _GGML_Q8_0}[arr.kind]
            ne = [arr.shape[1], arr.shape[0]]
            data = np.ascontiguousarray(arr.raw)
        else:
            data = np.ascontiguousarray(arr)
            if data.dtype not in (np.float32, np.float16):
                raise ValueError(f"{name}: GGUF tensors are float32, float16 or "
                                 f"quantized blocks, not {data.dtype}")
            ggml_type = _GGML_F32 if data.dtype == np.float32 else _GGML_F16
            ne = list(reversed(data.shape))
        infos.append((name, ne, ggml_type))
        payloads.append(data)
    offsets = write_gguf_header(path, config, vocab, infos, extra_meta=extra_meta,
                                sizes=[p.nbytes for p in payloads])
    with open(path, "r+b") as f:
        for off, data in zip(offsets, payloads):
            f.seek(off)
            write_array(f, data)
