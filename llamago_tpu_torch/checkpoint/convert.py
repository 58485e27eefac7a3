"""Offline checkpoint converter: PyTorch/HF LLaMA -> ggjt v1 or GGUF.

The port's own copy of the JAX package's `checkpoint/convert.py`, writing
the same bytes for the same inputs. It re-implements the reference
converter's behavior (reference: scripts/convert-pth-to-ggml.py):

  * Meta-format checkpoints (params.json + consolidated.NN.pth +
    ../tokenizer.model), read with torch.load(weights_only=True),
    including multi-part TP-shard reassembly — n_parts by dim {4096:1,
    5120:2, 6656:4, 8192:8} (:84-92), split along out_features for
    output/wq/wk/wv/w1/w3 and along the other dim for
    tok_embeddings/wo/w2 (:161-188);
  * scored vocab with unknown/control/byte piece handling (:120-137);
  * ftype 0 (f32) / 1 (f16 for 2-D tensors, f32 for 1-D, :152-157);
  * vocab-only mode (:243-252).

Beyond the reference:
  * HuggingFace LLaMA checkpoints (transformers layout; `safetensors` and
    `transformers` are imported only by the functions that read them): q/k
    weights are stored permuted for the rotate-half RoPE and are
    un-permuted back to the interleaved-pair layout ggjt expects;
  * LLaMA-3-family HF checkpoints (tokenizer.json BPE) convert to GGUF,
    the only container here that carries BPE merges.
Quantization is the `quantize` subcommand (checkpoint/quant_file.py).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from llamago_tpu_torch.checkpoint import gguf as G
from llamago_tpu_torch.checkpoint.ggjt import (
    DTYPE_F16,
    DTYPE_F32,
    write_ggjt,
    write_header_and_vocab,
    write_meta_sidecar,
    write_tensor_meta,
)
from llamago_tpu_torch.checkpoint.sp_model import read_sp_model
from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.tokenizer import Vocab
from llamago_tpu_torch.tokenizer_bpe import bpe_vocab_from_tokenizer_json

# split dim when reassembling Meta TP shards, by tensor-name rule
# (reference: scripts/convert-pth-to-ggml.py:161-188)
_SPLIT_DIM0 = ("output.weight", ".wq.", ".wk.", ".wv.", ".w1.", ".w3.")
_SPLIT_DIM1 = ("tok_embeddings", ".wo.", ".w2.")

_N_PARTS = {4096: 1, 5120: 2, 6656: 4, 8192: 8}


def split_dim_for(name: str) -> int:
    if any(k in name for k in _SPLIT_DIM0):
        return 0
    if any(k in name for k in _SPLIT_DIM1):
        return 1
    return -1  # replicated (1-D tensors)


def vocab_from_sp_model(path: str) -> Vocab:
    """Scored vocab with the ggjt piece conventions (reference:
    write_tokens, convert-pth-to-ggml.py:120-137)."""
    tokens: list[tuple[bytes, float]] = []
    for p in read_sp_model(path):
        if p.is_unknown:
            text = " ⁇ ".encode()
        elif p.is_control:
            text = b""
        elif p.is_byte:
            text = bytes([p.byte_value()])
        else:
            text = p.piece.replace("▁", " ").encode()
        tokens.append((text, p.score))
    return Vocab(tokens)


def _coerce(arr: np.ndarray, ftype: int) -> np.ndarray:
    # 1-D tensors stay f32 even at ftype 1 (reference :152-157)
    if ftype == 0 or arr.ndim == 1:
        return arr.astype(np.float32)
    return arr.astype(np.float16)


def _load_part(dir_model: str, part: int):
    """One consolidated.NN.pth, memory-mapped when the file format allows
    (zip-serialized, torch>=1.6) so tensors page in lazily and peak RSS
    stays ~one write-chunk, not one part."""
    import torch

    path = os.path.join(dir_model, f"consolidated.{part:02d}.pth")
    try:
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except (RuntimeError, ValueError):  # legacy non-zip serialization
        return torch.load(path, map_location="cpu", weights_only=True)


def load_meta_checkpoint(dir_model: str) -> tuple[dict, dict[str, np.ndarray]]:
    """Load Meta-format LLaMA weights, reassembling TP shards (in RAM —
    use stream_meta_to_ggjt for conversion; this exists for callers that
    want the tensors themselves)."""
    with open(os.path.join(dir_model, "params.json")) as f:
        hparams = json.load(f)
    n_parts = _N_PARTS.get(hparams["dim"])
    if n_parts is None:
        raise ValueError(f"unknown model dim {hparams['dim']}")

    merged: dict[str, list[np.ndarray]] = {}
    for part in range(n_parts):
        state = _load_part(dir_model, part)
        for name, t in state.items():
            if name.endswith("freqs"):
                continue
            merged.setdefault(name, []).append(t.float().numpy().copy())
        del state

    tensors: dict[str, np.ndarray] = {}
    for name, parts in merged.items():
        if len(parts) == 1 or parts[0].ndim != 2:
            # replicated across parts (1-D norms): part 0 only
            # (reference skips dim-1 tensors for part_id > 0, :207-213)
            tensors[name] = np.squeeze(parts[0])
        else:
            dim = split_dim_for(name)
            tensors[name] = np.concatenate(parts, axis=dim)
    return hparams, tensors


_CHUNK_BYTES = 64 << 20  # streaming write granularity (peak-RSS bound)


def stream_meta_to_ggjt(
    dir_model: str,
    out_path: str,
    config: ModelConfig,
    vocab: Vocab,
    ftype: int,
    hparams: dict | None = None,
) -> None:
    """Convert a multi-part Meta checkpoint in CONSTANT memory.

    The reference streams each part's tensors to their final file offsets
    with seek-writes and never holds more than one part in RAM
    (reference: scripts/convert-pth-to-ggml.py:207-232, part loop
    :268-273). This goes further: parts are memory-mapped and copied in
    <=64 MB chunks, so peak RSS is ~one chunk regardless of model size
    (a 65B f32 conversion no longer needs ~260 GB of host RAM).

    Layout pass: part 0's shapes give every tensor's GLOBAL shape
    (split dim x n_parts, rules at :161-188); headers are written and
    data ranges reserved. Data pass: for each part, dim-0 splits land as
    one contiguous block at their row offset; dim-1 splits seek-write
    each row's column slice (same access pattern the reference uses).
    """
    if hparams is None:
        with open(os.path.join(dir_model, "params.json")) as f:
            hparams = json.load(f)
    n_parts = _N_PARTS.get(hparams["dim"])
    if n_parts is None:
        raise ValueError(f"unknown model dim {hparams['dim']}")

    part0 = _load_part(dir_model, 0)
    # ---- layout pass: name -> (data offset, global np shape, np dtype, split)
    layout: dict[str, tuple[int, tuple[int, ...], np.dtype, int]] = {}
    with open(out_path, "wb") as f:
        write_header_and_vocab(f, config, vocab, ftype)
        for name, t in part0.items():
            if name.endswith("freqs"):
                continue
            pshape = tuple(s for s in t.shape if s != 1) or (1,)
            split = split_dim_for(name) if (len(pshape) == 2 and n_parts > 1) else -1
            gshape = list(pshape)
            if split >= 0:
                gshape[split] *= n_parts
            gshape = tuple(gshape)
            np_dtype = np.dtype(
                np.float16 if (ftype == 1 and len(gshape) == 2) else np.float32
            )
            dtype_code = DTYPE_F16 if np_dtype == np.float16 else DTYPE_F32
            write_tensor_meta(f, name, len(gshape), list(reversed(gshape)),
                              dtype_code)
            off = f.tell()
            layout[name] = (off, gshape, np_dtype, split)
            f.seek(int(np.prod(gshape)) * np_dtype.itemsize, os.SEEK_CUR)
        f.truncate()

    # ---- data pass: one part resident (mmap-backed) at a time
    state = part0
    with open(out_path, "r+b") as f:
        for part in range(n_parts):
            if part > 0:
                state = _load_part(dir_model, part)
            for name, (off, gshape, np_dtype, split) in layout.items():
                t = state[name]
                while t.dim() > len(gshape):
                    t = t.squeeze()
                if split == -1:
                    if part > 0:  # replicated: written once, from part 0
                        continue
                    _write_rows(f, t, off, np_dtype)
                elif split == 0:
                    rows = t.shape[0]
                    row_bytes = t.shape[1] * np_dtype.itemsize
                    _write_rows(f, t, off + part * rows * row_bytes, np_dtype)
                else:  # split == 1: column slice of every global row
                    rows, pcols = t.shape
                    grow_bytes = gshape[1] * np_dtype.itemsize
                    col_off = part * pcols * np_dtype.itemsize
                    chunk_rows = max(1, _CHUNK_BYTES // (pcols * np_dtype.itemsize))
                    for r0 in range(0, rows, chunk_rows):
                        block = t[r0:r0 + chunk_rows].float().numpy()
                        block = np.ascontiguousarray(block, dtype=np_dtype)
                        for i in range(block.shape[0]):
                            f.seek(off + (r0 + i) * grow_bytes + col_off)
                            f.write(block[i].tobytes())
            del state
            state = None


def _write_rows(f, t, start_off: int, np_dtype) -> None:
    """Contiguous chunked write of a torch tensor at a file offset."""
    flat_rows = t.shape[0] if t.dim() > 1 else 1
    per_row = (int(np.prod(t.shape[1:])) if t.dim() > 1 else t.shape[0])
    rb = per_row * np_dtype.itemsize
    chunk_rows = max(1, _CHUNK_BYTES // rb)
    f.seek(start_off)
    t2 = t.reshape(flat_rows, per_row)
    for r0 in range(0, flat_rows, chunk_rows):
        block = t2[r0:r0 + chunk_rows].float().numpy()
        f.write(np.ascontiguousarray(block, dtype=np_dtype).tobytes())


_HF_MAP = {
    "model.embed_tokens.weight": "tok_embeddings.weight",
    "model.norm.weight": "norm.weight",
    "lm_head.weight": "output.weight",
}
_HF_LAYER_MAP = {
    "input_layernorm.weight": "attention_norm.weight",
    "self_attn.q_proj.weight": "attention.wq.weight",
    "self_attn.k_proj.weight": "attention.wk.weight",
    "self_attn.v_proj.weight": "attention.wv.weight",
    "self_attn.o_proj.weight": "attention.wo.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
    "mlp.gate_proj.weight": "feed_forward.w1.weight",
    "mlp.down_proj.weight": "feed_forward.w2.weight",
    "mlp.up_proj.weight": "feed_forward.w3.weight",
}


def unpermute_hf_rope(w: np.ndarray, n_heads: int) -> np.ndarray:
    """HF stores q/k projections permuted for rotate-half RoPE; restore the
    Meta/ggml interleaved-pair layout: inverse of
    w.reshape(h, hd//2, 2, in) <- w.reshape(h, 2, hd//2, in).swapaxes(1, 2)."""
    out, inner = w.shape
    hd = out // n_heads
    return (
        w.reshape(n_heads, 2, hd // 2, inner).swapaxes(1, 2).reshape(out, inner)
    )


def load_hf_checkpoint(dir_model: str) -> tuple[dict, dict[str, np.ndarray]]:
    """Load a HuggingFace-format LLaMA checkpoint into ggjt naming/layout."""
    import torch
    from transformers import AutoConfig, AutoModelForCausalLM

    hf_config = AutoConfig.from_pretrained(dir_model)
    model = AutoModelForCausalLM.from_pretrained(
        dir_model, torch_dtype=torch.float32, low_cpu_mem_usage=True
    )
    state = model.state_dict()
    n_heads = hf_config.num_attention_heads
    n_kv = getattr(hf_config, "num_key_value_heads", n_heads)
    tensors: dict[str, np.ndarray] = {}
    for name, t in state.items():
        arr = t.to(torch.float32).numpy()
        if name in _HF_MAP:
            tensors[_HF_MAP[name]] = arr
            continue
        if not name.startswith("model.layers."):
            continue
        _, _, idx, rest = name.split(".", 3)
        mapped = _HF_LAYER_MAP.get(rest)
        if mapped is None:
            continue
        if "q_proj" in rest:
            arr = unpermute_hf_rope(arr, n_heads)
        elif "k_proj" in rest:
            arr = unpermute_hf_rope(arr, n_kv)
        tensors[f"layers.{idx}.{mapped}"] = arr
    if "output.weight" not in tensors:  # tied embeddings
        tensors["output.weight"] = tensors["tok_embeddings.weight"].copy()
    hparams = {
        "dim": hf_config.hidden_size,
        "n_heads": n_heads,
        "n_kv_heads": n_kv,
        "n_layers": hf_config.num_hidden_layers,
        "vocab_size": hf_config.vocab_size,
        "multiple_of": 256,
        "ffn_dim": hf_config.intermediate_size,
        "rope_theta": getattr(hf_config, "rope_theta", 10000.0),
        "norm_eps": hf_config.rms_norm_eps,
    }
    return hparams, tensors


def hf_hparams(dir_model: str) -> dict:
    """hparams straight from config.json (no transformers import)."""
    with open(os.path.join(dir_model, "config.json")) as f:
        hf = json.load(f)
    n_heads = hf["num_attention_heads"]
    return {
        "dim": hf["hidden_size"],
        "n_heads": n_heads,
        "n_kv_heads": hf.get("num_key_value_heads", n_heads),
        "n_layers": hf["num_hidden_layers"],
        "vocab_size": hf["vocab_size"],
        "multiple_of": 256,
        "ffn_dim": hf["intermediate_size"],
        "rope_theta": hf.get("rope_theta", 10000.0),
        "norm_eps": hf.get("rms_norm_eps", 1e-5),
        "tie_word_embeddings": hf.get("tie_word_embeddings", False),
        "bos_token_id": _first_id(hf.get("bos_token_id"), 0),
        "eos_token_id": _first_id(hf.get("eos_token_id"), 1),
    }


def _first_id(v, default: int) -> int:
    """Token-id config fields may be an int, a LIST of ints (LLaMA-3.x
    Instruct eos_token_id), or absent; 0 is a valid id."""
    if isinstance(v, list):
        return int(v[0]) if v else default
    return default if v is None else int(v)


def _hf_safetensor_files(dir_model: str) -> list[str]:
    idx = os.path.join(dir_model, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted({os.path.join(dir_model, v) for v in weight_map.values()})
    single = os.path.join(dir_model, "model.safetensors")
    return [single] if os.path.exists(single) else []


def _map_hf_name(name: str) -> str | None:
    if name in _HF_MAP:
        return _HF_MAP[name]
    if name.startswith("model.layers."):
        _, _, idx, rest = name.split(".", 3)
        mapped = _HF_LAYER_MAP.get(rest)
        if mapped is not None:
            return f"layers.{idx}.{mapped}"
    return None


def stream_hf_to_ggjt(
    dir_model: str,
    out_path: str,
    config: ModelConfig,
    vocab: Vocab,
    ftype: int,
    hparams: dict,
) -> None:
    """Convert an HF safetensors checkpoint in CONSTANT memory: one
    tensor at a time via safetensors' lazy slicing (the legacy path
    materializes the whole model through transformers — a 70B f32
    conversion would need ~280 GB of host RAM). q/k projections are
    un-permuted back to the interleaved-pair RoPE layout on the way."""
    import torch
    from safetensors import safe_open

    files = _hf_safetensor_files(dir_model)
    n_heads = hparams["n_heads"]
    n_kv = hparams["n_kv_heads"]
    emb_location: tuple[str, str] | None = None
    wrote_lm_head = False

    def coerced(arr):
        return _coerce(np.asarray(arr), ftype)

    def get_np(sf, name):
        # torch framework handles bf16 checkpoints (numpy cannot)
        return sf.get_tensor(name).to(torch.float32).numpy()

    with open(out_path, "wb") as f:
        write_header_and_vocab(f, config, vocab, ftype)
        for path in files:
            with safe_open(path, framework="pt") as sf:
                for hf_name in sf.keys():
                    mapped = _map_hf_name(hf_name)
                    if mapped is None:
                        continue
                    arr = get_np(sf, hf_name)
                    if "q_proj" in hf_name:
                        arr = unpermute_hf_rope(arr, n_heads)
                    elif "k_proj" in hf_name:
                        arr = unpermute_hf_rope(arr, n_kv)
                    if mapped == "tok_embeddings.weight":
                        emb_location = (path, hf_name)
                    if mapped == "output.weight":
                        wrote_lm_head = True
                    arr = coerced(arr)
                    write_tensor_meta(f, mapped, arr.ndim,
                                      list(reversed(arr.shape)),
                                      1 if arr.dtype == np.float16 else 0)
                    f.write(np.ascontiguousarray(arr).tobytes())
        if not wrote_lm_head:
            # tied embeddings: re-read the table rather than keeping it
            if emb_location is None:
                raise ValueError("no lm_head and no embeddings found")
            path, hf_name = emb_location
            with safe_open(path, framework="pt") as sf:
                arr = coerced(get_np(sf, hf_name))
            write_tensor_meta(f, "output.weight", arr.ndim,
                              list(reversed(arr.shape)),
                              1 if arr.dtype == np.float16 else 0)
            f.write(np.ascontiguousarray(arr).tobytes())


def stream_hf_to_gguf(
    dir_model: str,
    out_path: str,
    config: ModelConfig,
    hparams: dict,
    ftype: int,
) -> None:
    """HF safetensors (LLaMA-3 family: tokenizer.json BPE, no
    tokenizer.model) -> GGUF, in constant memory. GGUF is the right
    container here because ggjt's scored-piece vocab cannot carry BPE
    merges. Two passes: shapes via safetensors lazy slices build the
    header; tensors then stream one at a time (q/k un-permuted, f16
    coercion per the ftype policy)."""
    import torch
    from safetensors import safe_open

    vocab = bpe_vocab_from_tokenizer_json(
        os.path.join(dir_model, "tokenizer.json"),
        bos_id=int(hparams.get("bos_token_id", 0)),
        eos_id=int(hparams.get("eos_token_id", 1)),
    )
    files = _hf_safetensor_files(dir_model)
    n_heads, n_kv = hparams["n_heads"], hparams["n_kv_heads"]

    # ---- pass 1: names + shapes (+ tied-embedding bookkeeping)
    entries: list[tuple[str, str, str, list[int]]] = []  # file, hf, mapped, shape
    emb_entry = None
    has_lm_head = False
    for path in files:
        with safe_open(path, framework="pt") as sf:
            for hf_name in sf.keys():
                mapped = _map_hf_name(hf_name)
                if mapped is None:
                    continue
                shape = list(sf.get_slice(hf_name).get_shape())
                entries.append((path, hf_name, mapped, shape))
                if mapped == "tok_embeddings.weight":
                    emb_entry = (path, hf_name, shape)
                if mapped == "output.weight":
                    has_lm_head = True
    if not has_lm_head:
        if emb_entry is None:
            raise ValueError("no lm_head and no embeddings found")
        entries.append((emb_entry[0], emb_entry[1], "output.weight",
                        emb_entry[2]))

    def np_dtype_for(shape):
        return np.float16 if (ftype == 1 and len(shape) == 2) else np.float32

    # ---- header: _build_kv emits the full BPE tokenizer metadata
    # (model/merges/pre/bos/eos) directly from the BPEVocab
    infos = [
        (mapped, list(reversed(shape)),
         G._GGML_F16 if np_dtype_for(shape) == np.float16 else G._GGML_F32)
        for _, _, mapped, shape in entries
    ]
    layout = G.write_gguf_header(
        out_path, config, vocab, infos,
        sizes=[int(np.prod(s)) * np_dtype_for(s)().itemsize
               for _, _, _, s in entries],
    )

    # ---- pass 2: stream tensor data to the recorded offsets
    with open(out_path, "r+b") as f:
        for (path, hf_name, mapped, shape), off in zip(entries, layout):
            with safe_open(path, framework="pt") as sf:
                arr = sf.get_tensor(hf_name).to(torch.float32).numpy()
            if "q_proj" in hf_name:
                arr = unpermute_hf_rope(arr, n_heads)
            elif "k_proj" in hf_name:
                arr = unpermute_hf_rope(arr, n_kv)
            f.seek(off)
            f.write(np.ascontiguousarray(
                arr, dtype=np_dtype_for(shape)).tobytes())


def convert(
    dir_model: str,
    out_path: str | None = None,
    ftype: int = 1,
    vocab_only: bool = False,
    fmt: str = "auto",
) -> str:
    """Convert a checkpoint directory to a single ggjt file."""
    if fmt == "auto":
        fmt = "hf" if os.path.exists(os.path.join(dir_model, "config.json")) else "meta"

    tensors: dict[str, np.ndarray] = {}
    stream_hf = False
    bpe_hf = False
    if fmt == "hf":
        # hparams always come from config.json (present — fmt detection
        # keys on it), so a --vocab-only header still carries real model
        # dims; tensors only load/stream for full conversions
        hparams = hf_hparams(dir_model)
        if not vocab_only:
            if _hf_safetensor_files(dir_model):
                stream_hf = True  # constant-memory path
            else:  # legacy torch-bin checkpoints go through transformers
                hparams, tensors = load_hf_checkpoint(dir_model)
        tok_path = os.path.join(dir_model, "tokenizer.model")
        # LLaMA-3-family repos ship a BPE tokenizer.json instead of a
        # sentencepiece tokenizer.model; those convert to GGUF (the only
        # container of ours that carries BPE merges)
        bpe_hf = (not os.path.exists(tok_path)
                  and os.path.exists(os.path.join(dir_model, "tokenizer.json")))
    else:
        with open(os.path.join(dir_model, "params.json")) as f:
            hparams = json.load(f)
        tok_path = os.path.join(os.path.dirname(os.path.normpath(dir_model)),
                                "tokenizer.model")

    if bpe_hf:
        if vocab_only:
            raise ValueError(
                "--vocab-only is not supported for BPE-tokenizer (LLaMA-3 "
                "family) checkpoints: a ggjt scored-piece vocab cannot "
                "carry BPE merges, and GGUF vocab always travels with the "
                "model file — convert the full checkpoint instead")
        if not stream_hf:
            raise ValueError(
                "BPE-tokenizer HF checkpoints need safetensors files "
                "(torch-bin + tokenizer.json is not supported)")
        config = ModelConfig(
            vocab_size=hparams["vocab_size"],
            dim=hparams["dim"],
            n_layers=hparams["n_layers"],
            n_heads=hparams["n_heads"],
            n_kv_heads=hparams["n_kv_heads"],
            multiple_of=hparams.get("multiple_of", 256),
            ffn_dim=hparams["ffn_dim"],
            rope_theta=float(hparams.get("rope_theta", 10000.0)),
            norm_eps=float(hparams.get("norm_eps", 1e-5)),
        )
        if out_path is None:
            suffix = "f32" if ftype == 0 else "f16"
            out_path = os.path.join(dir_model, f"gguf-model-{suffix}.gguf")
        elif not out_path.endswith(".gguf"):
            raise ValueError(
                "BPE-tokenizer models must convert to .gguf (ggjt's "
                "scored-piece vocab cannot carry BPE merges)")
        stream_hf_to_gguf(dir_model, out_path, config, hparams, ftype)
        return out_path

    vocab = vocab_from_sp_model(tok_path)
    config = ModelConfig(
        vocab_size=len(vocab),
        dim=hparams.get("dim", 0),
        n_layers=hparams.get("n_layers", 0),
        n_heads=hparams.get("n_heads", 0),
        n_kv_heads=hparams.get("n_kv_heads"),
        multiple_of=hparams.get("multiple_of", 256),
        ffn_dim=hparams.get("ffn_dim"),
        rope_theta=float(hparams.get("rope_theta", 10000.0)),
        norm_eps=float(hparams.get("norm_eps", 1e-5)),
    )

    if out_path is None:
        suffix = "vocab" if vocab_only else ("f32" if ftype == 0 else "f16")
        out_path = os.path.join(dir_model, f"ggjt-model-{suffix}.bin")

    if fmt == "meta" and not vocab_only:
        # constant-memory path: parts stream to final file offsets
        stream_meta_to_ggjt(dir_model, out_path, config, vocab, ftype,
                            hparams=hparams)
        write_meta_sidecar(out_path, config)
        return out_path

    if stream_hf and not vocab_only:
        stream_hf_to_ggjt(dir_model, out_path, config, vocab, ftype, hparams)
        write_meta_sidecar(out_path, config)
        return out_path

    out = {name: _coerce(arr, ftype) for name, arr in tensors.items()}
    write_ggjt(out_path, config, vocab, out, ftype=ftype)
    if not vocab_only:
        write_meta_sidecar(out_path, config)
    return out_path


def convert_cli(args) -> int:
    """CLI glue for `llamago-tpu-torch convert --model <dir> [--out path]
    [--vocab-only]` (reference: scripts/convert-pth-to-ggml.py:77-82)."""
    if not args.model:
        print("error: convert needs --model <checkpoint dir>", file=sys.stderr)
        return 2
    path = convert(
        args.model,
        out_path=args.out or None,
        ftype=0 if args.dtype == "float32" else 1,
        vocab_only=getattr(args, "vocab_only", False),
    )
    print(f"[CONVERT] wrote {path}")
    return 0
