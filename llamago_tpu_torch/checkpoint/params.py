"""Checkpoint tensors -> the port's parameter tree.

Counterpart of the JAX package's `checkpoint/params.py`. The tree keeps
the JAX layout, so a tree built by either package means the same:

  tok_embeddings [V, D]      norm [D]        output [D, V]
  layers/attention_norm [L, D]   layers/ffn_norm [L, D]
  layers/wq [L, D, H*hd]  wk [L, D, KV*hd]  wv [L, D, KV*hd]  wo [L, H*hd, D]
  layers/w1 [L, D, F]     w2 [L, F, D]      w3 [L, D, F]

2-D weights are transposed from the checkpoint's [out, in] to [in, out].
A Q8_0 leaf is {"q8": int8 [K, N], "s": [K/32, N]}; `s` keeps its dtype
(bf16 from `quantize`, f32 from a Q8_0 file). `unstack_layer_params`
turns the stacked layers into a tuple of per-layer dicts and
`fuse_layer_weights` concatenates wq/wk/wv -> wqkv and w1/w3 -> w13, the
layout the engine serves from.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.ops.quant import (
    QK,
    QUANT_LEAVES,
    is_quantized,
    pad_lm_head,
    quantize,
)
from llamago_tpu_torch.utils.device import resolve_device, torch_dtype

Params = dict[str, Any]

_LAYER_KEYS = {
    "attention_norm": "attention_norm.weight",
    "wq": "attention.wq.weight",
    "wk": "attention.wk.weight",
    "wv": "attention.wv.weight",
    "wo": "attention.wo.weight",
    "ffn_norm": "ffn_norm.weight",
    "w1": "feed_forward.w1.weight",
    "w2": "feed_forward.w2.weight",
    "w3": "feed_forward.w3.weight",
}


def _is_file_quant(x) -> bool:
    return hasattr(x, "kind") and hasattr(x, "raw")  # quant_file.QuantTensor


def _qt_to_host_leaf(qt) -> dict:
    """File Q8_0 tensor -> host leaf {q8 [in, out], s f32 [in/32, out]}."""
    from llamago_tpu_torch.checkpoint.quant_file import split_blocks

    q, d = split_blocks(qt)
    return {"q8": np.ascontiguousarray(q.T), "s": np.ascontiguousarray(d.T)}


def _stack_layers(tensors: dict, n_layers: int, key: str):
    suffix = _LAYER_KEYS[key]
    mats = [tensors[f"layers.{i}.{suffix}"] for i in range(n_layers)]
    if _is_file_quant(mats[0]):
        leaves = [_qt_to_host_leaf(m) for m in mats]
        return {k: np.stack([lf[k] for lf in leaves]) for k in leaves[0]}
    out = np.stack([np.asarray(m) for m in mats])
    if out.ndim == 3:
        out = out.transpose(0, 2, 1)  # [L, out, in] -> [L, in, out]
    return out


def host_parameters(config: ModelConfig, tensors: dict) -> Params:
    """Host-side (numpy) parameter tree from checkpoint tensors. Q8_0 file
    tensors become quantized leaves; a quantized embedding table is
    dequantized (the lookup needs dense rows)."""
    from llamago_tpu_torch.checkpoint.quant_file import dequantize_rows

    if "tok_embeddings.weight" not in tensors:
        raise ValueError(
            "checkpoint carries no model tensors (vocab-only file, or a "
            "download truncated after the vocab section) — it can "
            "provide a tokenizer but cannot be loaded as a model")
    emb = tensors["tok_embeddings.weight"]
    emb = dequantize_rows(emb) if _is_file_quant(emb) else np.asarray(emb)
    out_w = tensors["output.weight"]
    out_w = _qt_to_host_leaf(out_w) if _is_file_quant(out_w) else np.asarray(out_w).T
    return {
        "tok_embeddings": emb,
        "norm": np.asarray(tensors["norm.weight"]),
        "output": out_w,
        "layers": {k: _stack_layers(tensors, config.n_layers, k) for k in _LAYER_KEYS},
    }


def to_torch(arr, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy array (bfloat16 from JAX included) -> torch tensor on device."""
    arr = np.asarray(arr)
    if not arr.flags.writeable:  # a read-only file mapping
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device="cuda") -> Params:
    """Carry a parameter tree across from the JAX package: dense arrays or
    {q8, s} leaves as numpy, stacked or layered, fused or not. The layout
    and every leaf's dtype stay as they are (f32 file scales stay f32)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return tuple(conv(v) for v in x)
        return to_torch(x, dev)

    return conv(tree)


def load_parameters(config: ModelConfig, tensors: dict, device="cuda") -> Params:
    """Checkpoint tensors -> device tree in the configured dtypes: matmul
    weights Q8_0 when the file or `weight_dtype` says int8, everything
    else in the compute dtype (dense weights in `weight_dtype`)."""
    dev = resolve_device(device)
    host = host_parameters(config, tensors)
    has_prequant = is_quantized(host["output"]) or any(
        is_quantized(v) for v in host["layers"].values())
    if config.weight_dtype == "int4":
        raise NotImplementedError("int4 weights are not yet ported (int4 slice of the port)")
    if config.weight_dtype == "int8" or has_prequant:
        return _quantize_params(config, host, dev)
    wdt = torch_dtype(config.weight_dtype)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        return to_torch(x, dev, wdt)

    return put(host)


def _quantize_params(config: ModelConfig, host: Params, dev: torch.device) -> Params:
    """Q8_0 for matmul leaves (file leaves kept as they are), the compute
    dtype for the rest; the int8 lm head is column-padded."""
    dtype = torch_dtype(config.dtype)

    def handle(key, leaf):
        if is_quantized(leaf):
            return {k: to_torch(v, dev) for k, v in leaf.items()}
        if key in QUANT_LEAVES and np.shape(leaf)[-2] % QK == 0:
            return quantize(to_torch(leaf, dev, dtype), 8)
        return to_torch(leaf, dev, dtype)

    out = {k: handle(k, host[k]) for k in ("tok_embeddings", "norm", "output")}
    out["output"] = pad_lm_head(out["output"], vocab_size=config.vocab_size)
    out["layers"] = {k: handle(k, v) for k, v in host["layers"].items()}
    return out


def unstack_layer_params(params: Params, n_layers: int) -> Params:
    """Stacked layer weights [L, ...] -> a tuple of per-layer dicts."""
    layers = params["layers"]

    def leaf_at(v, i):
        if isinstance(v, dict):
            return {k: a[i] for k, a in v.items()}
        return v[i]

    per_layer = tuple(
        {k: leaf_at(v, i) for k, v in layers.items()} for i in range(n_layers))
    return {**params, "layers": per_layer}


def _concat_weights(ws: list, dim: int = -1):
    """Concatenate dense or Q8_0 leaves along the output dim, dropping the
    sources as they are consumed."""
    if isinstance(ws[0], dict):
        out: dict = {}
        for key in ("q8", "s"):
            out[key] = torch.cat([w.pop(key) for w in ws], dim=dim)
        return out
    return torch.cat(list(ws), dim=dim)


def fuse_layer_weights(params: Params) -> Params:
    """Fuse wq/wk/wv -> wqkv and w1/w3 -> w13: one streamed matmul
    instead of three/two. CONSUMES the input's layer dicts."""

    def fuse_one(lp: dict) -> dict:
        out = {k: v for k, v in lp.items() if k not in ("wq", "wk", "wv", "w1", "w3")}
        out["wqkv"] = _concat_weights([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")])
        out["w13"] = _concat_weights([lp.pop("w1"), lp.pop("w3")])
        return out

    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        layers = tuple(fuse_one(lp) for lp in layers)
    else:
        layers = fuse_one(layers)
    return {**params, "layers": layers}


def random_quantized_parameters(config: ModelConfig, seed: int = 0,
                                layered: bool = True, device="cuda") -> Params:
    """Random int8 parameters created directly as Q8_0 leaves on the device
    (uniform int8 weights, constant 0.01 bf16 scales; dense leaves normal
    * 0.02 in bf16, norm gains ones) from one torch.Generator seeded with
    `seed`: the production memory layout and byte footprint without a
    dense transient or a quantize pass. The numbers differ from the JAX
    package's threefry draws."""
    if config.weight_dtype != "int8":
        raise NotImplementedError(
            f"random_quantized_parameters: weight_dtype {config.weight_dtype!r}; "
            "only int8 is ported (int4 slice of the port)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, v, f = config.dim, config.vocab_size, config.ffn_hidden
    h, kv, hd, n_l = config.n_heads, config.kv_heads, config.head_dim, config.n_layers

    def qleaf(shape):
        *lead, k, n = shape
        q8 = torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8, device=dev)
        s = torch.full((*lead, k // QK, n), 0.01, dtype=torch.bfloat16, device=dev)
        return {"q8": q8, "s": s}

    def dense(shape):
        if len(shape) == 1:
            return torch.ones(shape, dtype=torch.bfloat16, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * 0.02
        return w.to(torch.bfloat16)

    def mat(name, shape):
        return qleaf(shape) if name in QUANT_LEAVES else dense(shape)

    layer_shapes = {
        "attention_norm": (d,), "ffn_norm": (d,),
        "wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
        "wo": (h * hd, d), "w1": (d, f), "w2": (f, d), "w3": (d, f),
    }
    if layered:
        layers = tuple({k: mat(k, s) for k, s in layer_shapes.items()}
                       for _ in range(n_l))
    else:
        layers = {k: mat(k, (n_l, *s)) for k, s in layer_shapes.items()}
    return {
        "tok_embeddings": dense((v, d)),
        "norm": dense((d,)),
        "output": pad_lm_head(mat("output", (d, v)), vocab_size=v),
        "layers": layers,
    }
