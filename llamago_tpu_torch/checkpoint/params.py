"""Checkpoint tensors -> the port's parameter tree.

Counterpart of the JAX package's `checkpoint/params.py`. The tree keeps
the JAX layout, so a tree built by either package means the same:

  tok_embeddings [V, D]      norm [D]        output [D, V]
  layers/attention_norm [L, D]   layers/ffn_norm [L, D]
  layers/wq [L, D, H*hd]  wk [L, D, KV*hd]  wv [L, D, KV*hd]  wo [L, H*hd, D]
  layers/w1 [L, D, F]     w2 [L, F, D]      w3 [L, D, F]

2-D weights are transposed from the checkpoint's [out, in] to [in, out].
A quantized leaf is a dict (ops/quant.py): Q8_0 {"q8": int8 [K, N], "s":
[K/32, N]}, Q4_0 {"q4": uint8 [K/2, N], "s"}, Q4_1 the same with mins "m",
w4x8 {"q4x": uint8 [K/2, N], "s": bf16 [K/64, N]}; `s` keeps its dtype (bf16
from `quantize`, f32 from a file). int4 weights run in the format
`int4_exec_format` names for the device: under "w4x8" a leaf whose K is a
multiple of 128 is re-laid or quantized into w4x8, the others stay Q4_0, so
one tree may mix both. `unstack_layer_params` turns the stacked layers
into a tuple of per-layer dicts and `fuse_layer_weights` concatenates
wq/wk/wv -> wqkv and w1/w3 -> w13, the layout the engine serves from.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.ops.quant import (
    G4X8,
    QK,
    QUANT_LEAVES,
    int4_exec_format,
    is_quantized,
    pad_lm_head,
    quantize,
    quantize_w4x8,
    w4x8_from_leaf,
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
    """File-quantized tensor -> host leaf {q8 [in, out] | q4 [in/2, out], s
    f32 [in/32, out]} (and m for Q4_1): a transpose of the blocks."""
    from llamago_tpu_torch.checkpoint.quant_file import split_blocks

    parts = split_blocks(qt)
    key = "q8" if qt.kind == "q8_0" else "q4"
    leaf = {key: np.ascontiguousarray(parts[0].T), "s": np.ascontiguousarray(parts[1].T)}
    if qt.kind == "q4_1":
        leaf["m"] = np.ascontiguousarray(parts[2].T)
    return leaf


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
    """Host-side (numpy) parameter tree from checkpoint tensors. Q8_0, Q4_0
    and Q4_1 file tensors become quantized leaves; a quantized embedding
    table is dequantized (the lookup needs dense rows)."""
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
    quantized leaves ({q8 | q4 | q4x, s[, m]}) as numpy, stacked or layered,
    fused or not. The layout and every leaf's dtype stay as they are (f32
    file scales stay f32, packed nibbles stay uint8)."""
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
    weights quantized when the file or `weight_dtype` says int8 or int4,
    everything else in the compute dtype (dense weights in
    `weight_dtype`)."""
    dev = resolve_device(device)
    host = host_parameters(config, tensors)
    has_prequant = is_quantized(host["output"]) or any(
        is_quantized(v) for v in host["layers"].values())
    if config.weight_dtype in ("int8", "int4") or has_prequant:
        return _quantize_params(config, host, dev)
    wdt = torch_dtype(config.weight_dtype)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        return to_torch(x, dev, wdt)

    return put(host)


def _per_layer(fn, leaf):
    """fn (a quantizer: tensor or leaf -> leaf) over a stacked [L, ...] leaf
    one layer at a time, so that its f32 transients are one layer's, not the
    stack's; the results are stacked again. The same bits as fn on the
    whole stack: blocks never span layers."""
    first = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf
    if first.dim() < 3:
        return fn(leaf)

    def at(i):
        return {k: v[i] for k, v in leaf.items()} if isinstance(leaf, dict) else leaf[i]

    outs = [fn(at(i)) for i in range(first.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _quantize_params(config: ModelConfig, host: Params, dev: torch.device) -> Params:
    """Quantized matmul leaves, the compute dtype for the rest. int8: Q8_0
    (file leaves kept as they are), the lm head column-padded. int4: Q4_0,
    or under the w4x8 exec format w4x8 for every leaf whose in-dim is a
    multiple of 128 (Q4_0 file leaves re-laid by `w4x8_from_leaf`; Q4_1 and
    Q8_0 file leaves kept). A leaf whose in-dim is no multiple of 32 stays
    dense."""
    dtype = torch_dtype(config.dtype)
    bits = 4 if config.weight_dtype == "int4" else 8
    exec_w4x8 = bits == 4 and int4_exec_format(dev) == "w4x8"

    def handle(key, leaf):
        if is_quantized(leaf):
            leaf = {k: to_torch(v, dev) for k, v in leaf.items()}
            return _per_layer(w4x8_from_leaf, leaf) if exec_w4x8 else leaf
        if key in QUANT_LEAVES and np.shape(leaf)[-2] % QK == 0:
            arr = to_torch(leaf, dev, dtype)
            if exec_w4x8 and arr.shape[-2] % G4X8 == 0:
                return _per_layer(quantize_w4x8, arr)
            return _per_layer(lambda a: quantize(a, bits), arr)
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
    """Concatenate dense or quantized leaves along the output dim, dropping
    the sources as they are consumed. Every sub-leaf concatenates along that
    dim: the packed values, the scales and (Q4_1) the mins. Leaves of unlike
    formats are refused."""
    kinds = {tuple(sorted(w)) if isinstance(w, dict) else None for w in ws}
    if len(kinds) != 1:
        raise ValueError(f"cannot fuse weights of unlike formats: {sorted(map(str, kinds))}")
    if isinstance(ws[0], dict):
        return {key: torch.cat([w.pop(key) for w in ws], dim=dim) for key in list(ws[0])}
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
    """Random int8 or int4 parameters created directly as quantized leaves
    on the device (uniform random bytes, constant 0.01 bf16 scales; dense
    leaves normal * 0.02 in bf16, norm gains ones) from one torch.Generator
    seeded with `seed`: the production memory layout and byte footprint
    without a dense transient or a quantize pass. int4 leaves come in the
    device's exec format (`int4_exec_format`): w4x8 leaves with [K/64, N]
    scales where K is a multiple of 128, else Q4_0 leaves. The numbers
    differ from the JAX package's threefry draws."""
    if config.weight_dtype not in ("int8", "int4"):
        raise ValueError(f"random_quantized_parameters: weight_dtype "
                         f"{config.weight_dtype!r} is not a quantized one")
    dev = resolve_device(device)
    int4 = config.weight_dtype == "int4"
    w4x8 = int4 and int4_exec_format(dev) == "w4x8"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, v, f = config.dim, config.vocab_size, config.ffn_hidden
    h, kv, hd, n_l = config.n_heads, config.kv_heads, config.head_dim, config.n_layers

    def qleaf(shape):
        *lead, k, n = shape

        def scales(rows):
            return torch.full((*lead, rows, n), 0.01, dtype=torch.bfloat16, device=dev)

        if not int4:
            q8 = torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8,
                               device=dev)
            return {"q8": q8, "s": scales(k // QK)}
        packed = torch.randint(0, 256, (*lead, k // 2, n), generator=gen,
                               dtype=torch.uint8, device=dev)
        if w4x8 and k % G4X8 == 0:
            return {"q4x": packed, "s": scales(k // 64)}
        return {"q4": packed, "s": scales(k // QK)}

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
