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
`export_ggjt_tensors` is the way back: a dense tree to file-layout numpy
tensors for `write_ggjt` / `write_gguf`.

Under a mesh (parallel/), `load_parameters`, `random_quantized_parameters`
and `params_from_numpy` keep only this rank's block of each leaf
(parallel/sharding.py): each leaf is built as the single card would build
it, one layer at a time, and cut at once, so the whole model never sits on
a rank and the transient is one layer's leaf. A head that is cut is not
column-padded (its gathered logits are exactly the vocab); a replicated one
is, as on one card.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from llamago_tpu_torch.checkpoint.quant_file import to_device_leaf
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


def _file_layer(tensors: dict, i: int, key: str, dev: torch.device):
    """Layer i's leaf `key`: a file-quantized leaf as torch tensors on
    dev, a dense one as numpy ([in, out] for a matrix)."""
    m = tensors[f"layers.{i}.{_LAYER_KEYS[key]}"]
    if _is_file_quant(m):
        return to_device_leaf(m, dev)
    m = np.asarray(m)
    return m.T if m.ndim == 2 else m


def _stack_layers(tensors: dict, n_layers: int, key: str, dev: torch.device):
    suffix = _LAYER_KEYS[key]
    mats = [tensors[f"layers.{i}.{suffix}"] for i in range(n_layers)]
    if _is_file_quant(mats[0]):
        leaves = [to_device_leaf(m, dev) for m in mats]
        return {k: torch.stack([lf.pop(k) for lf in leaves]) for k in list(leaves[0])}
    out = np.stack([np.asarray(m) for m in mats])
    if out.ndim == 3:
        out = out.transpose(0, 2, 1)  # [L, out, in] -> [L, in, out]
    return out


def _file_tree(config: ModelConfig, tensors: dict, dev: torch.device) -> Params:
    """The parameter tree of checkpoint tensors: dense leaves as numpy
    (transposed to [in, out]), file-quantized leaves as torch leaves
    already on `dev`, a quantized embedding table dequantized there (the
    lookup needs dense rows; f32, dequantize_rows's bits)."""
    return {**_file_top(tensors, dev),
            "layers": {k: _stack_layers(tensors, config.n_layers, k, dev) for k in _LAYER_KEYS}}


def _file_top(tensors: dict, dev: torch.device) -> Params:
    """`_file_tree`'s leaves outside the layers."""
    from llamago_tpu_torch.ops.quant import dequantize

    if "tok_embeddings.weight" not in tensors:
        raise ValueError(
            "checkpoint carries no model tensors (vocab-only file, or a "
            "download truncated after the vocab section) — it can "
            "provide a tokenizer but cannot be loaded as a model")
    emb = tensors["tok_embeddings.weight"]
    if _is_file_quant(emb):
        emb = dequantize(to_device_leaf(emb, dev), torch.float32).T.contiguous()
    else:
        emb = np.asarray(emb)
    out_w = tensors["output.weight"]
    out_w = to_device_leaf(out_w, dev) if _is_file_quant(out_w) else np.asarray(out_w).T
    return {"tok_embeddings": emb, "norm": np.asarray(tensors["norm.weight"]),
            "output": out_w}


def host_parameters(config: ModelConfig, tensors: dict) -> Params:
    """Host-side (numpy) parameter tree from checkpoint tensors. Q8_0, Q4_0
    and Q4_1 file tensors become quantized leaves; a quantized embedding
    table is dequantized (the lookup needs dense rows)."""
    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x.numpy() if isinstance(x, torch.Tensor) else x

    return host(_file_tree(config, tensors, torch.device("cpu")))


def to_torch(arr, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy array (bfloat16 from JAX included) -> torch tensor on device."""
    arr = np.asarray(arr)
    if not arr.flags.writeable:  # a read-only file mapping
        arr = arr.copy()
    # ascontiguousarray gives a 0-d array one dim: keep the array's shape
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.reshape(arr.shape).to(device=device, dtype=dtype or t.dtype)


def _on(x, dev: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array or a torch tensor as a torch tensor on dev (in dtype)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype or x.dtype)
    return to_torch(x, dev, dtype)


def params_from_numpy(tree, device="cuda", mesh=None, config: ModelConfig | None = None
                      ) -> Params:
    """Carry a parameter tree across from the JAX package: dense arrays or
    quantized leaves ({q8 | q4 | q4x, s[, m]}) as numpy, stacked or layered,
    fused or not. The layout and every leaf's dtype stay as they are (f32
    file scales stay f32, packed nibbles stay uint8). Under `mesh` (with
    `config`) each leaf of an unfused tree becomes this rank's block."""
    dev = resolve_device(device)
    cut = _cutter(config, mesh)

    def conv(x, key=None):
        if isinstance(x, dict) and not is_quantized(x):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return tuple(conv(v) for v in x)
        if isinstance(x, dict):
            return cut(key, {k: to_torch(v, dev) for k, v in x.items()})
        return cut(key, to_torch(x, dev))

    return conv(tree)


def _cutter(config: ModelConfig | None, mesh):
    """(key, leaf) -> this rank's block of the leaf, or the leaf whole
    where the sharding rules keep it whole; the identity off a mesh or at
    tp = 1 (dp and sp split no weight)."""
    if mesh is None or mesh.shape["tp"] == 1:
        return lambda key, leaf: leaf
    from llamago_tpu_torch.parallel.sharding import param_shardings, shard_leaf, split_ok

    kinds = param_shardings(config, mesh)
    kinds = {**kinds, **kinds.pop("layers")}
    tp, index = mesh.shape["tp"], mesh.coord("tp")

    def cut(key, leaf):
        if key in ("wqkv", "w13"):
            raise ValueError("a fused tree cannot be cut for tensor parallelism")
        kind = kinds.get(key)
        return shard_leaf(leaf, kind, tp, index) if split_ok(leaf, kind, tp) else leaf

    return cut


def _local_head(cut, leaf, vocab_size: int):
    """This rank's block of the head, or the whole head column-padded as
    on one card where it stays whole."""
    local = cut("output", leaf)
    return local if local is not leaf else pad_lm_head(leaf, vocab_size=vocab_size)


def _layer_adapter(adapters, i: int, key: str):
    """Layer i's adapter of leaf `key` in an adapter subtree (models/lora.py
    load_lora: per-layer lists or stacked arrays), or None."""
    la = adapters.get("layers")
    if isinstance(la, (list, tuple)):
        return la[i].get(key) if i < len(la) else None
    if isinstance(la, dict) and key in la:
        return {k: v[i] for k, v in la[key].items()}
    return None


def load_parameters(config: ModelConfig, tensors: dict, device="cuda", mesh=None,
                    adapters=None) -> Params:
    """Checkpoint tensors -> device tree in the configured dtypes: matmul
    weights quantized when the file or `weight_dtype` says int8 or int4
    (`_quantize_handler`), everything else in the compute dtype (dense
    weights in `weight_dtype`). Each layer's leaf is built on its own and,
    under `mesh`, cut to this rank's block before the next one is built
    (module docstring); the layers are stacked again. Off a mesh the cut
    is the identity, so the transient is one layer's leaf on one card too.
    `adapters` (models/lora.py:load_lora's subtree, on unfused layer
    leaves) are merged into each whole layer leaf before its cut
    (models/lora.py:merge_lora), so a rank's merged block is the slice of
    the one-card merged leaf; an adapter that names no leaf raises."""
    dev = resolve_device(device)
    top = _file_top(tensors, dev)
    quant = config.weight_dtype in ("int8", "int4") or is_quantized(top["output"]) or any(
        _is_file_quant(tensors[f"layers.0.{suffix}"]) for suffix in _LAYER_KEYS.values())
    if quant:
        convert = _quantize_handler(config, dev)
    else:
        wdt = torch_dtype(config.weight_dtype)

        def convert(key, leaf):
            return _on(leaf, dev, wdt)

    cut = _cutter(config, mesh)
    out = {k: convert(k, top[k]) for k in ("tok_embeddings", "norm")}
    head = convert("output", top["output"])
    out["output"] = _local_head(cut, head, config.vocab_size) if quant else cut("output", head)
    merged = 0

    def build(i, key):
        nonlocal merged
        leaf = convert(key, _file_layer(tensors, i, key, dev))
        ad = None if adapters is None else _layer_adapter(adapters, i, key)
        if ad is not None:
            from llamago_tpu_torch.models.lora import LORA_KEYS, merge_lora

            leaf = merge_lora({"base": leaf, **{k: to_torch(ad[k], dev, torch.float32)
                                                for k in LORA_KEYS}})
            merged += 1
        return cut(key, leaf)

    layers = {}
    for key in _LAYER_KEYS:
        per = [build(i, key) for i in range(config.n_layers)]
        layers[key] = ({k: torch.stack([lf.pop(k) for lf in per]) for k in list(per[0])}
                       if isinstance(per[0], dict) else torch.stack(per))
    out["layers"] = layers
    if adapters is not None:
        from llamago_tpu_torch.models.lora import _count_lora

        if merged < _count_lora(adapters):
            raise ValueError(f"only {merged}/{_count_lora(adapters)} adapters name a layer "
                             "leaf of this model (fused wqkv/w13 vs split projections?)")
    return out


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


def _quantize_handler(config: ModelConfig, dev: torch.device):
    """(key, leaf) -> a quantized matmul leaf, the compute dtype for the
    rest, for a stacked or a one-layer leaf. int8: Q8_0 (file leaves kept
    as they are). int4: Q4_0, or under the w4x8 exec format w4x8 for every
    leaf whose in-dim is a multiple of 128 (Q4_0 file leaves re-laid by
    `w4x8_from_leaf`; Q4_1 and Q8_0 file leaves kept). A leaf whose in-dim
    is no multiple of 32 stays dense."""
    dtype = torch_dtype(config.dtype)
    bits = 4 if config.weight_dtype == "int4" else 8
    exec_w4x8 = bits == 4 and int4_exec_format(dev) == "w4x8"

    def handle(key, leaf):
        if is_quantized(leaf):
            leaf = {k: _on(v, dev) for k, v in leaf.items()}
            return _per_layer(w4x8_from_leaf, leaf) if exec_w4x8 else leaf
        if key in QUANT_LEAVES and leaf.shape[-2] % QK == 0:
            arr = _on(leaf, dev, dtype)
            if exec_w4x8 and arr.shape[-2] % G4X8 == 0:
                return _per_layer(quantize_w4x8, arr)
            return _per_layer(lambda a: quantize(a, bits), arr)
        return _on(leaf, dev, dtype)

    return handle


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


def export_ggjt_tensors(config: ModelConfig, params: Params) -> dict:
    """Inverse of host_parameters / params_from_numpy for DENSE trees: the
    port's tree ([in, out] on any device, stacked or per-layer, not fused)
    -> ggjt-named numpy tensors in the file's row-major [out, in] layout,
    ready for `write_ggjt`. float32 and float16 leaves keep their dtype;
    bfloat16 ones, which a file cannot hold, widen to float32 (exactly)."""
    def host(t):
        if isinstance(t, dict):
            raise ValueError("export_ggjt_tensors handles dense params; "
                             "quantize the FILE via checkpoint/quant_file.py")
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def host2d(t):  # [in, out] -> [out, in]
        return np.ascontiguousarray(host(t).T)

    tensors = {"tok_embeddings.weight": host(params["tok_embeddings"]),
               "norm.weight": host(params["norm"]),
               "output.weight": host2d(params["output"])}
    layers = params["layers"]
    for i in range(config.n_layers):
        for key, suffix in _LAYER_KEYS.items():
            leaf = layers[i][key] if isinstance(layers, (list, tuple)) else layers[key]
            if not isinstance(layers, (list, tuple)) and not isinstance(leaf, dict):
                leaf = leaf[i]
            tensors[f"layers.{i}.{suffix}"] = host(leaf) if key.endswith("norm") else host2d(leaf)
    return tensors


def random_parameters(config: ModelConfig, seed: int = 0, scale: float = 0.02,
                      device="cuda", mesh=None) -> Params:
    """Random parameters in the stacked layout, generated leaf by leaf on
    the device from one torch.Generator seeded with `seed`: matmul weights
    and embeddings normal * `scale`, norm gains ones. Dense leaves are in
    `weight_dtype` (bfloat16 for int8 / int4). With int8 or int4 weights
    each matmul leaf is quantized as soon as it is made (so the peak is
    one dense leaf above the final footprint): Q8_0, or int4 in the
    device's exec format (w4x8 where K is a multiple of 128, else Q4_0),
    the int8 head column-padded. The JAX function's shapes, dtypes and
    leaf layouts; the numbers differ from its threefry draws. Under `mesh`
    each leaf is drawn whole, as on one card, and cut to this rank's block."""
    dev = resolve_device(device)
    cut = _cutter(config, mesh)
    quant_bits = {"int8": 8, "int4": 4}.get(config.weight_dtype)
    dtype = torch_dtype("bfloat16" if quant_bits else config.weight_dtype)
    use_w4x8 = quant_bits == 4 and int4_exec_format(dev) == "w4x8"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, v, f = config.dim, config.vocab_size, config.ffn_hidden
    h, kv, hd, n_l = config.n_heads, config.kv_heads, config.head_dim, config.n_layers

    def make(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=dtype, device=dev)
        w = (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
             * scale).to(dtype)
        if quant_bits is None or name not in QUANT_LEAVES:
            return cut(name, w)
        if use_w4x8 and shape[-2] % G4X8 == 0:
            return cut(name, _per_layer(quantize_w4x8, w))
        leaf = _per_layer(lambda a: quantize(a, quant_bits), w)
        return _local_head(cut, leaf, v) if name == "output" else cut(name, leaf)

    layer_shapes = {
        "attention_norm": (n_l, d), "ffn_norm": (n_l, d),
        "wq": (n_l, d, h * hd), "wk": (n_l, d, kv * hd), "wv": (n_l, d, kv * hd),
        "wo": (n_l, h * hd, d), "w1": (n_l, d, f), "w2": (n_l, f, d), "w3": (n_l, d, f),
    }
    return {"tok_embeddings": make("tok_embeddings", (v, d)),
            "norm": make("norm", (d,)),
            "output": make("output", (d, v)),
            "layers": {k: make(k, s) for k, s in layer_shapes.items()}}


def random_quantized_parameters(config: ModelConfig, seed: int = 0,
                                layered: bool = True, device="cuda", mesh=None) -> Params:
    """Random int8 or int4 parameters created directly as quantized leaves
    on the device (uniform random bytes, constant 0.01 bf16 scales; dense
    leaves normal * 0.02 in bf16, norm gains ones) from one torch.Generator
    seeded with `seed`: the production memory layout and byte footprint
    without a dense transient or a quantize pass. int4 leaves come in the
    device's exec format (`int4_exec_format`): w4x8 leaves with [K/64, N]
    scales where K is a multiple of 128, else Q4_0 leaves. The numbers
    differ from the JAX package's threefry draws. Under `mesh` each leaf is
    drawn whole, in the same order as on one card, and cut to this rank's
    block at once: the ranks' blocks are the one-card model's."""
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

    cut = _cutter(config, mesh)

    def mat(name, shape):
        return cut(name, qleaf(shape) if name in QUANT_LEAVES else dense(shape))

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
        "output": _local_head(cut, qleaf((d, v)), v),
        "layers": layers,
    }
