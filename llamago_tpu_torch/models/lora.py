"""LoRA / QLoRA fine-tuning: low-rank adapters over a frozen base.

Counterpart of the JAX package's `models/lora.py`. The base weights stay
frozen and may stay block-quantized: a quantized base streams through the
quantized matmul kernels, whose autograd Function
(ops/kernels.py:FrozenQuantMatmul) gives the activations their gradient
and the leaf none, while rank-r adapters A[in, r] B[r, out] train on top
(QLoRA recipe: arXiv 2305.14314, public method).

Leaf format: a targeted weight leaf becomes
    {"base": <dense tensor | quantized {q8|q4|q4x, s}>,
     "lora_a": f32[in, r], "lora_b": f32[r, out], "lora_scale": f32[]}
and ops/basic.py:linear dispatches it as base(x) + ((x A) B) * scale.
A is Kaiming-normal from numpy (the JAX package's draws, bit for bit), B
zero, so the wrapped model is exactly the base model at step 0. Optimizer
state exists only for the adapters' A and B.

Under the active mesh (parallel/) with tp > 1 an adapter is cut with its
base (ops/basic.py:_lora_linear): a column block holds B's columns, a row
block A's rows, the other half whole. `init_lora` draws every A whole, as
one card draws it, and cuts it; `save_lora` gathers whole adapters to rank
0 in the JAX layout, so a file trained on any mesh serves on any other and
in the JAX package. Serving merges adapters into whole leaves in the loader
(checkpoint/params.py:load_parameters), before each leaf is cut.
"""

from __future__ import annotations

import numpy as np
import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.models.training import ADAMW, _step, loss_fn, trainable
from llamago_tpu_torch.ops.quant import QK, dequantize, is_quantized, quantize
from llamago_tpu_torch.parallel.mesh import all_gather
from llamago_tpu_torch.parallel.sharding import block_kind
from llamago_tpu_torch.parallel.tp_kernels import active_mesh

# layer leaves eligible for adapters; fused projections included so
# fuse_layer_weights'd params wrap cleanly
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "wqkv")

LORA_KEYS = ("lora_a", "lora_b", "lora_scale")
TRAINABLE_KEYS = ("lora_a", "lora_b")  # scale is a constant


def is_lora(leaf) -> bool:
    return isinstance(leaf, dict) and "lora_a" in leaf


def _leaf_dims(leaf) -> tuple[tuple, int, int]:
    """(lead, in, out) of a dense or quantized matmul leaf; `lead` is the
    layer-stack prefix of stacked params (adapters stack with it)."""
    if is_quantized(leaf):
        if "q8" in leaf:
            k = leaf["q8"].shape[-2]
        elif "q4x" in leaf:
            k = leaf["q4x"].shape[-2] * 2
        else:
            k = leaf["q4"].shape[-2] * 2
        return tuple(leaf["s"].shape[:-2]), k, leaf["s"].shape[-1]
    return tuple(leaf.shape[:-2]), leaf.shape[-2], leaf.shape[-1]


def _device(leaf) -> torch.device:
    return (leaf["s"] if isinstance(leaf, dict) else leaf).device


def _on(x, dev: torch.device) -> torch.Tensor:
    """An adapter array (numpy or torch) as an f32 tensor on dev."""
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _tp_cut(config: ModelConfig | None):
    """The active mesh where it splits leaves over tp (init_lora and
    save_lora then need the model's config to tell blocks from whole
    leaves), else None."""
    mesh = active_mesh()
    if mesh is None or mesh.tp == 1:
        return None
    if config is None:
        raise ValueError("under tp the leaves are the rank's blocks: pass the model's "
                         "config")
    return mesh


def init_lora(params, rank: int = 8, alpha: float = 16.0,
              targets: tuple[str, ...] = DEFAULT_TARGETS, seed: int = 0,
              config: ModelConfig | None = None):
    """Wrap targeted layer leaves with zero-initialized adapters on their
    base's device. Returns a new tree (leaves shared with the input; only
    the targeted leaves are replaced by wrapper dicts). A is drawn from
    np.random.default_rng(seed) layer by layer, each layer's leaves in
    their dict order, as the JAX package draws it; under tp (`config`
    given) each A is drawn whole and a row block keeps its rows."""
    rng = np.random.default_rng(seed)
    mesh = _tp_cut(config)

    def wrap(key, leaf):
        lead, k, n = _leaf_dims(leaf)
        dev = _device(leaf)
        row = mesh is not None and block_kind(key, leaf, config, mesh) == "row"
        k_all = k * mesh.tp if row else k
        a = rng.standard_normal((*lead, k_all, rank)) * (1.0 / np.sqrt(k_all))
        if row:
            i = mesh.coord("tp")
            a = a[..., i * k:(i + 1) * k, :]
        return {
            "base": leaf,
            "lora_a": torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev),
            "lora_b": torch.zeros((*lead, rank, n), dtype=torch.float32, device=dev),
            "lora_scale": torch.full(lead, alpha / rank, dtype=torch.float32, device=dev),
        }

    def wrap_layer(lp):
        return {key: (wrap(key, leaf) if key in targets else leaf) for key, leaf in lp.items()}

    layers = params["layers"]
    return {**params, "layers": (tuple(wrap_layer(lp) for lp in layers)
                                 if isinstance(layers, (list, tuple)) else wrap_layer(layers))}


def extract_lora(params, keys: tuple[str, ...] = LORA_KEYS):
    """The small adapter-only subtree: all of LORA_KEYS for saving, or
    ("lora_a", "lora_b") for the trainable part."""
    def walk(node):
        if is_lora(node):
            return {k: node[k] for k in keys}
        if isinstance(node, dict):
            sub = {k: walk(v) for k, v in node.items()}
            return {k: v for k, v in sub.items() if v is not None}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return None

    return walk(params)


def apply_lora_state(params, adapters):
    """Merge adapter values (a subtree from extract_lora, or load_lora)
    into a wrapped tree, on each adapter's device; keys absent from the
    subtree keep their value."""
    def walk(node, ad):
        if is_lora(node):
            dev = node["lora_a"].device
            return {**node, **{k: _on(v, dev) for k, v in ad.items()}}
        if isinstance(node, dict):
            return {k: (walk(v, ad[k]) if k in (ad or {}) else v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, a) for v, a in zip(node, ad))
        return node

    return walk(params, adapters)


def merge_lora(params):
    """Fold adapters into the base weights and unwrap.

    Dense bases merge exactly (w + A B * scale, in f32, back to the base's
    dtype); quantized bases are dequantized, merged, and requantized at
    their bit width by `quantize`: Q8_0 stays Q8_0, and Q4_0 and w4x8
    bases become Q4_0 (as in the JAX package). Q4_1 bases and in-dims that
    are no multiple of 32 stay dense."""
    def unwrap(node):
        if is_lora(node):
            base = node["base"]
            with torch.no_grad():
                delta = torch.matmul(node["lora_a"], node["lora_b"]) \
                    * node["lora_scale"][..., None, None]
                if is_quantized(base):
                    bits = 8 if "q8" in base else 4
                    dense = dequantize(base, torch.float32) + delta
                    if dense.shape[-2] % QK == 0 and "m" not in base:
                        return quantize(dense, bits)
                    return dense
                return (base.to(torch.float32) + delta).to(base.dtype)
        if isinstance(node, dict):
            return {k: unwrap(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(unwrap(v) for v in node)
        return node

    return unwrap(params)


def _whole_lora(params, config: ModelConfig | None = None):
    """extract_lora's subtree with every adapter whole: under tp each
    cut half is gathered over the tp group (every rank must call this)."""
    mesh = _tp_cut(config)
    if mesh is None:
        return extract_lora(params)

    def walk(node, key=None):
        if is_lora(node):
            out = {k: node[k] for k in LORA_KEYS}
            kind = block_kind(key, node, config, mesh)
            if kind == "row":
                out["lora_a"] = all_gather(node["lora_a"].detach().contiguous(), mesh, "tp", -2)
            elif kind == "col":
                out["lora_b"] = all_gather(node["lora_b"].detach().contiguous(), mesh, "tp", -1)
            return out
        if isinstance(node, dict):
            sub = {k: walk(v, k) for k, v in node.items()}
            return {k: v for k, v in sub.items() if v is not None}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        return None

    return walk(params)


def save_lora(path: str, params, config: ModelConfig | None = None) -> None:
    """Write the adapter subtree as a flat .npz ("layers/0/wq/lora_a"
    keys), the JAX package's file format. Under a mesh every rank calls it
    and rank 0 writes the whole adapters (`_whole_lora`)."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        else:
            flat[prefix] = node.detach().cpu().numpy()

    tree = _whole_lora(params, config)
    mesh = active_mesh()
    if mesh is not None and mesh.rank != 0:
        return
    walk(tree, "")
    np.savez(path, **flat)


def load_lora(path: str):
    """Inverse of save_lora: flat .npz -> nested adapter subtree of numpy
    arrays (lists where the keys are layer indices)."""
    with np.load(path) as z:
        items = {k: z[k] for k in z.files}

    root: dict = {}
    for key, arr in items.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def _count_lora(node) -> int:
    if isinstance(node, dict):
        if "lora_a" in node:
            return 1
        return sum(_count_lora(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_count_lora(v) for v in node)
    return 0


def attach_lora(params, adapters):
    """Wrap base params with saved adapters (the serve-time inverse of
    extract_lora): leaves addressed by the adapter subtree become LoRA
    leaves carrying its A / B / scale on the base's device.

    Layer layout is normalized: adapters trained on stacked params attach
    to per-layer params and vice versa. A leaf mismatch (e.g. adapters for
    wq/wk/wv against fused-wqkv params) raises instead of silently dropping
    adapters."""
    la = adapters.get("layers") if isinstance(adapters, dict) else None
    lp = params.get("layers")
    if isinstance(lp, (list, tuple)) and isinstance(la, dict):
        adapters = {**adapters, "layers": [
            {k: {kk: vv[i] for kk, vv in v.items()} for k, v in la.items()}
            for i in range(len(lp))]}
    elif isinstance(lp, dict) and isinstance(la, (list, tuple)):
        adapters = {**adapters, "layers": {
            k: {kk: np.stack([np.asarray(layer[k][kk]) for layer in la]) for kk in la[0][k]}
            for k in la[0]}}

    def walk(node, ad):
        if isinstance(ad, dict) and "lora_a" in ad:
            dev = _device(node)
            return {"base": node, **{k: _on(ad[k], dev) for k in LORA_KEYS}}
        if isinstance(node, dict):
            return {k: (walk(v, ad[k]) if k in (ad or {}) else v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, a) for v, a in zip(node, ad))
        return node

    out = walk(params, adapters)
    want, got = _count_lora(adapters), _count_lora(out)
    if got < want:
        raise ValueError(
            f"only {got}/{want} adapters attached — the adapter file's "
            "leaf names do not match this model's (fused wqkv/w13 vs "
            "split projections?). Fine-tune and serve with the same "
            "topology, or re-export the adapters.")
    return out


def adapter_tensors(params) -> list[torch.Tensor]:
    """Every A and B of a wrapped tree, in tree order."""
    return trainable(extract_lora(params, TRAINABLE_KEYS))


def init_lora_opt_state(params, lr: float = 1e-3) -> torch.optim.AdamW:
    """AdamW (optax.adamw's defaults) over the adapters' A and B only, which
    it marks as requiring grad: no moments are ever allocated for the
    (possibly quantized) base."""
    ts = adapter_tensors(params)
    for t in ts:
        t.requires_grad_(True)
    return torch.optim.AdamW(ts, lr=lr, **ADAMW)


def lora_train_step(params, opt_state: torch.optim.AdamW, tokens: torch.Tensor,
                    config: ModelConfig, lr: float = 1e-3):
    """One adapter-only training step over the standard LM loss: gradients
    and AdamW updates of A and B alone (in place; each keeps this step's
    gradient in `.grad`), the base frozen. Returns (params, opt_state,
    loss), as the JAX step does; under a mesh the step of every rank, the
    gradients synced as models/training.py:train_step syncs them."""
    for group in opt_state.param_groups:
        group["lr"] = lr
    loss = _step(opt_state, lambda: loss_fn(params, tokens, config), params, config)
    return params, opt_state, loss
