"""Which leaf is split how (Megatron-style TP), and the local KV cache.

Counterpart of the JAX package's `parallel/sharding.py`, with its rules
(reference: scripts/convert-pth-to-ggml.py:161-188, the shard-reassembly
table of Meta's TP checkpoints):

  column-parallel ("col", out_features split):  wq wk wv w1 w3 output
  row-parallel    ("row", in_features split):   wo w2 (partial sums ->
                                                 all_reduce over tp)
  replicated (None):                            norms, tok_embeddings

wq/wo split only if tp divides n_heads, wk/wv only if tp divides kv_heads,
and any leaf whose dim does not divide tp is replicated. Where JAX keeps a
global array with a sharding, each rank here keeps its own block: a leaf is
cut at load (`shard_leaf`), one layer at a time. A quantized leaf is cut at
its block granularity (Q8_0 / Q4_0 / Q4_1: 32 rows, w4x8: 128 rows; a row
block cuts the values and the scales along K together), and it is cut only
where the local kernel takes the block (`split_ok`): a local width that is a
multiple of the kernels' column unit, a K block of whole groups, no Q4_1
(it has no kernel, in JAX either); otherwise it is replicated.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.ops.quant import G4X8, HEAD_COL_UNIT, QK, is_quantized
from llamago_tpu_torch.parallel.mesh import Mesh

_LAYER_KINDS = {
    "attention_norm": None,
    "ffn_norm": None,
    "wq": "col",
    "wk": "col",
    "wv": "col",
    "wo": "row",
    "w1": "col",
    "w3": "col",
    "w2": "row",
}

_TOP_KINDS = {
    "tok_embeddings": None,
    "norm": None,
    "output": "col",  # vocab-sharded lm head
}


def _axis_ok(tp: int, shape: tuple[int, ...], kind: str | None) -> bool:
    if kind is None:
        return True
    return shape[-1 if kind == "col" else -2] % tp == 0


def param_shardings(config: ModelConfig, mesh) -> dict:
    """Kind of each leaf of checkpoint/params.py's tree: "col", "row" or
    None (replicated), by the JAX package's rules on the dense shapes
    [in, out] (the layer axis is never split)."""
    d, v, f = config.dim, config.vocab_size, config.ffn_hidden
    h, kv, hd = config.n_heads, config.kv_heads, config.head_dim
    tp = mesh.shape["tp"]
    shapes = {"tok_embeddings": (v, d), "norm": (d,), "output": (d, v),
              "attention_norm": (d,), "ffn_norm": (d,), "wq": (d, h * hd),
              "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d),
              "w1": (d, f), "w2": (f, d), "w3": (d, f)}
    gate = {"wq": h % tp == 0, "wo": h % tp == 0, "wk": kv % tp == 0, "wv": kv % tp == 0}

    def kind(key, rule):
        k = rule if gate.get(key, True) else None
        return k if tp > 1 and _axis_ok(tp, shapes[key], k) else None

    return {**{k: kind(k, r) for k, r in _TOP_KINDS.items()},
            "layers": {k: kind(k, r) for k, r in _LAYER_KINDS.items()}}


def global_dims(config: ModelConfig) -> dict[str, tuple[int, int]]:
    """(in, out) of each matmul leaf of the whole model."""
    d, v, f = config.dim, config.vocab_size, config.ffn_hidden
    q, kv = config.n_heads * config.head_dim, config.kv_heads * config.head_dim
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d), "w1": (d, f),
            "w3": (d, f), "w2": (f, d), "output": (d, v)}


def leaf_width(w) -> int:
    """A matmul leaf's output width (its N): dense, quantized or LoRA."""
    if isinstance(w, dict):
        return w["s"].shape[-1] if "s" in w else leaf_width(w["base"])
    return w.shape[-1]


def leaf_depth(w) -> int:
    """A matmul leaf's input depth (its K): dense, quantized or LoRA."""
    if isinstance(w, dict):
        if "q8" in w:
            return w["q8"].shape[-2]
        if "q4" in w or "q4x" in w:
            return 2 * w["q4" if "q4" in w else "q4x"].shape[-2]
        return leaf_depth(w["base"])
    return w.shape[-2]


@functools.lru_cache(maxsize=64)
def _split_table(config: ModelConfig, tp: int) -> dict[str, tuple[str | None, int, int]]:
    """(kind, in, out) of each matmul leaf at tp ways."""
    kinds = param_shardings(config, Mesh(tp=tp))
    kinds = {**kinds, **kinds["layers"]}
    return {key: (kinds[key], k, n) for key, (k, n) in global_dims(config).items()}


def block_kind(key: str, leaf, config: ModelConfig, mesh) -> str | None:
    """"col" or "row" where `leaf` (the matmul leaf `key`, dense, quantized
    or LoRA) is this rank's column or row block, None where it is whole:
    the leaf's shape tells whether the loader cut it (split_ok)."""
    if mesh is None or mesh.shape["tp"] == 1:
        return None
    tp = mesh.shape["tp"]
    kind, k, n = _split_table(config, tp).get(key, (None, 0, 0))
    if kind == "col" and leaf_width(leaf) * tp == n:
        return "col"
    if kind == "row" and leaf_depth(leaf) * tp == k:
        return "row"
    return None


def _quant_key(leaf: dict) -> str:
    return next(k for k in ("q8", "q4x", "q4") if k in leaf)


def split_ok(leaf, kind: str | None, tp: int) -> bool:
    """Whether a leaf ([..., K, N]: dense, or quantized as ops/quant.py
    lays it out) can be cut `kind` ways into tp blocks that its local
    matmul takes. Quantized: a column block a multiple of the kernels'
    column unit (16), a row block of whole scale groups; Q4_1 never."""
    if kind is None or tp == 1:
        return False
    if not is_quantized(leaf):
        return leaf.shape[-1 if kind == "col" else -2] % tp == 0
    if "m" in leaf:
        return False
    n = leaf["s"].shape[-1]
    if kind == "col":
        return n % tp == 0 and (n // tp) % HEAD_COL_UNIT == 0
    key = _quant_key(leaf)
    k = leaf[key].shape[-2] * (1 if key == "q8" else 2)
    return k % ((G4X8 if key == "q4x" else QK) * tp) == 0


def shard_leaf(leaf, kind: str, tp: int, index: int):
    """Block `index` of tp of a leaf cut `kind` ways, as new contiguous
    tensors (the full leaf can be freed). A row block of a quantized leaf
    cuts the values and the scales (and mins) along K at the same rows."""
    def cut(t: torch.Tensor, dim: int, parts: int = tp):
        n = t.shape[dim] // parts
        # a copy even where the block is a contiguous view (a row block):
        # a view would keep the whole leaf's storage alive
        return t.narrow(dim, index * n, n).clone(memory_format=torch.contiguous_format)

    if not is_quantized(leaf):
        return cut(leaf, -1 if kind == "col" else -2)
    if kind == "col":
        return {k: cut(v, -1) for k, v in leaf.items()}
    return {k: cut(v, -2) for k, v in leaf.items()}


@dataclass(frozen=True)
class CacheSharding:
    """Ways the KV cache [B, KV, S, hd] (scale planes [B, KV, S]) is split:
    slots on dp, kv heads on tp, positions on sp (1 = not split)."""

    batch: int = 1
    kv: int = 1
    seq: int = 1

    def local_shape(self, b: int, kv: int, s: int) -> tuple[int, int, int]:
        return b // self.batch, kv // self.kv, s // self.seq


def cache_sharding(config: ModelConfig, mesh, batch: int | None = None,
                   max_seq: int | None = None) -> CacheSharding:
    """The KV cache's split, as the JAX function's spec: kv_heads on tp if
    tp divides them, positions on sp if sp divides S (`max_seq`, default
    config.max_seq_len), slots on dp unless `batch` is given and dp does
    not divide it."""
    tp, dp, sp = mesh.shape["tp"], mesh.shape["dp"], mesh.shape["sp"]
    s = max_seq or config.max_seq_len
    b_ok = batch is None or batch % dp == 0
    return CacheSharding(batch=dp if b_ok else 1,
                         kv=tp if config.kv_heads % tp == 0 else 1,
                         seq=sp if sp > 1 and s % sp == 0 else 1)
