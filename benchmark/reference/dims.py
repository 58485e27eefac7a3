"""A model configuration's sizes, read from its JSON file.

The file keeps the published `config.json`'s keys (Hugging Face names);
this module reads the handful that the reference, the weight generator and
`reckon.py` need, and the formats the configuration states. Pure Python:
the reference imports it, so it imports nothing of the program.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

QK = 32  # values per Q8_0 block
Q8_BLOCK_BYTES = 2 + QK  # f16 scale, then 32 int8 quants


@dataclass(frozen=True)
class Dims:
    name: str
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    rope_theta: float
    norm_eps: float
    weights: str  # "q8_0"
    compute: str  # "bfloat16" | "float32"
    kv_cache: str  # "bfloat16" | "float32" | "int8"

    @property
    def q_width(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_width(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_matrices(self) -> dict[str, tuple[int, int]]:
        """Each layer's matmul weights in the file's layout, [out, in]."""
        d, f = self.dim, self.ffn
        return {"wq": (self.q_width, d), "wk": (self.kv_width, d), "wv": (self.kv_width, d),
                "wo": (d, self.q_width), "w1": (f, d), "w2": (d, f), "w3": (f, d)}

    def matmul_params(self) -> int:
        """Weights a token's forward multiplies: every layer's and the head's."""
        per_layer = sum(o * i for o, i in self.layer_matrices().values())
        return self.n_layers * per_layer + self.dim * self.vocab


def load_dims(path: str) -> Dims:
    with open(path) as f:
        c = json.load(f)
    heads = c["num_attention_heads"]
    fmt = c["formats"]
    return Dims(
        name=os.path.splitext(os.path.basename(path))[0],
        dim=c["hidden_size"], n_layers=c["num_hidden_layers"], n_heads=heads,
        n_kv_heads=c.get("num_key_value_heads") or heads,
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        ffn=c["intermediate_size"], vocab=c["vocab_size"],
        rope_theta=float(c.get("rope_theta", 10000.0)), norm_eps=float(c["rms_norm_eps"]),
        weights=fmt["weights"], compute=fmt["compute"], kv_cache=fmt["kv_cache"])
