"""Model, generation and server configuration.

The port's own copy of the JAX package's `config.py`, field for field, so
a configuration built for one package means the same in the other. The
reference keeps all of this in one struct, `ModelParams`
(reference: pkg/llama/llama.go:32-74), filled from CLI flags
(reference: main.go:332-382).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Static LLaMA architecture hyper-parameters (ggjt v1 header fields,
    reference: pkg/llama/llama.go:743-749, plus GQA / rope extensions)."""

    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    # Grouped-query attention. None => MHA (n_kv_heads == n_heads).
    n_kv_heads: int | None = None
    multiple_of: int = 256
    # Explicit FFN hidden size override. None => LLaMA-1 formula below.
    ffn_dim: int | None = None
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # Max sequence length the KV cache is allocated for ("--context").
    max_seq_len: int = 1024
    # Compute dtype on device: "bfloat16" (default) or "float32".
    dtype: str = "bfloat16"
    # Weight storage: "float32" | "bfloat16" | "int8" | "int4".
    weight_dtype: str = "bfloat16"
    # KV-cache storage: "auto" (= compute dtype) | "bfloat16" | "float32"
    # | "int8".
    kv_dtype: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def ffn_hidden(self) -> int:
        """FFN hidden size (LLaMA-1 formula, reference: llama.go:761)."""
        if self.ffn_dim is not None:
            return self.ffn_dim
        m = self.multiple_of
        return ((2 * (4 * self.dim) // 3 + m - 1) // m) * m

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


MODEL_PRESETS: dict[str, ModelConfig] = {
    "7B": ModelConfig(vocab_size=32000, dim=4096, n_layers=32, n_heads=32),
    "13B": ModelConfig(vocab_size=32000, dim=5120, n_layers=40, n_heads=40),
    "30B": ModelConfig(vocab_size=32000, dim=6656, n_layers=60, n_heads=52),
    "65B": ModelConfig(vocab_size=32000, dim=8192, n_layers=80, n_heads=64),
    "llama2-7B": ModelConfig(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                             max_seq_len=4096),
    "llama2-13B": ModelConfig(vocab_size=32000, dim=5120, n_layers=40, n_heads=40,
                              max_seq_len=4096),
    "llama2-70B": ModelConfig(vocab_size=32000, dim=8192, n_layers=80, n_heads=64,
                              n_kv_heads=8, ffn_dim=28672, max_seq_len=4096),
    "llama3-8B": ModelConfig(vocab_size=128256, dim=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, ffn_dim=14336,
                             rope_theta=500000.0, max_seq_len=8192),
    "llama3-70B": ModelConfig(vocab_size=128256, dim=8192, n_layers=80,
                              n_heads=64, n_kv_heads=8, ffn_dim=28672,
                              rope_theta=500000.0, max_seq_len=8192),
    # Tiny configs for tests.
    "tiny": ModelConfig(vocab_size=512, dim=64, n_layers=2, n_heads=4,
                        multiple_of=32, max_seq_len=128),
    "tiny-gqa": ModelConfig(vocab_size=512, dim=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, multiple_of=32, max_seq_len=128),
}


@dataclass(frozen=True)
class GenerateConfig:
    """Per-request generation parameters (reference defaults:
    main.go:70-93,352-382)."""

    max_tokens: int = 512          # --predict
    ctx_size: int = 1024           # --context
    temp: float = 0.5              # --temp
    top_k: int = 40
    top_p: float = 0.95
    repeat_penalty: float = 1.10
    repeat_last_n: int = 1024
    # stop sequences: generation ends when any appears in the rendered
    # output, which is truncated at the first occurrence
    stop: tuple = ()
    batch_size: int = 1024
    keep_count: int = 0
    seed: int = -1                 # -1 => time-based
    # Stop at EOS (the reference never does; parity default off).
    stop_at_eos: bool = False
    # Wall-clock job deadline in seconds; 0 disables.
    deadline_s: float = 0.0

    def replace(self, **kw) -> "GenerateConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ServerConfig:
    """Serving-layer configuration (reference: pkg/server/server.go:40-58).
    "Pods" are decode slots in one continuously-batched engine."""

    host: str = "localhost"
    port: int = 8080
    max_pods: int = 1
    prefill_buckets: tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
