"""Static-shape dense KV cache, one [B, KV, S, hd] tensor per layer.

Counterpart of the JAX package's `runtime/kv_cache.py` in its layered
layout. JAX donates the cache buffers to each jitted step so XLA updates
them in place; here the tensors are updated in place directly
(`write_rows`), so a forward step returns the same cache object it was
given.

Writes reproduce `lax.dynamic_update_slice`: a start past S - T is
CLAMPED to S - T. The engine's `_fits` check and its parking of inactive
rows (runtime/engine.py) are written against exactly that behaviour.

The int8 cache comes with the int8-KV slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.utils.device import torch_dtype


@dataclass
class KVCache:
    k: list  # n_layers tensors [B, KV, S, hd]
    v: list

    @property
    def batch(self) -> int:
        return self.k[0].shape[0]

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[2]

    @staticmethod
    def create(config: ModelConfig, batch: int = 1, max_seq: int | None = None,
               dtype: torch.dtype | None = None, device="cpu") -> "KVCache":
        if config.kv_dtype == "int8":
            raise NotImplementedError(
                "the int8 KV cache is not yet ported (int8-KV slice of the port)")
        if dtype is None:
            dtype = torch_dtype(config.kv_dtype if config.kv_dtype != "auto"
                                else config.dtype)
        shape = (batch, config.kv_heads, max_seq or config.max_seq_len,
                 config.head_dim)

        def mk():
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(config.n_layers)]

        return KVCache(k=mk(), v=mk())

    def slot(self, i: int) -> "KVCache":
        """Views of batch row i: writes through them land in this cache."""
        return KVCache(k=[a[i:i + 1] for a in self.k],
                       v=[a[i:i + 1] for a in self.v])


def write_rows(cache_layer: torch.Tensor, new: torch.Tensor,
               write_pos: torch.Tensor) -> None:
    """In place: cache_layer[b, :, p_b:p_b+T, :] = new[b] for new
    [B, T, KV, hd] and write_pos [B] on the cache's device. Each start is
    placed as JAX's dynamic_update_slice places it: a negative start
    counts from the end, then the start is clamped to [0, S - T]."""
    b, t = new.shape[:2]
    s = cache_layer.shape[2]
    dev = cache_layer.device
    start = write_pos.to(device=dev, dtype=torch.long)
    start = torch.clamp(torch.where(start < 0, start + s, start), 0, s - t)
    rows = torch.arange(b, device=dev)[:, None]
    cols = start[:, None] + torch.arange(t, device=dev)[None, :]
    # advanced indices around a slice put their [B, T] dims first, which
    # is new's own layout
    cache_layer[rows, :, cols, :] = new.to(cache_layer.dtype)
