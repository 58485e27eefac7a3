"""Static-shape KV cache, one [B, KV, S, hd] tensor per layer, dense or
int8-quantized.

Counterpart of the JAX package's `runtime/kv_cache.py` in its layered
layout. JAX donates the cache buffers to each jitted step so XLA updates
them in place; here the tensors are updated in place directly
(`write_rows`, `write_scale_rows`, ops/cache_write.py), so a forward step
returns the same cache object it was given.

Writes reproduce `lax.dynamic_update_slice`: a start past S - T is
CLAMPED to S - T. The engine's `_fits` check and its parking of inactive
rows (runtime/engine.py) are written against exactly that behaviour.

Quantized mode (`kv_dtype="int8"`): K/V rows are stored int8 with one
scale per (batch, head, position) row of head_dim elements, q = round(x/s)
for the f32 s = absmax/127 (`quantize_kv_rows`). The scale planes `ks`/`vs`
are [B, KV, S] per layer, zero-initialized, and the attention folds them
into its scores and probabilities (ops/attention.py). They hold f32, or
bf16 under LLAMAGO_KV_SCALE_DTYPE=bfloat16: a row is still quantized against
its f32 scale, and the scale is rounded as it is written into the plane.

Under a mesh (parallel/) each rank holds its block of the cache, as the
JAX package's `cache_sharding` lays it out: slots split over dp
(`batch_split`), kv heads over tp, positions over sp (`seq_split`: this
rank holds the S_l positions from sp_index * S_l). A write under sp clamps
its GLOBAL start as dynamic_update_slice does, then each sp rank writes the
part of the rows that falls in its block (`write_rows_sp`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.utils.device import resolve_device, torch_dtype

# Storage dtype of the int8 cache's scale planes, read as the JAX package
# reads it: float32 (the default) or bfloat16.
_SCALE_DTYPE_NAME = os.environ.get("LLAMAGO_KV_SCALE_DTYPE", "float32")


def scale_dtype() -> torch.dtype:
    if _SCALE_DTYPE_NAME not in ("float32", "bfloat16"):
        raise ValueError(f"LLAMAGO_KV_SCALE_DTYPE={_SCALE_DTYPE_NAME}: the scale "
                         "planes hold float32 or bfloat16")
    return torch_dtype(_SCALE_DTYPE_NAME)

# 1/127 rounded to f32. The JAX package writes `absmax / 127.0`, and XLA
# compiles a division by a constant into this multiplication, one ulp away
# from a true division on some rows: the port multiplies too, so its scales
# equal the JAX package's bit for bit.
INV127 = 1.0 / 127.0


@dataclass
class KVCache:
    k: list  # n_layers tensors [B, KV, S, hd]
    v: list
    # int8 mode only: n_layers scale planes [B, KV, S]; None => dense
    ks: list | None = None
    vs: list | None = None
    # ways the slots / the positions are split over the mesh (1: whole)
    batch_split: int = 1
    seq_split: int = 1

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def batch(self) -> int:
        return self.k[0].shape[0]

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[2]

    @staticmethod
    def create(config: ModelConfig, batch: int = 1, max_seq: int | None = None,
               dtype: torch.dtype | None = None, device="cuda", mesh=None) -> "KVCache":
        """A zeroed cache of `batch` slots and `max_seq` positions; under
        `mesh` this rank's block of it (parallel/sharding.py:cache_sharding)."""
        device = resolve_device(device)
        quantized = config.kv_dtype == "int8"
        if quantized:
            dtype = torch.int8
        elif dtype is None:
            dtype = torch_dtype(config.kv_dtype if config.kv_dtype != "auto"
                                else config.dtype)
        s = max_seq or config.max_seq_len
        split = None
        if mesh is not None and mesh.world > 1:
            from llamago_tpu_torch.parallel.sharding import cache_sharding

            split = cache_sharding(config, mesh, batch=batch, max_seq=s)
            batch, kv, s = split.local_shape(batch, config.kv_heads, s)
        else:
            kv = config.kv_heads
        shape = (batch, kv, s, config.head_dim)
        ways = {} if split is None else {"batch_split": split.batch, "seq_split": split.seq}

        def mk(shp, dt):
            return [torch.zeros(shp, dtype=dt, device=device)
                    for _ in range(config.n_layers)]

        if not quantized:
            return KVCache(k=mk(shape, dtype), v=mk(shape, dtype), **ways)
        # zero scales: an unwritten row dequantizes to exactly zero
        return KVCache(k=mk(shape, dtype), v=mk(shape, dtype),
                       ks=mk(shape[:-1], scale_dtype()),
                       vs=mk(shape[:-1], scale_dtype()), **ways)

    def slot(self, i: int) -> "KVCache":
        """Views of (local) batch row i: writes through them land in this
        cache."""
        def rows(planes):
            return None if planes is None else [a[i:i + 1] for a in planes]

        return KVCache(k=rows(self.k), v=rows(self.v), ks=rows(self.ks),
                       vs=rows(self.vs), seq_split=self.seq_split)


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization over the trailing head_dim:
    x [..., hd] -> (int8 [..., hd], f32 scale [...]) with q = round(x/s)
    (half to even) clipped to +-127, s = absmax/127, and s = 1 for all-zero
    rows so the dequantized row is exactly zero."""
    xf = x.to(torch.float32)
    a = xf.abs().amax(dim=-1)
    s = torch.where(a > 0, a * INV127, torch.ones_like(a))
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _starts(write_pos: torch.Tensor, s: int, t: int, dev) -> torch.Tensor:
    """Write starts placed as JAX's dynamic_update_slice places them: a
    negative start counts from the end, then the start is clamped to
    [0, S - T]."""
    start = write_pos.to(device=dev, dtype=torch.long)
    return torch.clamp(torch.where(start < 0, start + s, start), 0, s - t)


def write_rows(cache_layer: torch.Tensor, new: torch.Tensor,
               write_pos: torch.Tensor) -> None:
    """In place: cache_layer[b, :, p_b:p_b+T, :] = new[b] for new
    [B, T, KV, hd] and write_pos [B], each start placed by `_starts`."""
    b, t = new.shape[:2]
    dev = cache_layer.device
    start = _starts(write_pos, cache_layer.shape[2], t, dev)
    rows = torch.arange(b, device=dev)[:, None]
    cols = start[:, None] + torch.arange(t, device=dev)[None, :]
    # advanced indices around a slice put their [B, T] dims first, which
    # is new's own layout
    cache_layer[rows, :, cols, :] = new.to(cache_layer.dtype)


def write_scale_rows(scale_layer: torch.Tensor, new: torch.Tensor,
                     write_pos: torch.Tensor) -> None:
    """In place: scale_layer[b, :, p_b:p_b+T] = new[b] for new [B, T, KV]
    scales and write_pos [B], placed exactly as `write_rows` places rows,
    cast to the plane's dtype."""
    b, t = new.shape[:2]
    dev = scale_layer.device
    start = _starts(write_pos, scale_layer.shape[2], t, dev)
    rows = torch.arange(b, device=dev)[:, None]
    cols = start[:, None] + torch.arange(t, device=dev)[None, :]
    scale_layer[rows, :, cols] = new.to(scale_layer.dtype)


def sp_starts(write_pos: torch.Tensor, s_global: int, t: int) -> list[int]:
    """The global write starts of a window of t rows into a cache of
    s_global positions, placed by `_starts`, on the host: every sp rank
    computes the same ones."""
    return _starts(write_pos, s_global, t, torch.device("cpu")).tolist()


def write_rows_sp(layer: torch.Tensor, new: torch.Tensor, starts: list[int],
                  offset: int) -> None:
    """In place, under sp: the part of each batch row's window
    new[b] ([T, KV, hd] rows, or [T, KV] scales) at global positions
    starts[b] .. starts[b] + T - 1 that falls in this rank's block of the
    positions, [offset, offset + S_l), of `layer` ([B, KV, S_l, hd] or
    [B, KV, S_l])."""
    t, s_l = new.shape[1], layer.shape[2]
    for b, st in enumerate(starts):
        lo, hi = max(st, offset), min(st + t, offset + s_l)
        if lo < hi:
            layer[b, :, lo - offset:hi - offset] = new[b, lo - st:hi - st].transpose(0, 1).to(
                layer.dtype)
