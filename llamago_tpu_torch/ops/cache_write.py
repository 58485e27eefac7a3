"""K3: the quantize-and-append write of a decode step's new K/V rows into
the int8 KV cache, its plain version and its launch count.

`cache_append_quant(k_l, v_l, ks_l, vs_l, k_new, v_new, write_pos)`
quantizes the new rows k_new / v_new [B, 1, KV, hd] per (batch, head)
(runtime/kv_cache.py quantize_kv_rows) and writes the int8 rows into
k_l / v_l [B, KV, S, hd] and their scales into ks_l / vs_l [B, KV, S] (f32
planes, or bf16 ones, which take the f32 scale rounded), in place, at
write_pos [B], placed as `write_rows` places a row.

Replaces llamago_tpu/ops/cache_write.py `_append_kernel`. The CUDA kernel
is `csrc/cache_append.cu`; its header note says what bounds it on the card
(launch latency: it touches about 200 KB per layer at 7B batch 8) and how its
design answers that. A CPU tensor takes `cache_append_quant_plain`; a CUDA
tensor takes the kernel, or the wrapper raises. Prefill windows (t > 1)
take the plain path in models/llama.py, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llamago_tpu_torch.ops import _build
from llamago_tpu_torch.runtime.kv_cache import (
    quantize_kv_rows,
    write_rows,
    write_scale_rows,
)


def cache_append_quant_plain(k_l, v_l, ks_l, vs_l, k_new, v_new, write_pos) -> None:
    """Plain K3: quantize_kv_rows, then write_rows / write_scale_rows."""
    kq, ks_new = quantize_kv_rows(k_new)
    vq, vs_new = quantize_kv_rows(v_new)
    write_rows(k_l, kq, write_pos)
    write_rows(v_l, vq, write_pos)
    write_scale_rows(ks_l, ks_new, write_pos)
    write_scale_rows(vs_l, vs_new, write_pos)


@functools.cache
def _lib():
    fn = _build.library("cache_append").llamago_cache_append_quant
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(k_l, v_l, ks_l, vs_l, k_new, v_new, pos) -> None:
    b, t, kv, hd = k_new.shape
    if t != 1 or hd % 32 or hd > 1024:
        raise ValueError(f"cache_append_quant: t={t} (== 1), hd={hd} (a multiple "
                         "of 32, <= 1024) not supported")
    if v_new.shape != k_new.shape or k_l.shape[:2] != (b, kv) or k_l.shape[3] != hd \
            or v_l.shape != k_l.shape:
        raise ValueError(f"cache_append_quant: new rows {tuple(k_new.shape)}, "
                         f"{tuple(v_new.shape)} do not match the cache "
                         f"{tuple(k_l.shape)}, {tuple(v_l.shape)}")
    if ks_l.shape != k_l.shape[:3] or vs_l.shape != ks_l.shape:
        raise ValueError(f"cache_append_quant: scale planes {tuple(ks_l.shape)}, "
                         f"{tuple(vs_l.shape)} do not match the cache "
                         f"{tuple(k_l.shape)}")
    if k_new.dtype not in (torch.bfloat16, torch.float32) or v_new.dtype != k_new.dtype \
            or k_l.dtype != torch.int8 or v_l.dtype != torch.int8 \
            or ks_l.dtype not in (torch.bfloat16, torch.float32) \
            or vs_l.dtype != ks_l.dtype:
        raise ValueError(f"cache_append_quant: dtypes new {k_new.dtype}/{v_new.dtype}, "
                         f"cache {k_l.dtype}/{v_l.dtype}, scales {ks_l.dtype}/"
                         f"{vs_l.dtype} not supported")
    if pos.dtype != torch.int32 or pos.shape != (b,):
        raise ValueError("cache_append_quant: write_pos must be int32 [B]")
    for name, x in (("k_l", k_l), ("v_l", v_l), ("ks_l", ks_l), ("vs_l", vs_l),
                    ("k_new", k_new), ("v_new", v_new), ("write_pos", pos)):
        if x.device != k_new.device:
            raise ValueError(f"cache_append_quant: {name} on {x.device}, "
                             f"k_new on {k_new.device}")
        if not x.is_contiguous():
            raise ValueError(f"cache_append_quant: {name} must be contiguous")


def cache_append_quant(k_l, v_l, ks_l, vs_l, k_new, v_new, write_pos) -> None:
    """In place: quantize the t = 1 rows k_new / v_new [B, 1, KV, hd] and
    write them and their scales into the int8 cache layer at write_pos [B]."""
    if k_new.device.type == "cpu":
        cache_append_quant_plain(k_l, v_l, ks_l, vs_l, k_new, v_new, write_pos)
        return
    if k_new.device.type != "cuda":
        raise ValueError(f"cache_append_quant: unsupported device {k_new.device}")
    # the new rows are strided slices of the fused projection: a small copy
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    pos = write_pos.to(torch.int32).contiguous()
    _check_cuda_args(k_l, v_l, ks_l, vs_l, k_new, v_new, pos)
    b, _, kv, hd = k_new.shape
    err = _lib()(k_new.data_ptr(), v_new.data_ptr(), k_l.data_ptr(), v_l.data_ptr(),
                 ks_l.data_ptr(), vs_l.data_ptr(), pos.data_ptr(), b, kv, k_l.shape[2],
                 hd, int(k_new.dtype == torch.bfloat16), int(ks_l.dtype == torch.bfloat16),
                 torch.cuda.current_stream(k_new.device).cuda_stream)
    _build.check(err, "cache_append_quant")
    cache_append_quant.launches += 1


cache_append_quant.launches = 0
