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
design answers that: one warp a row, in the blocks and vector loads that
`append_plan` gives from the shapes. It reads the new rows through their
strides (v_new is a view of the fused wqkv output on the serving path) and
write_pos as int64 or int32, so the wrapper launches nothing else: no copy,
no cast. A CPU tensor takes `cache_append_quant_plain`; a CUDA tensor takes
the kernel, or the wrapper raises (also on strides the kernel cannot take:
it never copies). Prefill windows (t > 1) take the plain path in
models/llama.py, as in the JAX package.
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


# Warps a block of the kernel (one warp a row).
APPEND_WARPS = 8


def append_plan(b: int, kv: int, hd: int, dtype: torch.dtype) -> tuple[int, int, int, int]:
    """The kernel's launch for new rows [b, 1, kv, hd] of `dtype` (bf16 or
    f32), from the shapes alone: (blocks, warps a block, values a lane,
    values a vector load). One warp takes each of the 2 * b * kv rows (K's,
    then V's); a lane holds hd / 32 values and reads them with the widest
    load that divides them, at most 16 bytes."""
    rows = 2 * b * kv
    warps = min(APPEND_WARPS, rows)
    per_lane = hd // 32
    vec = 1
    while 2 * vec * dtype.itemsize <= 16 and per_lane % (2 * vec) == 0:
        vec *= 2
    return -(-rows // warps), warps, per_lane, vec


@functools.cache
def _lib():
    fn = _build.library("cache_append").llamago_cache_append_quant
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, ll, ll, ll, ll, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _rows_disjoint(x: torch.Tensor) -> bool:
    """Whether the hd-long rows of x [B, 1, KV, hd] (last dimension
    contiguous) lie apart in memory: over the batch and head dimensions
    taken by stride, each stride reaches past everything below it."""
    reach = x.shape[3]
    for size, stride in sorted(((x.shape[i], x.stride(i)) for i in (0, 2) if x.shape[i] > 1),
                               key=lambda d: d[1]):
        if stride < reach:
            return False
        reach = stride * (size - 1) + reach
    return True


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
    if pos.dtype not in (torch.int64, torch.int32) or pos.shape != (b,):
        raise ValueError(f"cache_append_quant: write_pos {pos.dtype} "
                         f"{tuple(pos.shape)} must be int64 or int32 [B]")
    for name, x in (("k_l", k_l), ("v_l", v_l), ("ks_l", ks_l), ("vs_l", vs_l),
                    ("k_new", k_new), ("v_new", v_new), ("write_pos", pos)):
        if x.device != k_new.device:
            raise ValueError(f"cache_append_quant: {name} on {x.device}, "
                             f"k_new on {k_new.device}")
    for name, x in (("k_l", k_l), ("v_l", v_l), ("ks_l", ks_l), ("vs_l", vs_l),
                    ("write_pos", pos)):
        if not x.is_contiguous():
            raise ValueError(f"cache_append_quant: {name} must be contiguous")
    for name, x in (("k_l", k_l), ("v_l", v_l)):
        if x.data_ptr() % 16:  # the packed int8 stores, up to 16 bytes a lane
            raise ValueError(f"cache_append_quant: {name} must start 16-byte aligned")
    vec = append_plan(b, kv, hd, k_new.dtype)[3]
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if x.stride(3) != 1 or not _rows_disjoint(x):
            raise ValueError(f"cache_append_quant: {name} strides {x.stride()} do not lay "
                             "out contiguous rows apart from each other")
        if x.data_ptr() % (vec * x.element_size()) or x.stride(0) % vec or x.stride(2) % vec:
            raise ValueError(f"cache_append_quant: {name} (strides {x.stride()}) is not "
                             f"aligned to the kernel's loads of {vec} values")


def _cuda_or_raise(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"cache_append_quant: unsupported device {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def cache_append_quant(k_l, v_l, ks_l, vs_l, k_new, v_new, write_pos) -> None:
    """In place: quantize the t = 1 rows k_new / v_new [B, 1, KV, hd] (any
    batch and head strides, the last dimension contiguous) and write them
    and their scales into the int8 cache layer at write_pos [B] (int64 or
    int32)."""
    if k_new.device.type == "cpu":
        cache_append_quant_plain(k_l, v_l, ks_l, vs_l, k_new, v_new, write_pos)
        return
    _cuda_or_raise(k_new)
    _check_cuda_args(k_l, v_l, ks_l, vs_l, k_new, v_new, write_pos)
    b, _, kv, hd = k_new.shape
    _, warps, _, vec = append_plan(b, kv, hd, k_new.dtype)
    err = _lib()(k_new.data_ptr(), v_new.data_ptr(), k_new.stride(0), k_new.stride(2),
                 v_new.stride(0), v_new.stride(2), k_l.data_ptr(), v_l.data_ptr(),
                 ks_l.data_ptr(), vs_l.data_ptr(), write_pos.data_ptr(), b, kv, k_l.shape[2],
                 hd, int(k_new.dtype == torch.bfloat16), int(ks_l.dtype == torch.bfloat16),
                 int(write_pos.dtype == torch.int64), vec, warps, _stream(k_new))
    _build.check(err, "cache_append_quant")
    cache_append_quant.launches += 1


cache_append_quant.launches = 0
