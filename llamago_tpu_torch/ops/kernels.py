"""The quantized matmuls (K1, K5, K6 and K9) and the fused RMSNorm (K10),
their plain versions and their launch counts.

`dequant_matmul(x, w)` computes x [..., K] @ dequantized w -> [..., N] in
x.dtype and dispatches on the leaf as the JAX package's `dequant_matmul`
does (llamago_tpu/ops/kernels.py):

  {"q4x", "s"}  w4x8 leaf -> `w4x8_matmul` in the form `w4x8_form` picks:
                K5, the W4A8 decode matmul (its int8 tensor-core decode
                form, csrc/decode_i8_tc.cuh), when the row count m is at
                most `_W4X8_A8_MAX_M` (16, env LLAMAGO_W4X8_A8_MAX_M),
                replacing `_w4x8_decode_kernel`; else K6, the stream
                matmul, replacing `_w4x8_stream_kernel`: the bf16
                tensor-core tile, for f32 x on x's three exact bf16
                parts. CUDA: `csrc/w4x8_matmul.cu`.
  {"q8"|"q4", "s"}  Q8_0 / Q4_0 leaf -> K9, the scale-on-output matmul
                (`dequant_matmul_so`, replacing `_dequant_mm_kernel_so`,
                CUDA: `csrc/dequant_matmul_so.cu`), when max(8, m) is at most
                `SCALE_ON_OUTPUT_MAX_M` (0 = off, env
                LLAMAGO_KERNEL_SO_MAX_M), in the form `k9_form` picks,
                K1's forms on the raw integers: up to 8 rows the bf16
                tensor-core decode form, above that the bf16 tensor-core
                tile, each for f32 x on x's three exact bf16 parts; else
                K1, the dequant-matmul (replacing `_dequant_mm_kernel`,
                bits 8 and 4, CUDA: `csrc/dequant_matmul.cu`) in the form
                `k1_form` picks: up to 8 rows the bf16 tensor-core decode
                form, above that the bf16 tensor-core tile, each for f32
                x on x's three exact bf16 parts.

A Q4_1 leaf (with mins "m") never comes here: `ops/quant.py:quant_matmul`
dequantizes it, as the JAX package does. The TPU launchers' VMEM gates
(`_plan_tiles`, `can_fuse`, the m > 1024 cut-off) are not carried over: the
CUDA kernels take any m.

Each `.cu` header says what bounds its kernel on the card and what the
design does about it. A CPU tensor takes the kernel's plain version
(`*_plain`); a CUDA tensor takes the kernel, or the wrapper raises. Each
wrapper counts its launches (`dequant_matmul.launches` for Q8_0 and
`.launches_q4` for Q4_0, of which `.launches_tc` took the tensor-core tile
with bf16 x, `.launches_f32_tc` the tile with f32 x,
`.launches_decode_tc` the tensor-core decode form and
`.launches_f32_decode_tc` the decode form with f32 x,
`w4x8_matmul.launches_a8` and `.launches_stream` (K6, of which
`.launches_tc` took the tensor-core tile with bf16 x and `.launches_f32_tc`
with f32 x), `dequant_matmul_so.launches` (of which `.launches_decode_tc`
took the tensor-core decode form, `.launches_f32_decode_tc` the decode form
with f32 x, `.launches_tc` the tensor-core tile and `.launches_f32_tc` the
tile with f32 x)).

Under grad, `ops/quant.py:quant_matmul` calls `dequant_matmul` through
`FrozenQuantMatmul`, the JAX package's custom VJP: the kernels forward, and
dx = g @ dequantize(w)^T in plain PyTorch backward; the leaf is frozen.

`fused_rms_norm(x, w, eps)` is K10, replacing `_rms_norm_kernel`
(CUDA: `csrc/rms_norm.cu`, one trip to memory in the launch `norm_plan`
gives): the whole norm in f32 with one rounding to x.dtype, which in bf16
is not the unfused `ops/basic.py:rms_norm` (two roundings).
`USE_FUSED_NORM` (a module attribute, off by default, as in the JAX
package: there is no environment variable) makes `rms_norm` take it;
`can_fuse_norm` is the gate. The TPU launcher's row tiles and its rule that
d be a multiple of 128 are not carried over. It counts
`fused_rms_norm.launches`.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from llamago_tpu_torch.ops import _build
from llamago_tpu_torch.ops.quant import G4X8, QK, dequantize, unpack_q4, unpack_w4x8
from llamago_tpu_torch.utils.timing import H100_SMS

# The most rows the decode forms take (the n8 columns of B)
_DECODE_MAX_M = 8
# The tensor-core tiles of K1 (csrc/dequant_matmul.cu) and K6
# (csrc/w4x8_matmul.cu): rows and columns per block, the blocks below which
# they split K (two per SM), how many they then aim for, and the fewest rows
# of K in a split (where K allows). K1 aims for four blocks per SM (on the
# card four took 5% off its prefill pass at m = 64 against two); K6 for one
# wave of the three its shared-memory ring lets an SM hold (on the card 5-6%
# off its pass at m = 64 against four). With f32 x as three bf16 planes
# both aim for one wave of three blocks an SM (what their rings leave; K1
# with bf16 scales holds two by its registers), and K6's blocks take 32
# rows (three planes of 64 would leave one block an SM)
_TC_ROWS, _TC_COLS = 64, 128
_TC_MIN_BLOCKS, _TC_TARGET_BLOCKS = 2 * H100_SMS, 4 * H100_SMS
_W4X8_TC_TARGET_BLOCKS = 3 * H100_SMS
_F32_TC_TARGET_BLOCKS = 3 * H100_SMS
_W4X8_F32_TC_ROWS = 32
_TC_MIN_SPLIT_ROWS = 256
# K1's tensor-core decode form (csrc/dequant_matmul.cu, dq_decode_tc):
# columns per block, the most blocks it launches (one wave of the three an
# SM holds: on the card a second, partial wave cost 2-3% of a 7B step) and
# the fewest quant blocks in a split
_DT_COLS = 512
_DT_MAX_BLOCKS = 3 * H100_SMS
_DT_MIN_SPLIT_BLOCKS = 4
# K1's and K9's forms by the code both C entry points take (code 0 was K9's
# GEMV, which is gone)
K1_FORMS = {"f32_tc": 1, "tensor_core": 2, "decode_tc": 3, "f32_decode_tc": 4}

# Rows up to which a w4x8 leaf takes K5, whose int8 activation rounding
# changes the numerics; above it K6 (exact given the format).
_W4X8_A8_MAX_M = int(os.environ.get("LLAMAGO_W4X8_A8_MAX_M", "16"))
# The int8 tensor-core decode form (csrc/decode_i8_tc.cuh) of K5 and the
# lab's integer rows: columns a block covers, slots of x an n8 tile holds,
# the fewest steps of 32 rows of K in a split (where K allows)
_IT_COLS = 512
_IT_TILE_SLOTS = 8
_IT_MIN_SPLIT_STEPS = 4
# The w4x8 forms, numbered as the C entry points take them: K5, and K6's
# tensor-core tile with f32 and with bf16 x
W4X8_FORMS = ("a8", "f32_tc", "tensor_core")

# Rows (padded up to 8, as the TPU launcher pads them) at or below which a
# Q8_0 / Q4_0 leaf takes K9. Off by default, as in the JAX package.
SCALE_ON_OUTPUT_MAX_M = int(os.environ.get("LLAMAGO_KERNEL_SO_MAX_M", "0"))

# 1/127 rounded to f32: XLA compiles JAX's `amax / 127.0` to this product
_INV_127 = float(torch.tensor(1.0, dtype=torch.float32) / 127.0)

# rms_norm takes K10 when set (module docstring).
USE_FUSED_NORM = False


# ------------------------------------------------------------ plain versions

def dequant_matmul_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain PyTorch K1 (Q8_0 or Q4_0 leaf; any leaf `dequantize` takes):
    dequantize to f32, f32 product, cast to x.dtype."""
    k = x.shape[-1]
    deq = dequantize(w, torch.float32)
    out = x.reshape(-1, k).to(torch.float32) @ deq
    return out.reshape(*x.shape[:-1], deq.shape[-1]).to(x.dtype)


def dequant_matmul_so_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain PyTorch K9: per 32-block, the raw integers (int8, or nibbles
    0..15) dotted with the block's x in f32; a Q4_0 block then subtracts
    8 * sum(x_block); times the block's scale; summed over the blocks."""
    k = x.shape[-1]
    nb = k // QK
    xb = x.reshape(-1, nb, QK).to(torch.float32)  # [m, nb, 32]
    if "q8" in w:
        q = w["q8"].to(torch.float32)
    else:
        q = unpack_q4(w["q4"]).to(torch.float32) + 8.0  # raw nibbles
    n = q.shape[-1]
    part = torch.einsum("mbk,bkn->mbn", xb, q.reshape(nb, QK, n))
    if "q4" in w:
        part = part - 8.0 * xb.sum(dim=-1)[..., None]
    out = (part * w["s"].to(torch.float32)[None]).sum(dim=1)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)


def quantize_activations_a8(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's activation quantization of x [m, K], plain PyTorch: per (row,
    128-group) sx = amax * fl(1/127) (1 where amax is 0) and xq =
    clip(round_half_even(x / sx), +-127). Returns xq int8 [m, K] and sx f32
    [m, K/128], bit for bit what the JAX launcher computes."""
    m, k = x2.shape
    x3 = x2.to(torch.float32).reshape(m, k // G4X8, G4X8)
    amax = x3.abs().amax(dim=-1)
    sx = torch.where(amax > 0, amax * _INV_127, torch.ones_like(amax))
    xq = torch.clamp(torch.round(x3 / sx[..., None]), -127, 127).to(torch.int8)
    return xq.reshape(m, k), sx


def w4x8_matmul_a8_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain PyTorch K5: x quantized to int8 per (row, 128-group), an exact
    integer dot with the centered int4 weights per group (f32 einsum: a
    group's dot stays below 2^24), then acc += d * sx[g] * s[g] in f32."""
    k = x.shape[-1]
    g = k // G4X8
    xq, sx = quantize_activations_a8(x.reshape(-1, k))
    m = xq.shape[0]
    wq = unpack_w4x8(w["q4x"]).to(torch.float32)  # [K, N]
    n = wq.shape[-1]
    d = torch.einsum("mgk,gkn->mgn", xq.to(torch.float32).reshape(m, g, G4X8),
                     wq.reshape(g, G4X8, n))
    sg = w["s"][0::2].to(torch.float32)  # [G, N]: row 2g of the duplicated rows
    out = (d * sx[..., None] * sg[None]).sum(dim=1)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)


def w4x8_matmul_stream_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain PyTorch K6: f32(int4) * f32(s) over 64-row spans, f32 product
    with f32(x), cast to x.dtype. No activation quantization: K1's plain
    version on a w4x8 leaf."""
    return dequant_matmul_plain(x, w)


# ------------------------------------------------------------------ launchers

def k1_form(m: int, x_dtype: torch.dtype) -> str:
    """K1's kernel on the card for m rows of x. bf16 x takes bf16 mma.sync:
    "decode_tc" (the slots are the n8 columns of B) up to 8 rows,
    "tensor_core" (the prefill tile) above. f32 x, which the bf16 tensor
    cores cannot take as it is, takes the same forms on x's three exact
    bf16 parts, hi + mid + lo == x: "f32_decode_tc" up to 8 rows (split in
    the kernel's registers) and "f32_tc" above (split by a pre-pass)."""
    bf16 = x_dtype == torch.bfloat16
    if m <= _DECODE_MAX_M:
        return "decode_tc" if bf16 else "f32_decode_tc"
    return "tensor_core" if bf16 else "f32_tc"


def decode_tc_split_for(k: int, n: int) -> tuple[int, int]:
    """(ksplit, quant blocks per split) of the tensor-core decode form (K1's
    and K9's, bf16 or f32 x): as many splits as one wave of
    `_DT_MAX_BLOCKS` blocks of 512 columns holds, each of at least 4 quant
    blocks where K allows, none empty. The C side cuts the splits at
    ceil(K/32 / ksplit), which is the second number."""
    nb = k // QK
    strips = -(-n // _DT_COLS)
    ksplit = max(1, min(nb // _DT_MIN_SPLIT_BLOCKS, _DT_MAX_BLOCKS // strips))
    per = -(-nb // ksplit)
    return -(-nb // per), per


def tc_split_for(m: int, k: int, n: int, unit: int = QK,
                 target: int = _TC_TARGET_BLOCKS, rows: int = _TC_ROWS) -> tuple[int, int]:
    """(ksplit, units per split) of a tensor-core tile whose K comes in
    units of `unit` rows, each with its own scale (K1: 32-row quant blocks;
    K6: 128-row groups), over output tiles of `rows` rows by 128 columns:
    no split when the output tiles alone give 264 blocks (two per SM), else
    enough splits for about `target` blocks, each of at least 256 rows of K
    (8 quant blocks, 2 groups) where K allows, none empty. The C side takes
    ksplit and cuts the splits at ceil(K/unit / ksplit), which is the
    second number."""
    nb = k // unit
    blocks = -(-n // _TC_COLS) * -(-m // rows)
    if blocks >= _TC_MIN_BLOCKS:
        return 1, nb
    min_units = max(1, _TC_MIN_SPLIT_ROWS // unit)
    ksplit = max(1, min(nb // min_units, -(-target // blocks)))
    per = -(-nb // ksplit)
    return -(-nb // per), per


def f32_tc_workspace(m: int, k: int, n: int, ksplit: int) -> int:
    """f32 workspace elements of the tensor-core tile with f32 x (K1's and
    K6's "f32_tc"): x's three bf16 planes (3 * m * k bf16), then the split-K
    partials when it splits K."""
    return 3 * m * k // 2 + (ksplit * m * n if ksplit > 1 else 0)


def k1_plan(m: int, k: int, n: int, x_dtype: torch.dtype) -> tuple[str, int, int]:
    """(form, ksplit, f32 workspace elements) of one K1 launch over m rows."""
    form = k1_form(m, x_dtype)
    if form == "f32_tc":
        ksplit = tc_split_for(m, k, n, target=_F32_TC_TARGET_BLOCKS)[0]
        return form, ksplit, f32_tc_workspace(m, k, n, ksplit)
    ksplit = (tc_split_for(m, k, n) if form == "tensor_core" else decode_tc_split_for(k, n))[0]
    return form, ksplit, ksplit * m * n if ksplit > 1 else 0


def k9_form(m: int, x_dtype: torch.dtype) -> str:
    """K9's kernel on the card for m rows of x: K1's (`k1_form`) on the raw
    integers. Above 8 rows, which only a switch above 8 reaches, the
    tensor-core tile ("tensor_core", "f32_tc")."""
    return k1_form(m, x_dtype)


def k9_workspace(m: int, k: int, n: int, ksplit: int) -> int:
    """f32 workspace elements of K9's tile with f32 x ("f32_tc"): x's three
    bf16 planes (3 * m * k bf16), x's block sums [K/32, m rounded up to 4]
    (the raw Q4_0 nibbles' offset; a quant block's rows start 16-byte
    aligned, and so do the partials after them), then the split-K partials
    when it splits K."""
    sums = (k // QK) * (-(-m // 4) * 4)
    return 3 * m * k // 2 + sums + (ksplit * m * n if ksplit > 1 else 0)


def k9_plan(m: int, k: int, n: int, x_dtype: torch.dtype) -> tuple[str, int, int]:
    """(form, ksplit, f32 workspace elements) of one K9 launch over m rows:
    each form splits K as K1's does (`k1_plan`); the tile with f32 x keeps
    x's block sums beside its planes."""
    form, ksplit, ws = k1_plan(m, k, n, x_dtype)
    return form, ksplit, k9_workspace(m, k, n, ksplit) if form == "f32_tc" else ws


def w4x8_form(m: int, x_dtype: torch.dtype) -> str:
    """The w4x8 matmul's kernel on the card for m rows of x: "a8" (K5) when
    max(8, m) is at most `_W4X8_A8_MAX_M` (the TPU launcher pads m up to 8);
    above, K6's tensor-core tile (bf16 mma.sync): "tensor_core" for bf16 x
    and "f32_tc" for f32 x, which the bf16 tensor cores cannot take as it
    is, on its three exact bf16 parts."""
    if max(8, m) <= _W4X8_A8_MAX_M:
        return "a8"
    return "tensor_core" if x_dtype == torch.bfloat16 else "f32_tc"


def w4x8_plan(m: int, k: int, n: int, x_dtype: torch.dtype) -> tuple[str, int, int]:
    """(form, ksplit, f32 workspace elements of the split-K partials) of one
    w4x8 launch over m rows."""
    form = w4x8_form(m, x_dtype)
    if form == "a8":
        ksplit = a8_split_for(m, k, n)[0]
        return form, ksplit, ksplit * m * n
    if form == "tensor_core":
        ksplit = tc_split_for(m, k, n, G4X8, _W4X8_TC_TARGET_BLOCKS)[0]
        return form, ksplit, ksplit * m * n if ksplit > 1 else 0
    ksplit = tc_split_for(m, k, n, G4X8, _F32_TC_TARGET_BLOCKS, _W4X8_F32_TC_ROWS)[0]
    return form, ksplit, f32_tc_workspace(m, k, n, ksplit)


def i8tc_blocks_per_sm(tiles: int) -> int:
    """Blocks of the int8 tensor-core decode form an SM holds with `tiles`
    n8 tiles of slots (csrc/decode_i8_tc.cuh it_blocks_per_sm): three with
    one, two with two (twice the sums in registers)."""
    return 3 if tiles == 1 else 2


def i8tc_split(steps: int, blocks: int, group: int, wave: int) -> tuple[int, int]:
    """(ksplit, steps per split) of the int8 tensor-core decode form over
    `steps` steps of 32 rows of K beside `blocks` blocks of columns and
    rows: as many splits as one wave of `wave` blocks holds, each of at
    least 4 steps where K allows, none empty. A split of at least a scale
    group of `group` steps holds whole groups (its int32 sums are the
    group's); a shorter one folds its part of a group. The C side takes
    ksplit and the second number."""
    ksplit = max(1, min(steps // _IT_MIN_SPLIT_STEPS, wave // blocks))
    per = -(-steps // ksplit)
    if per >= group:
        per = -(-per // group) * group
    return -(-steps // per), per


def a8_slots(m: int) -> tuple[int, int]:
    """(n8 tiles of slots a K5 block takes, slots sx is laid out for): one
    tile up to 8 rows, two above; the rows padded up to whole blocks."""
    tiles = 1 if m <= _IT_TILE_SLOTS else 2
    per_block = tiles * _IT_TILE_SLOTS
    return tiles, -(-m // per_block) * per_block


def a8_split_for(m: int, k: int, n: int) -> tuple[int, int]:
    """(ksplit, groups per split) of K5: splits cut at whole 128-groups as
    far as one wave of blocks (512 columns by one or two n8 tiles of slots)
    holds, none empty."""
    tiles, slots = a8_slots(m)
    blocks = -(-n // _IT_COLS) * (slots // (tiles * _IT_TILE_SLOTS))
    group = G4X8 // QK
    ksplit, per = i8tc_split(k // QK, blocks, group, i8tc_blocks_per_sm(tiles) * H100_SMS)
    return ksplit, per // group


@functools.cache
def _lib():
    fn = _build.library("dequant_matmul").llamago_dequant_matmul
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_so():
    fn = _build.library("dequant_matmul_so").llamago_dequant_matmul_so
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_w4x8():
    lib = _build.library("w4x8_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.llamago_w4x8_quantize_x.argtypes = [p, p, p, i, i, i, p]
    lib.llamago_w4x8_matmul_a8.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.llamago_w4x8_matmul_stream.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.llamago_w4x8_quantize_x, lib.llamago_w4x8_matmul_a8,
               lib.llamago_w4x8_matmul_stream):
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     key: str = "q8") -> None:
    """What the CUDA kernels take: x [m, K] f32 or bf16; `key` "q8": int8
    [K, N] with s [K/32, N]; "q4": uint8 [K/2, N] with s [K/32, N]; "q4x":
    uint8 [K/2, N] with bf16 s [K/64, N], K a multiple of 128. N a multiple
    of 16, everything contiguous, 16-byte aligned and on x's device."""
    m, k = x2.shape
    if q.dim() != 2 or s.dim() != 2:
        raise ValueError(f"dequant_matmul: want 2-D {key}/s, got {tuple(q.shape)}, "
                         f"{tuple(s.shape)}")
    n = q.shape[1]
    unit = G4X8 if key == "q4x" else QK
    q_rows = k if key == "q8" else k // 2
    s_rows = k // 64 if key == "q4x" else k // QK
    if q.shape[0] != q_rows or k % unit or s.shape != (s_rows, n):
        raise ValueError(f"dequant_matmul: shapes x{tuple(x2.shape)} "
                         f"{key}{tuple(q.shape)} s{tuple(s.shape)} do not agree")
    if n % 16:
        raise ValueError(f"dequant_matmul: N={n} must be a multiple of 16")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dequant_matmul: x dtype {x2.dtype} not supported")
    s_dtypes = (torch.bfloat16,) if key == "q4x" else (torch.bfloat16, torch.float32)
    if s.dtype not in s_dtypes or q.dtype != (torch.int8 if key == "q8" else torch.uint8):
        raise ValueError(f"dequant_matmul: {key} {q.dtype} / s {s.dtype} not supported")
    for name, t in (("x", x2), (key, q), ("s", s)):
        if t.device != x2.device:
            raise ValueError(f"dequant_matmul: {name} on {t.device}, x on {x2.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"dequant_matmul: {name} must be contiguous and "
                             "16-byte aligned")


def _rows(x: torch.Tensor) -> torch.Tensor:
    x2 = x.reshape(-1, x.shape[-1])
    return x2 if x2.is_contiguous() else x2.contiguous()


def _stream(x2: torch.Tensor) -> int:
    return torch.cuda.current_stream(x2.device).cuda_stream


def _cuda_or_raise(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")


def w4x8_quantize_x(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's activation quantization alone, on the card (the kernel K5 runs
    first): xq int8 [m, K], sx f32 [m, K/128]. For checking it against
    `quantize_activations_a8`; the serving path goes through `w4x8_matmul`."""
    _cuda_or_raise(x2, "w4x8_quantize_x")
    m, k = x2.shape
    if k % G4X8 or x2.dtype not in (torch.bfloat16, torch.float32) \
            or not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError(f"w4x8_quantize_x: x {tuple(x2.shape)} {x2.dtype} not supported")
    xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m, k // G4X8), dtype=torch.float32, device=x2.device)
    err = _lib_w4x8().llamago_w4x8_quantize_x(
        x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
        int(x2.dtype == torch.bfloat16), _stream(x2))
    _build.check(err, "w4x8_quantize_x")
    return xq, sx


def w4x8_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [..., K] @ w4x8 w {"q4x": uint8 [K/2, N], "s": bf16 [K/64, N]} ->
    [..., N] in x.dtype, in the form `w4x8_form` names: K5 up to
    `_W4X8_A8_MAX_M` rows, K6 above."""
    k = x.shape[-1]
    m = x.numel() // k
    if x.device.type == "cpu":
        a8 = w4x8_form(m, x.dtype) == "a8"
        return (w4x8_matmul_a8_plain if a8 else w4x8_matmul_stream_plain)(x, w)
    _cuda_or_raise(x, "w4x8_matmul")
    q, s = w["q4x"], w["s"]
    x2 = _rows(x)
    _check_cuda_args(x2, q, s, "q4x")
    n = q.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    x_bf16 = int(x2.dtype == torch.bfloat16)
    lib = _lib_w4x8()
    form, ksplit, ws_elems = w4x8_plan(m, k, n, x2.dtype)
    if form == "a8":
        per = a8_split_for(m, k, n)[1]
        # one scratch allocation: sx f32 [K/128, slots], the split-K partial
        # sums f32 [ksplit, m, N], then xq int8 [m, K]
        sx_bytes, ws_bytes = 4 * a8_slots(m)[1] * (k // G4X8), 4 * ws_elems
        scratch = torch.empty(sx_bytes + ws_bytes + m * k, dtype=torch.uint8,
                              device=x2.device)
        sx_ptr = scratch.data_ptr()
        ws_ptr = sx_ptr + sx_bytes
        err = lib.llamago_w4x8_matmul_a8(
            x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), ws_ptr + ws_bytes,
            sx_ptr, ws_ptr, m, k, n, x_bf16, ksplit, per, _stream(x2))
        _build.check(err, "w4x8_matmul (W4A8)")
        w4x8_matmul.launches_a8 += 1
    else:
        ws = torch.empty(ws_elems, dtype=torch.float32, device=x2.device) if ws_elems else out
        err = lib.llamago_w4x8_matmul_stream(
            x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr(), m, k, n,
            x_bf16, W4X8_FORMS.index(form), ksplit, _stream(x2))
        _build.check(err, f"w4x8_matmul ({form})")
        w4x8_matmul.launches_stream += 1
        if form == "tensor_core":
            w4x8_matmul.launches_tc += 1
        else:
            w4x8_matmul.launches_f32_tc += 1
    return out.reshape(*x.shape[:-1], n)


w4x8_matmul.launches_a8 = 0
w4x8_matmul.launches_stream = 0
w4x8_matmul.launches_tc = 0
w4x8_matmul.launches_f32_tc = 0


def _launch_q(lib_fn, what: str, x: torch.Tensor, w: dict, plan) -> tuple[torch.Tensor, str]:
    """Shared launcher of K1 and K9: both C entry points take the same
    arguments (x, q, s, out, workspace, m, K, N, bits, dtypes, form,
    ksplit). `plan(m, k, n, x_dtype)` gives (form, ksplit, workspace
    elements): `k1_plan` for K1, `k9_plan` for K9. Returns the output and
    the form launched."""
    key = "q8" if "q8" in w else "q4"
    q, s = w[key], w["s"]
    x2 = _rows(x)
    _check_cuda_args(x2, q, s, key)
    (m, k), n = x2.shape, q.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    form, ksplit, ws_elems = plan(m, k, n, x2.dtype)
    ws = torch.empty(ws_elems, dtype=torch.float32, device=x2.device) if ws_elems else out
    err = lib_fn()(x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                   ws.data_ptr(), m, k, n, 8 if key == "q8" else 4,
                   int(x2.dtype == torch.bfloat16), int(s.dtype == torch.bfloat16),
                   K1_FORMS[form], ksplit, _stream(x2))
    _build.check(err, what)
    return out.reshape(*x.shape[:-1], n), form


def dequant_matmul_so(x: torch.Tensor, w: dict) -> torch.Tensor:
    """K9: x [..., K] @ Q8_0 / Q4_0 w with the block scales folded into the
    output -> [..., N] in x.dtype, in the form `k9_form` names."""
    if x.device.type == "cpu":
        return dequant_matmul_so_plain(x, w)
    _cuda_or_raise(x, "dequant_matmul_so")
    out, form = _launch_q(_lib_so, "dequant_matmul_so", x, w, k9_plan)
    dequant_matmul_so.launches += 1
    if form == "tensor_core":
        dequant_matmul_so.launches_tc += 1
    elif form == "decode_tc":
        dequant_matmul_so.launches_decode_tc += 1
    elif form == "f32_tc":
        dequant_matmul_so.launches_f32_tc += 1
    else:
        dequant_matmul_so.launches_f32_decode_tc += 1
    return out


dequant_matmul_so.launches = 0  # K9, any form
dequant_matmul_so.launches_decode_tc = 0  # K9's tensor-core decode form
dequant_matmul_so.launches_f32_decode_tc = 0  # the same on f32 x's three parts
dequant_matmul_so.launches_tc = 0  # K9's tensor-core tile
dequant_matmul_so.launches_f32_tc = 0  # the same on f32 x's three parts


def dequant_matmul(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [..., K] @ quantized w -> [..., N] in x.dtype; w is a Q8_0 leaf
    {"q8": int8 [K, N], "s": [K/32, N]}, a Q4_0 leaf {"q4": uint8 [K/2, N],
    "s": [K/32, N]} or a w4x8 leaf {"q4x", "s"} (module docstring)."""
    if "q4x" in w:
        return w4x8_matmul(x, w)
    k = x.shape[-1]
    if max(8, x.numel() // k) <= SCALE_ON_OUTPUT_MAX_M:
        return dequant_matmul_so(x, w)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, w)
    _cuda_or_raise(x, "dequant_matmul")
    out, form = _launch_q(_lib, "dequant_matmul", x, w, k1_plan)
    if "q8" in w:
        dequant_matmul.launches += 1
    else:
        dequant_matmul.launches_q4 += 1
    if form == "tensor_core":
        dequant_matmul.launches_tc += 1
    elif form == "decode_tc":
        dequant_matmul.launches_decode_tc += 1
    elif form == "f32_tc":
        dequant_matmul.launches_f32_tc += 1
    elif form == "f32_decode_tc":
        dequant_matmul.launches_f32_decode_tc += 1
    return out


dequant_matmul.launches = 0
dequant_matmul.launches_q4 = 0
dequant_matmul.launches_tc = 0
dequant_matmul.launches_decode_tc = 0
dequant_matmul.launches_f32_tc = 0
dequant_matmul.launches_f32_decode_tc = 0


class FrozenQuantMatmul(torch.autograd.Function):
    """x @ a quantized leaf with the leaf frozen, for training: the JAX
    package's `dequant_matmul` custom VJP (`_dm_fwd` / `_dm_bwd`). The
    forward is `dequant_matmul`, looked up as this module's attribute at
    each call, so whatever stands there (the kernels, or a plain version
    swapped in) runs under grad as it runs without. The backward is plain
    PyTorch, as JAX computes it outside any kernel: dx = g @ dequantize(w)^T
    in x.dtype; the leaf gets no gradient. Launch counts count the forward
    only. `ops/quant.py:quant_matmul` sends Q8_0, Q4_0 and w4x8 leaves here
    when grad is enabled and x requires it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: dict) -> torch.Tensor:
        ctx.w, ctx.x_dtype = w, x.dtype
        return dequant_matmul(x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # the span's device time is the backward's dequantize + matmul
        with torch.autograd.profiler.record_function(BACKWARD_SPAN):
            deq = dequantize(ctx.w, ctx.x_dtype)
            dx = torch.matmul(g.to(ctx.x_dtype), deq.T)
        return dx, None


# the profiler span around FrozenQuantMatmul's backward
BACKWARD_SPAN = "dequant_matmul_backward"


# ------------------------------------------------------------------ RMSNorm

def fused_rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch K10: in f32, x * rsqrt(mean(x^2) + eps) * w, rounded
    once to x.dtype."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def can_fuse_norm(x: torch.Tensor) -> bool:
    """Whether `rms_norm` takes K10 for x [..., d]: the switch is on and, on
    the card, x is bf16 or f32 (the plain version takes any float dtype)."""
    if not USE_FUSED_NORM or x.numel() == 0:
        return False
    return x.device.type == "cpu" or x.dtype in (torch.bfloat16, torch.float32)


# K10's launch (csrc/rms_norm.cu): the fewest threads a row, at least
# _NORM_MIN_THREADS, whose registers hold the whole row (_NORM_KEEP vectors of
# x and of w a thread, kKeep), at most _NORM_MAX_BLOCK; one row a block. On an
# H100 (k2_pair.py --kernel k10 --k10-threads, bf16, d = 4096) 128 threads a
# row were as fast as 256 and 512 at 4 rows and the fastest at 256 rows, and
# two or four rows a block were slower at 256 rows (PERF.md's K10 row).
_NORM_MIN_THREADS = 128
_NORM_KEEP = 4
_NORM_MAX_BLOCK = 512


def norm_plan(rows: int, d: int, x_dtype: torch.dtype, w_dtype: torch.dtype,
              align: int = 16) -> tuple[int, int]:
    """K10's launch for x [rows, d] of x_dtype times w [d] of w_dtype, the
    three pointers aligned to `align` bytes, one row a block: (threads a
    row, values a vector). A vector is the widest load of x up to 16
    bytes whose values divide d (so every row starts aligned) and whose
    loads of x and of w the pointers allow; never more warps than the row
    has vectors for."""
    wide = max(x_dtype.itemsize, w_dtype.itemsize)
    vec = 1
    while (2 * vec * x_dtype.itemsize <= 16 and d % (2 * vec) == 0
           and min(16, 2 * vec * wide) <= align):
        vec *= 2
    nvec = d // vec
    held = max(_NORM_MIN_THREADS, 32 * -(-nvec // (32 * _NORM_KEEP)))
    threads = min(32 * -(-nvec // 32), held, _NORM_MAX_BLOCK)
    return threads, vec


@functools.cache
def _lib_norm():
    fn = _build.library("rms_norm").llamago_rms_norm
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, ctypes.c_float, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _alignment(*xs: torch.Tensor) -> int:
    """The largest power of two, at most 16, that every start address divides."""
    ptrs = [x.data_ptr() for x in xs]
    return next(a for a in (16, 8, 4, 2, 1) if all(p % a == 0 for p in ptrs))


def fused_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """K10: RMSNorm of x [..., d] times w [d] as one pass, in x.dtype. It
    has no backward, as the JAX package's has none (`jax.grad` through it
    fails there): where grad is enabled and x or w requires it, it raises
    rather than drop the gradient."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "fused_rms_norm (K10) has no backward, as in the JAX package: "
            "train with ops.kernels.USE_FUSED_NORM off")
    if x.device.type == "cpu":
        return fused_rms_norm_plain(x, w, eps)
    _cuda_or_raise(x, "fused_rms_norm")
    x2 = _rows(x)
    rows, d = x2.shape
    if x2.dtype not in (torch.bfloat16, torch.float32) \
            or w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_rms_norm: dtypes x {x.dtype}, w {w.dtype} not supported")
    if w.shape != (d,) or rows < 1 or w.device != x2.device or not w.is_contiguous():
        raise ValueError(f"fused_rms_norm: w {tuple(w.shape)} on {w.device} does not match "
                         f"x {tuple(x.shape)} on {x.device}, or is not contiguous")
    out = torch.empty_like(x2)
    threads, vec = norm_plan(rows, d, x2.dtype, w.dtype, _alignment(x2, w, out))
    err = _lib_norm()(x2.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, eps,
                      int(x2.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), vec,
                      threads, _stream(x2))
    _build.check(err, "fused_rms_norm")
    fused_rms_norm.launches += 1
    return out.reshape(x.shape)


fused_rms_norm.launches = 0
