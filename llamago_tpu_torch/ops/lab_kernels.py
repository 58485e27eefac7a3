"""The kernel lab's small-m quantized matmuls: the functions the lab's
variants compute that the serving path has no kernel for (rows L2, L3 and
L6 to L12 of the lab's table), their plain versions, their launch counts,
and the operand preparation the lab hoists out of its kernels.

Counterpart of the `kern_*` functions and of `make_call`'s `ops_of` in the
JAX package's `scripts/kernel_lab.py`. Every function takes x bf16 [tm, K]
(or its hoisted form), a weight leaf with bf16 scales s [K/32, N], and
gives f32 [tm, N]. Rows L1, L4 and L5 are K1 and K9 of `ops/kernels.py`.

  L2  `i4_matmul`          int4-typed centered values, f32 dequant, f32 dot
  L3  `bf16_dequant_matmul` Q4_0 dequantized to bf16 (one rounding, or the
                            FMA itself in bf16: two), bf16 x, f32 sums
  L6  `w4a8_matmul`        x int8 per (row, 32-block), Q4_0 integers, int32
                            dots per block, times sx * s per block
  L7  `w8a8_matmul`        the same with Q8_0 weights
  L8  `fulltk_matmul`      one int8 dot per k-tile of tk rows with the
                            tile's first scale row as a stand-in
  L9  `bitcast_i4_matmul`  the Q4_0 bytes read as two's-complement nibbles
                            (byte r -> rows 2r, 2r+1), f32 or bf16 dot
  L10 `bitcast_i4_i8dot`   L9's integers dotted with int8 x, scales per
                            k-tile or per 128-group
  L11 `probe`              no product: column sums of the decoded weights,
                            of the lossy mantissa-OR chain, of the packed
                            bytes, or of a corner of every copied span
  L12 `w16_matmul`         raw bf16 weights, bf16 dot, f32 sums

The int4-typed layout of L2 (torch has no int4 dtype): two's-complement
nibbles, two a byte, byte r of a column holding rows 2r (low) and 2r+1
(high): `to_i4` makes it from a Q4_0 leaf and `quant.unpack_w4x8` reads it
back as int8. It is the layout L9 reads the Q4_0 bytes in, so L2 and L9's f32 form
are one CUDA kernel fed different bytes.

tk, the k-tile of the TPU grid, is part of the function for L8, L10 and
the `dma_pure` probe (the scale row and the activation scale of a tile; the
corner of a span); the TPU's n-tile is part of none and is not carried over.

Activation quantization (`quantize_blocks`): sx = amax * fl(1/127), the
product XLA compiles JAX's `amax / 127.0` to, as everywhere in the port;
the JAX lab's hoists run op by op in its correctness check and divide there
(sx one ulp apart at most).

A CPU tensor takes the plain version (`*_plain`); a CUDA tensor takes the
kernel of `csrc/lab_matmul.cu`, or the wrapper raises. The float rows (L2,
L3, L9, L12) run its tensor-core decode form (`lab_plan`): bf16 mma.sync
with the weights as the A operand, 8 rows of x a group, K split into one
wave of blocks; L11's decode_only, decode_bitcast and dma_only run probe
modes of the same form, its ring and split with no x (`probe_plan`). The
integer rows (L6, L7, L8, L10) run K5's int8
tensor-core decode form (`lab_i8_plan`, csrc/decode_i8_tc.cuh): int8
mma.sync with exact int32 sums per scale group, the same layout. Each
wrapper counts its launches (`.launches`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llamago_tpu_torch.ops import _build
from llamago_tpu_torch.ops.kernels import (
    _INV_127,
    _IT_COLS,
    _IT_TILE_SLOTS,
    _cuda_or_raise,
    i8tc_blocks_per_sm,
    i8tc_split,
)
from llamago_tpu_torch.ops.quant import QK, unpack_q4, unpack_w4x8
from llamago_tpu_torch.utils.timing import H100_SMS

G128 = 128  # scale-group size of the g128 variants
HALF = QK // 2
PROBES = ("decode_only", "decode_bitcast", "dma_only", "dma_pure")
_MAGIC = 8388608.0  # 2^23: 0x4B000000 | nib read as f32 is 2^23 + nib


def default_tk(k: int) -> int:
    """The lab's k-tile: 1024 where K is a multiple of it, else 512."""
    return 1024 if k % 1024 == 0 else 512


# ------------------------------------------------------------ layouts, hoists

def to_i4(leaf: dict) -> dict:
    """A Q4_0 leaf {"q4", "s"} as the int4-typed leaf {"i4": uint8 [K/2, N],
    "s"}: the centered values -8..7 of `unpack_q4` in natural row order, as
    two's-complement nibbles, byte r holding rows 2r (low) and 2r+1 (high)."""
    vals = unpack_q4(leaf["q4"]).to(torch.int32) & 0xF  # [K, N]
    k, n = vals.shape
    pairs = vals.reshape(k // 2, 2, n)
    return {"i4": (pairs[:, 0] | (pairs[:, 1] << 4)).to(torch.uint8), "s": leaf["s"]}


def quantize_blocks(x3: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x3 f32 [..., g] -> xq int8 [..., g], sx f32 [...]: sx = amax *
    fl(1/127) (1 where amax is 0), xq = clip(round_half_even(x / sx), +-127)."""
    amax = x3.abs().amax(dim=-1)
    sx = torch.where(amax > 0, amax * _INV_127, torch.ones_like(amax))
    xq = torch.clamp(torch.round(x3 / sx[..., None]), -127, 127).to(torch.int8)
    return xq, sx


def hoist_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [tm, K] -> the bf16 halves (x_lo, x_hi) [tm, K/2] that meet the low
    and the high nibble plane of the packed Q4_0 rows: of every 32-block the
    first and the last 16 values."""
    tm, k = x.shape
    x3 = x.to(torch.bfloat16).reshape(tm, k // QK, QK)
    return (x3[:, :, :HALF].reshape(tm, k // 2).contiguous(),
            x3[:, :, HALF:].reshape(tm, k // 2).contiguous())


def join_split(x_lo: torch.Tensor, x_hi: torch.Tensor) -> torch.Tensor:
    """The inverse of `hoist_split`: x [tm, K]."""
    tm, half = x_lo.shape
    x3 = torch.cat([x_lo.reshape(tm, half // HALF, HALF),
                    x_hi.reshape(tm, half // HALF, HALF)], dim=2)
    return x3.reshape(tm, 2 * half)


def _hoist_groups(x: torch.Tensor, group: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x [tm, K] quantized per (row, group): xq int8 [K/group, tm, group]
    and sx f32 [K/group, tm]."""
    tm, k = x.shape
    x3 = x.to(torch.float32).reshape(tm, k // group, group).transpose(0, 1)
    xq, sx = quantize_blocks(x3)
    return xq.contiguous(), sx.contiguous()


def hoist_a8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [tm, K] -> xq int8 [K/32, tm, 32], sx f32 [K/32, tm]."""
    return _hoist_groups(x, QK)


def hoist_a8full(x: torch.Tensor, tk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x [tm, K] -> xq int8 [tm, K] with one scale per (k-tile, row): sx f32
    [K/tk, tm]."""
    xq, sx = _hoist_groups(x, tk)
    return xq.transpose(0, 1).reshape(x.shape).contiguous(), sx


def hoist_a8g128(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [tm, K] -> xq int8 [tm, K] with one scale per (128-group, row): sx
    f32 [K/128, tm]."""
    return hoist_a8full(x, G128)


def hoist_splitfull(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [tm, K] -> the int8 halves of clip(round(127 x), +-127) (one fixed
    activation scale, a stand-in), split as `hoist_split` splits x."""
    tm, k = x.shape
    x3 = x.to(torch.float32).reshape(tm, k // QK, QK)
    xq = torch.clamp(torch.round(x3 * 127.0), -127, 127).to(torch.int8)
    return (xq[:, :, :HALF].reshape(tm, k // 2).contiguous(),
            xq[:, :, HALF:].reshape(tm, k // 2).contiguous())


# ------------------------------------------------------------ plain versions

def _block_scales(s: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """s [K/32, N] -> one scale per row [K, N]."""
    return torch.repeat_interleave(s.to(dtype), QK, dim=0)


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An exact integer product a [..., m, k] @ b [..., k, n] of int8-sized
    values, rounded to f32 as an int32 sum converts (f64 holds it exactly)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.float32)


def i4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, s: torch.Tensor,
                    bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch L2 and L9: two's-complement nibbles (byte r -> rows 2r,
    2r+1) times s[row // 32]. f32: f32 weights, f32 product. `bf16`: the
    product int4 * s taken in bf16 (one rounding), x in bf16, exact products
    summed in f32."""
    vals = unpack_w4x8(packed)
    if bf16:
        w = (vals.to(torch.bfloat16) * _block_scales(s, torch.bfloat16)).to(torch.float32)
        return x.to(torch.bfloat16).to(torch.float32) @ w
    return x.to(torch.float32) @ (vals.to(torch.float32) * _block_scales(s))


def _raw_nibbles(q4: torch.Tensor) -> torch.Tensor:
    """Q4_0 bytes [K/2, N] -> raw nibbles 0..15 as f32 [K, N], natural rows."""
    return unpack_q4(q4).to(torch.float32) + 8.0


def bf16_dequant_matmul_plain(x: torch.Tensor, leaf: dict,
                              fma_in_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch L3. w = nib * s - 8 s, exact in f32, rounded to bf16
    once (`bf16dot`); or with `fma_in_bf16` (`split_bf16_h`) nib * s rounded
    to bf16 and the sum with bf16(-8 s) rounded again. x in bf16; a product
    of two bf16 values is exact in f32 and the sums are f32."""
    s = _block_scales(leaf["s"])
    nib = _raw_nibbles(leaf["q4"])
    if fma_in_bf16:
        sb = s.to(torch.bfloat16)
        w = nib.to(torch.bfloat16) * sb + (-8.0 * s).to(torch.bfloat16)
    else:
        w = (nib * s + (-8.0 * s)).to(torch.bfloat16)
    return x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)


def _block_weights(leaf: dict) -> torch.Tensor:
    """The integers of a Q8_0 or Q4_0 leaf as [K/32, 32, N]."""
    q = leaf["q8"] if "q8" in leaf else unpack_q4(leaf["q4"])
    return q.reshape(q.shape[0] // QK, QK, q.shape[1])


def a8_block_matmul_plain(xq: torch.Tensor, sx: torch.Tensor, leaf: dict) -> torch.Tensor:
    """Plain PyTorch L6 and L7 on the hoisted operands xq int8 [K/32, tm, 32]
    and sx f32 [K/32, tm]: an exact integer dot per 32-block, times sx, times
    s, summed over the blocks in f32."""
    d = _int_dot(xq, _block_weights(leaf))  # [K/32, tm, N]
    return (d * sx[:, :, None] * leaf["s"].to(torch.float32)[:, None, :]).sum(dim=0)


def w8a8_fulltk_plain(xq: torch.Tensor, sx: torch.Tensor, leaf: dict, tk: int) -> torch.Tensor:
    """Plain PyTorch L8, `w8a8_fulltk`: per k-tile one integer dot of xq
    [tm, K] with the Q8_0 integers, times sx[tile], times the tile's first
    scale row."""
    return _tile_dot_plain(xq, sx, leaf["q8"], leaf["s"], tk, tk)


def _tile_dot_plain(xq, sx, w8, s, tk: int, group: int) -> torch.Tensor:
    """Per k-tile ki and group g of `group` rows in it: dot(xq, w8) over the
    group, times sx[ki * tk/group + g], times row ki * tk/32 + g of s."""
    tm, k = xq.shape
    n = w8.shape[1]
    tiles, gpt = k // tk, tk // group
    d = _int_dot(xq.reshape(tm, k // group, group).transpose(0, 1),
                 w8.reshape(k // group, group, n))  # [K/group, tm, N]
    rows = (torch.arange(tiles, device=s.device)[:, None] * (tk // QK)
            + torch.arange(gpt, device=s.device)[None, :]).reshape(-1)
    return (d * sx[:, :, None] * s.to(torch.float32)[rows][:, None, :]).sum(dim=0)


def w4a8_split_fulltk_plain(x_lo: torch.Tensor, x_hi: torch.Tensor, leaf: dict,
                            tk: int) -> torch.Tensor:
    """Plain PyTorch L8, `w4a8_split_fulltk`: per k-tile the raw nibble
    planes dotted with the int8 x halves, minus 8 * sum(xq), times the
    tile's first scale row. No activation scale."""
    tm, half = x_lo.shape
    p = leaf["q4"].to(torch.int32)
    n = p.shape[1]
    tiles, th = 2 * half // tk, tk // 2
    acc = (_int_dot(x_lo.reshape(tm, tiles, th).transpose(0, 1),
                    (p & 0xF).reshape(tiles, th, n))
           + _int_dot(x_hi.reshape(tm, tiles, th).transpose(0, 1),
                      ((p >> 4) & 0xF).reshape(tiles, th, n)))  # [tiles, tm, N]
    xsum = (x_lo.to(torch.float32).reshape(tm, tiles, th).sum(dim=2)
            + x_hi.to(torch.float32).reshape(tm, tiles, th).sum(dim=2)).transpose(0, 1)
    s0 = leaf["s"].to(torch.float32)[:: tk // QK]  # [tiles, N]
    return ((acc - 8.0 * xsum[:, :, None]) * s0[:, None, :]).sum(dim=0)


def bitcast_i4_i8dot_plain(xq: torch.Tensor, sx: torch.Tensor, leaf: dict, tk: int,
                           g128: bool = False) -> torch.Tensor:
    """Plain PyTorch L10: the Q4_0 bytes as two's-complement nibbles (byte r
    -> rows 2r, 2r+1) dotted with xq int8 [tm, K]; per k-tile with sx
    [K/tk, tm] and the tile's first scale row, or with `g128` per 128-group
    g of tile ki with sx [K/128, tm] and scale row ki * tk/32 + g."""
    return _tile_dot_plain(xq, sx, unpack_w4x8(leaf["q4"]), leaf["s"], tk,
                           G128 if g128 else tk)


def probe_plain(kind: str, leaf: dict, tm: int, tk: int) -> torch.Tensor:
    """Plain PyTorch L11: one [N] vector in every one of tm rows.
    `decode_only`: column sums of (nib - 8) * s. `decode_bitcast`: column
    sums of the mantissa-OR chain with the magic constant folded into a
    bias, ((f_lo * s + bias) + f_hi * s) + bias with f = 2^23 + nib and bias
    = fl(-(2^23 + 8) * s), every product and sum rounded on its own (no
    fused multiply-add): lossy by design. `dma_only`: column sums of the
    packed bytes. `dma_pure`: column sums of the first 8 packed rows of
    every tk/2-row span."""
    q4, s = leaf["q4"], leaf["s"].to(torch.float32)
    half, n = q4.shape
    if kind == "decode_only":
        v = (unpack_q4(q4).to(torch.float32) * _block_scales(s)).sum(dim=0)
    elif kind == "decode_bitcast":
        p = q4.to(torch.int32).reshape(half // HALF, HALF, n)
        f_lo = (p & 0xF).to(torch.float32) + _MAGIC
        f_hi = ((p >> 4) & 0xF).to(torch.float32) + _MAGIC
        sb = s[:, None, :]
        bias = (-(_MAGIC + 8.0)) * sb
        v = (((f_lo * sb + bias) + f_hi * sb) + bias).sum(dim=(0, 1))
    elif kind == "dma_only":
        v = q4.to(torch.float64).sum(dim=0).to(torch.float32)
    elif kind == "dma_pure":
        v = q4.reshape(2 * half // tk, tk // 2, n)[:, :8].to(torch.float64).sum(
            dim=(0, 1)).to(torch.float32)
    else:
        raise ValueError(f"probe: unknown kind {kind!r}")
    return v[None, :].expand(tm, n).contiguous()


def w16_matmul_plain(x: torch.Tensor, w16: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch L12: bf16 x times raw bf16 weights, f32 sums."""
    return x.to(torch.bfloat16).to(torch.float32) @ w16.to(torch.float32)


# ------------------------------------------------------------------ launchers

# modes of llamago_lab_fmatmul (csrc/lab_matmul.cu)
_F_I4, _F_I4_BF16, _F_Q4_BF16, _F_Q4_BF16_FMA, _F_W16 = range(5)
_F_MODES = (_F_I4, _F_I4_BF16, _F_Q4_BF16, _F_Q4_BF16_FMA, _F_W16)
# The tensor-core decode form of the float rows (lab_decode_tc): columns a
# block covers, rows of x a block takes (the rest go to grid z), the blocks
# an SM holds (lt_blocks_per_sm: two for L12's 102 KB ring, three for the
# nibble modes') and the fewest quant blocks in a split
_LT_COLS, _LT_ROWS = 512, 8
_LT_MIN_SPLIT_BLOCKS = 4
# weight formats and x layouts of llamago_lab_imatmul (csrc/decode_i8_tc.cuh
# kItQ8, kItQ4Raw, kItI4; kItXRows, kItXBlocks, kItXHalves)
_W_Q8, _W_Q4, _W_I4 = range(3)
_X_ROWS, _X_BLOCKS, _X_HALVES = range(3)
_PROBE_MODE = {kind: i for i, kind in enumerate(PROBES)}


@functools.cache
def _lib():
    lib = _build.library("lab_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.llamago_lab_fmatmul.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.llamago_lab_imatmul.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.llamago_lab_quantize_x.argtypes = [p, p, p, i, i, p]
    lib.llamago_lab_probe.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.llamago_lab_fmatmul, lib.llamago_lab_imatmul,
               lib.llamago_lab_quantize_x, lib.llamago_lab_probe):
        fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(what: str, dev: torch.device, tensors: dict, k: int, n: int) -> None:
    """What every lab kernel asks of its operands: `tensors` maps a name to
    (tensor, dtype, shape); all on `dev`, contiguous and 16-byte aligned; K a
    multiple of 32, N of 16."""
    if k % QK or n % 16:
        raise ValueError(f"{what}: K={k} must be a multiple of 32 and N={n} of 16")
    for name, (t, dtype, shape) in tensors.items():
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, expected {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


def _check_tm(what: str, tm: int) -> None:
    if tm < 8 or tm % 8:
        raise ValueError(f"{what}: the row count {tm} must be a multiple of 8 (the lab "
                         "pads x to max(8, m) rows)")


def ksplit_for(k: int, rows: int) -> int:
    """Blocks along K of a probe: one per `rows` rows."""
    return -(-k // rows)


def probe_plan(k: int, n: int) -> tuple[int, int]:
    """(ksplit, quant blocks per split) of L11's decode_only, decode_bitcast
    and dma_only, probe modes of the float rows' tensor-core decode form:
    K split as `lab_plan` splits it for one group of 8 rows in the nibble
    modes (one wave of three blocks an SM of 512 columns, at least 4 quant
    blocks a split where K allows, none empty)."""
    ksplit = lab_plan(_LT_ROWS, k, n, _F_Q4_BF16)[0]
    return ksplit, -(-(k // QK) // ksplit)


def lab_plan(tm: int, k: int, n: int, mode: int) -> tuple[int, int]:
    """(ksplit, f32 workspace elements) of one launch of the float rows'
    tensor-core decode form (modes `_F_*`; tm a multiple of 8, one group of
    8 rows of x a grid z): K is split into as many parts as one wave of
    blocks (512 columns by 8 rows by a part of K; two blocks an SM in L12,
    three in the nibble modes) holds, each of at least 4 quant blocks where
    K allows, none empty (the C side cuts the parts at ceil(K/32 /
    ksplit)). The workspace holds the parts' partials when K is split."""
    if mode not in _F_MODES:
        raise ValueError(f"lab_plan: unknown mode {mode}")
    _check_tm("lab_plan", tm)
    nb = k // QK
    blocks = -(-n // _LT_COLS) * (tm // _LT_ROWS)
    wave = (2 if mode == _F_W16 else 3) * H100_SMS
    ksplit = max(1, min(nb // _LT_MIN_SPLIT_BLOCKS, wave // blocks))
    per = -(-nb // ksplit)
    ksplit = -(-nb // per)
    return ksplit, ksplit * tm * n if ksplit > 1 else 0


def lab_i8_plan(tm: int, k: int, n: int, sg_units: int) -> tuple[int, int, int]:
    """(ksplit, quant blocks per split, f32 workspace elements) of one
    launch of the integer rows' int8 tensor-core decode form (tm a multiple
    of 8, one group of 8 rows of x a grid z; a scale group of `sg_units`
    quant blocks): K is split into as many parts as one wave of blocks (512
    columns by 8 rows by a part of K, three an SM) holds, each of at least 4
    quant blocks where K allows, none empty; a part of at least a scale
    group holds whole groups (`kernels.i8tc_split`). The workspace holds the
    parts' partials when K is split."""
    _check_tm("lab_i8_plan", tm)
    blocks = -(-n // _IT_COLS) * (tm // _IT_TILE_SLOTS)
    ksplit, per = i8tc_split(k // QK, blocks, sg_units, i8tc_blocks_per_sm(1) * H100_SMS)
    return ksplit, per, ksplit * tm * n if ksplit > 1 else 0


def _fmatmul(what: str, mode: int, x, x_hi, q, q_dtype, q_rows: int, s) -> torch.Tensor:
    """Launch the float rows' kernel by `lab_plan`: x bf16 [tm, K]
    (or the halves x, x_hi [tm, K/2]), q of `q_rows` rows for every two rows
    of K (1 packed, 2 for bf16 weights) and N columns, s bf16 [K/32, N] ->
    f32 [tm, N]."""
    _cuda_or_raise(x, what)
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [tm, K], got {tuple(x.shape)}")
    tm = x.shape[0]
    k = x.shape[1] * (2 if x_hi is not None else 1)
    n = q.shape[1] if q.dim() == 2 else 0
    ops = {"x": (x, torch.bfloat16, x.shape), "w": (q, q_dtype, (q_rows * k // 2, n)),
           "s": (s, torch.bfloat16, (k // QK, n))}
    if x_hi is not None:
        ops["x_hi"] = (x_hi, torch.bfloat16, x.shape)
    _check(what, x.device, ops, k, n)
    _check_tm(what, tm)
    ksplit, ws_elems = lab_plan(tm, k, n, mode)
    out = torch.empty((tm, n), dtype=torch.float32, device=x.device)
    ws = torch.empty(ws_elems, dtype=torch.float32, device=x.device) if ws_elems else None
    err = _lib().llamago_lab_fmatmul(
        x.data_ptr(), 0 if x_hi is None else x_hi.data_ptr(), q.data_ptr(), s.data_ptr(),
        out.data_ptr(), 0 if ws is None else ws.data_ptr(), tm, k, n, mode, ksplit,
        _stream(x))
    _build.check(err, what)
    return out


def _imatmul(what: str, wfmt: int, xlayout: int, xq, xq_hi, sx, sx_rows: int, q, s,
             sg_units: int, tile_units: int) -> torch.Tensor:
    """Launch the integer rows' kernel by `lab_i8_plan`. xq int8 in
    `xlayout` ([tm, K]; [K/32, tm, 32]; the halves xq, xq_hi [tm, K/2]); sx
    f32 [sx_rows, tm] or None (activation scale 1); q int8 [K, N] or uint8
    [K/2, N]; s bf16 [K/32, N]. A scale group is `sg_units` 32-blocks, a
    k-tile `tile_units`."""
    _cuda_or_raise(xq, what)
    if xq.dim() != (3 if xlayout == _X_BLOCKS else 2) or \
            (xlayout == _X_BLOCKS and xq.shape[2] != QK):
        raise ValueError(f"{what}: xq {tuple(xq.shape)} is not in the expected layout")
    if xlayout == _X_BLOCKS:
        tm, k = xq.shape[1], xq.shape[0] * QK
    else:
        tm, k = xq.shape[0], xq.shape[1] * (2 if xlayout == _X_HALVES else 1)
    n = q.shape[1] if q.dim() == 2 else 0
    ops = {"xq": (xq, torch.int8, xq.shape),
           "w": (q, torch.int8 if wfmt == _W_Q8 else torch.uint8,
                 (k if wfmt == _W_Q8 else k // 2, n)),
           "s": (s, torch.bfloat16, (k // QK, n))}
    if xq_hi is not None:
        ops["xq_hi"] = (xq_hi, torch.int8, xq.shape)
    if sx is not None:
        ops["sx"] = (sx, torch.float32, (sx_rows, tm))
    _check(what, xq.device, ops, k, n)
    _check_tm(what, tm)
    if (k // QK) % tile_units or tile_units % sg_units:
        raise ValueError(f"{what}: K={k} rows do not divide into k-tiles of "
                         f"{tile_units * QK} and scale groups of {sg_units * QK}")
    ksplit, per, ws_elems = lab_i8_plan(tm, k, n, sg_units)
    out = torch.empty((tm, n), dtype=torch.float32, device=xq.device)
    ws = torch.empty(ws_elems, dtype=torch.float32, device=xq.device) if ws_elems else None
    err = _lib().llamago_lab_imatmul(
        xq.data_ptr(), 0 if xq_hi is None else xq_hi.data_ptr(),
        0 if sx is None else sx.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), tm, k, n, wfmt, xlayout, sg_units, tile_units,
        ksplit, per, _stream(xq))
    _build.check(err, what)
    return out


def quantize_x_blocks_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`hoist_a8`'s values made on the card, by the kernel that the variants
    of L6 and L7 which quantize x themselves run first, laid for the matmul:
    xq int8 [tm, K], sx f32 [K/32, tm]."""
    _cuda_or_raise(x, "lab quantize_x")
    tm, k = x.shape
    _check("lab quantize_x", x.device, {"x": (x, torch.bfloat16, (tm, k))}, k, 16)
    xq = torch.empty((tm, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((k // QK, tm), dtype=torch.float32, device=x.device)
    err = _lib().llamago_lab_quantize_x(x.data_ptr(), xq.data_ptr(), sx.data_ptr(), tm, k,
                                        _stream(x))
    _build.check(err, "lab quantize_x")
    return xq, sx


def i4_matmul(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """L2: x bf16 [tm, K] @ the int4-typed leaf {"i4": uint8 [K/2, N], "s"}
    (`to_i4`) dequantized to f32 -> f32 [tm, N]."""
    if x.device.type == "cpu":
        return i4_matmul_plain(x, leaf["i4"], leaf["s"])
    out = _fmatmul("i4_matmul", _F_I4, x, None, leaf["i4"], torch.uint8, 1, leaf["s"])
    i4_matmul.launches += 1
    return out


i4_matmul.launches = 0


def bf16_dequant_matmul(x, leaf: dict, fma_in_bf16: bool = False) -> torch.Tensor:
    """L3: Q4_0 dequantized to bf16 times bf16 x, f32 sums -> f32 [tm, N].
    `bf16dot`: x bf16 [tm, K], w rounded once. `fma_in_bf16`
    (`split_bf16_h`): x is the pair of halves of `hoist_split` and the FMA
    nib * s - 8 s runs in bf16."""
    x_lo, x_hi = x if fma_in_bf16 else (x, None)
    if x_lo.device.type == "cpu":
        xf = join_split(x_lo, x_hi) if fma_in_bf16 else x_lo
        return bf16_dequant_matmul_plain(xf, leaf, fma_in_bf16)
    out = _fmatmul("bf16_dequant_matmul", _F_Q4_BF16_FMA if fma_in_bf16 else _F_Q4_BF16,
                   x_lo, x_hi, leaf["q4"], torch.uint8, 1, leaf["s"])
    bf16_dequant_matmul.launches += 1
    return out


bf16_dequant_matmul.launches = 0


def _a8_block_matmul(fn, what: str, key: str, x, leaf: dict, hoisted: bool) -> torch.Tensor:
    """L6 / L7: `x` is bf16 [tm, K], quantized here per (row, 32-block) (on
    the card by the kernel that runs first), or with `hoisted` the pair
    (xq [K/32, tm, 32], sx [K/32, tm]) of `hoist_a8`."""
    if (x[0] if hoisted else x).device.type == "cpu":
        xq, sx = x if hoisted else hoist_a8(x)
        return a8_block_matmul_plain(xq, sx, leaf)
    wfmt = _W_Q8 if key == "q8" else _W_Q4
    if hoisted:
        xq, sx = x
        out = _imatmul(what, wfmt, _X_BLOCKS, xq, None, sx, xq.shape[0], leaf[key],
                       leaf["s"], 1, 1)
    else:
        xq, sx = quantize_x_blocks_cuda(x)
        out = _imatmul(what, wfmt, _X_ROWS, xq, None, sx, sx.shape[0], leaf[key],
                       leaf["s"], 1, 1)
    fn.launches += 1
    return out


def w4a8_matmul(x, leaf: dict, hoisted: bool = False) -> torch.Tensor:
    """L6: x int8 per (row, 32-block), the centered Q4_0 integers, int32
    dots per block, times sx * s per block -> f32 [tm, N]."""
    return _a8_block_matmul(w4a8_matmul, "w4a8_matmul", "q4", x, leaf, hoisted)


w4a8_matmul.launches = 0


def w8a8_matmul(x, leaf: dict, hoisted: bool = False) -> torch.Tensor:
    """L7: the same with the Q8_0 integers as they are."""
    return _a8_block_matmul(w8a8_matmul, "w8a8_matmul", "q8", x, leaf, hoisted)


w8a8_matmul.launches = 0


def fulltk_matmul(xs: tuple, leaf: dict, tk: int) -> torch.Tensor:
    """L8: one int8 dot per k-tile of tk rows with the tile's first scale
    row. A Q8_0 leaf (`w8a8_fulltk`) takes xs = (xq [tm, K], sx [K/tk, tm])
    of `hoist_a8full`; a Q4_0 leaf (`w4a8_split_fulltk`) the int8 halves of
    `hoist_splitfull` and no activation scale."""
    a, b = xs
    tile_units = tk // QK
    if a.device.type == "cpu":
        if "q8" in leaf:
            return w8a8_fulltk_plain(a, b, leaf, tk)
        return w4a8_split_fulltk_plain(a, b, leaf, tk)
    if "q8" in leaf:
        out = _imatmul("fulltk_matmul", _W_Q8, _X_ROWS, a, None, b, a.shape[1] // tk,
                       leaf["q8"], leaf["s"], tile_units, tile_units)
    else:
        out = _imatmul("fulltk_matmul", _W_Q4, _X_HALVES, a, b, None, 0, leaf["q4"],
                       leaf["s"], tile_units, tile_units)
    fulltk_matmul.launches += 1
    return out


fulltk_matmul.launches = 0


def bitcast_i4_matmul(x: torch.Tensor, leaf: dict, bf16: bool = False) -> torch.Tensor:
    """L9: the Q4_0 bytes read as two's-complement nibbles (byte r -> rows
    2r, 2r+1: a fixed permutation of Q4_0's order, and nib - 16 for nib >
    7), times s[row // 32]; f32 dot, or with `bf16` bf16 weights and x."""
    if x.device.type == "cpu":
        return i4_matmul_plain(x, leaf["q4"], leaf["s"], bf16)
    out = _fmatmul("bitcast_i4_matmul", _F_I4_BF16 if bf16 else _F_I4, x, None, leaf["q4"],
                   torch.uint8, 1, leaf["s"])
    bitcast_i4_matmul.launches += 1
    return out


bitcast_i4_matmul.launches = 0


def bitcast_i4_i8dot(xs: tuple, leaf: dict, tk: int, g128: bool = False) -> torch.Tensor:
    """L10: L9's integers dotted with xq int8 [tm, K]; xs = (xq, sx) of
    `hoist_a8full` (scales per k-tile) or with `g128` of `hoist_a8g128`
    (per 128-group g of tile ki, scale row ki * tk/32 + g)."""
    xq, sx = xs
    if xq.device.type == "cpu":
        return bitcast_i4_i8dot_plain(xq, sx, leaf, tk, g128)
    tile_units = tk // QK
    sg_units = G128 // QK if g128 else tile_units
    out = _imatmul("bitcast_i4_i8dot", _W_I4, _X_ROWS, xq, None, sx,
                   xq.shape[1] // (sg_units * QK), leaf["q4"], leaf["s"], sg_units,
                   tile_units)
    bitcast_i4_i8dot.launches += 1
    return out


bitcast_i4_i8dot.launches = 0


def probe(kind: str, x: torch.Tensor, leaf: dict, tk: int) -> torch.Tensor:
    """L11: the probe `kind` (one of `PROBES`) of a Q4_0 leaf -> f32 [tm, N],
    every row the same. x gives the row count and the device only (the TPU
    kernels add 0 * sum(x))."""
    if kind not in PROBES:
        raise ValueError(f"probe: unknown kind {kind!r}")
    tm, k = x.shape
    if x.device.type == "cpu":
        return probe_plain(kind, leaf, tm, tk)
    _cuda_or_raise(x, "probe")
    q4, s = leaf["q4"], leaf["s"]
    n = q4.shape[1] if q4.dim() == 2 else 0
    _check("probe", x.device, {"q4": (q4, torch.uint8, (k // 2, n)),
                               "s": (s, torch.bfloat16, (k // QK, n))}, k, n)
    if k % tk or tk % QK or tk < QK:
        raise ValueError(f"probe: K={k} does not divide into k-tiles of {tk}")
    # dma_pure: one block per span; the others: the decode form's split
    rows = tk if kind == "dma_pure" else QK * probe_plan(k, n)[1]
    ksplit = ksplit_for(k, rows)
    out = torch.empty((tm, n), dtype=torch.float32, device=x.device)
    ws = torch.empty((ksplit, n), dtype=torch.float32, device=x.device)
    err = _lib().llamago_lab_probe(q4.data_ptr(), s.data_ptr(), out.data_ptr(),
                                   ws.data_ptr(), tm, k, n, _PROBE_MODE[kind], rows, ksplit,
                                   _stream(x))
    _build.check(err, f"probe {kind}")
    probe.launches += 1
    return out


probe.launches = 0


def w16_matmul(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """L12: x bf16 [tm, K] @ raw bf16 weights leaf["w16"] [K, N], f32 sums.
    The leaf's scales (all ones in the lab) are not read."""
    if x.device.type == "cpu":
        return w16_matmul_plain(x, leaf["w16"])
    out = _fmatmul("w16_matmul", _F_W16, x, None, leaf["w16"], torch.bfloat16, 2, leaf["s"])
    w16_matmul.launches += 1
    return out


w16_matmul.launches = 0
