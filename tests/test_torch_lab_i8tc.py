"""The kernel lab's integer rows (L6, L7, L8, L10) on the int8 tensor-core
decode form: its route, its split of K, the C entry point and codes it is
handed, its shared memory, and a numpy emulation of its lanes, against the
plain versions and the JAX lab's kernels in interpret mode. The emulation
(`emulate_i8tc`) is K5's too (tests/test_torch_k5_decode_tc.py).

On the card the integer rows take `lab_decode_i8tc` (`ops/lab_kernels.py:
lab_i8_plan`, `csrc/lab_matmul.cu`) on the form of `csrc/decode_i8_tc.cuh`:
the weights are the A operand of int8 mma.sync.m16n8k32 (exact int32 sums)
and the 8 rows of xq a group are B; 32 rows of K a ring stage arrive by TMA
bulk copies (with the scale row and sx where a scale group ends); an A
register holds four k of one column, made from Q8_0 rows by a 4x4 byte
transpose, from Q4_0 bytes as raw nibbles (8 * sum(xq) comes off the group's
sum), or from int4 pairs as 16 times the nibble's value (the sum is shifted
back); Q8_0 and Q4_0 take their k in a permuted order that B takes too. Each
group's int32 sum is folded with sx * s into the f32 output; K is split into
one wave of blocks whose partials `lab_reduce` adds in order. Here, without
a card, the wrappers take the plain versions; the tests pin the route and
the plan, the codes and the C signature, the shared memory, the launcher on
meta tensors, what each lane's A and B registers hold in every format (bit
for bit the plain version's integers, in the permuted order), and the
emulated output against the plain versions and the JAX lab in interpret
mode.
"""

import ctypes
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import quant as jquant
from llamago_tpu_torch import kernel_lab as lab
from llamago_tpu_torch.ops import _build, kernels, quant
from llamago_tpu_torch.ops import lab_kernels as lk

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "llamago_tpu_torch" / "csrc"
# of max|ref|, as tests/test_torch_lab.py holds these rows and chip_smoke's
# LAB_TOL on the card: the same exact integer dots, f32 products and sums in
# another order
F32_TOL = 1e-5
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for its blocks
SMEM_RESERVED = 1024  # bytes the card reserves for each resident block
Q8, Q4RAW, I4 = 0, 1, 2  # csrc/decode_i8_tc.cuh kItQ8, kItQ4Raw, kItI4
X_ROWS, X_BLOCKS, X_HALVES = 0, 1, 2
# the variants of the four rows: (weight format, xq layout)
VARIANTS = {"w4a8": (Q4RAW, X_ROWS), "w4a8_raw": (Q4RAW, X_ROWS), "w4a8_h": (Q4RAW, X_BLOCKS),
            "w8a8": (Q8, X_ROWS), "w8a8_h": (Q8, X_BLOCKS), "w8a8_fulltk": (Q8, X_ROWS),
            "w4a8_split_fulltk": (Q4RAW, X_HALVES), "bitcast_i4_i8dot": (I4, X_ROWS),
            "bitcast_i4_i4dot": (I4, X_ROWS), "bitcast_i4_i8dot_g128": (I4, X_ROWS),
            "bitcast_i4_i8dot_g128_lazy": (I4, X_ROWS)}


def _src(name="lab_matmul.cu") -> str:
    return (CSRC / name).read_text()


# ------------------------------------------------------------------ routing

def test_every_integer_variant_of_the_lab_is_covered():
    assert sorted(VARIANTS) == sorted(n for n, v in lab.VARIANTS.items()
                                      if v.row in ("L6", "L7", "L8", "L10"))


def test_lab_igemv_is_gone_and_the_entry_launches_the_form():
    """`lab_igemv` is deleted; the integer entry point launches the int8
    tensor-core decode form, one instance per weight format."""
    src = _src()
    assert "lab_igemv" not in src and "__dp4a" not in src
    entry = src.split('extern "C" int llamago_lab_imatmul(')[1].split("\n}\n")[0]
    assert [f for f in ("kItQ8", "kItQ4Raw", "kItI4")
            if f"launch_decode_i8tc<{f}>(a, ksplit, st)" in entry] == ["kItQ8", "kItQ4Raw",
                                                                        "kItI4"]
    assert "decode_i8tc_body<FMT, 1>(a)" in src


def test_codes_match_the_c_side():
    hdr = _src("decode_i8_tc.cuh")
    assert "constexpr int kItQ8 = 0, kItQ4Raw = 1, kItI4 = 2;" in hdr
    assert "constexpr int kItXRows = 0, kItXBlocks = 1, kItXHalves = 2;" in hdr
    assert (lk._W_Q8, lk._W_Q4, lk._W_I4) == (Q8, Q4RAW, I4)
    assert (lk._X_ROWS, lk._X_BLOCKS, lk._X_HALVES) == (X_ROWS, X_BLOCKS, X_HALVES)
    entry = _src().split('extern "C" int llamago_lab_imatmul(')[1]
    # the plan's split is checked: it covers K and no split is empty
    assert "(long long)ksplit * per < nb" in entry
    assert "(long long)(ksplit - 1) * per >= nb" in entry
    assert "(ksplit > 1 && ws == nullptr)" in entry


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}


def test_entry_point_arguments_match_the_argtypes(monkeypatch):
    sig = re.search(r'extern "C" int llamago_lab_imatmul\(([^)]*)\)', _src())
    params = [p.split() for p in sig.group(1).split(",")]
    assert [p[-1] for p in params] == ["xq", "xq_hi", "sx", "q", "s", "out", "ws", "tm", "K",
                                       "N", "wfmt", "xlayout", "sg_units", "tile_units",
                                       "ksplit", "per", "stream"]

    class Lib:
        pass

    for name in ("llamago_lab_fmatmul", "llamago_lab_imatmul", "llamago_lab_quantize_x",
                 "llamago_lab_probe"):
        setattr(Lib, name, type("Fn", (), {})())
    monkeypatch.setattr(_build, "library", lambda name: Lib)
    fn = lk._lib.__wrapped__().llamago_lab_imatmul
    assert fn.argtypes == [_C_TYPES[" ".join(p[:-1])] for p in params]
    assert fn.restype is ctypes.c_int


def test_the_form_comes_from_one_header():
    """lab_matmul.cu and w4x8_matmul.cu both instantiate decode_i8_tc.cuh's
    body, which no source defines again, and rebuild when it changes."""
    assert "decode_i8_tc.cuh" in _build.source_files("lab_matmul")
    assert "decode_i8_tc.cuh" in _build.source_files("w4x8_matmul")
    body = re.compile(r"void decode_i8tc_body\(")
    assert body.search(_src("decode_i8_tc.cuh"))
    assert not any(body.search(p.read_text()) for p in CSRC.glob("*.cu"))
    for use in ("mma_s8(dot[4 * I + J][j], a,", "bulk_copy(", "mbar_wait(", "l2_evict_first()",
                "transpose4x4(r, c)", "i4_cols(word_of<I>("):
        assert use in _src("decode_i8_tc.cuh"), use


# ------------------------------------------------------------------ the plan

PLAN_CASES = [(tm, k, n, sg)
              for tm, k, n in ((8, 8192, 7168), (16, 8192, 7168), (8, 512, 512), (8, 4096, 4096),
                               (24, 1024, 16), (8, 1024, 16), (8, 11008, 4096))
              for sg in (1, 4, 8, 32) if (k // 32) % sg == 0]


@pytest.mark.parametrize("tm,k,n,sg", PLAN_CASES)
def test_plan_splits_k_into_one_wave(tm, k, n, sg):
    """As many parts of K as one wave of blocks holds (512 columns by 8
    rows, three an SM), each of at least 4 quant blocks where K allows,
    none empty; a part of at least a scale group holds whole groups; a
    workspace only when K is split."""
    steps = k // 32
    ksplit, per, ws = lk.lab_i8_plan(tm, k, n, sg)
    assert ksplit * per >= steps > (ksplit - 1) * per  # covers K, no part empty
    blocks = -(-n // 512) * (tm // 8)
    assert blocks * ksplit <= max(3 * 132, blocks)
    assert per >= min(4, steps) or ksplit == 1
    assert per < sg or per % sg == 0
    assert ws == (ksplit * tm * n if ksplit > 1 else 0)


def test_plan_at_the_labs_shape():
    """K = 8192, N = 7168, m = 8: 14 strips; 26 parts of 10 quant blocks for
    32-row groups and the 1024-row k-tiles (whose groups the parts cut), 22
    of 12 for the 128-row groups (whole groups)."""
    assert lk.lab_i8_plan(8, 8192, 7168, 1) == (26, 10, 26 * 8 * 7168)
    assert lk.lab_i8_plan(8, 8192, 7168, 32) == (26, 10, 26 * 8 * 7168)
    assert lk.lab_i8_plan(8, 8192, 7168, 4) == (22, 12, 22 * 8 * 7168)
    with pytest.raises(ValueError, match="multiple of 8"):
        lk.lab_i8_plan(12, 8192, 7168, 1)


# ------------------------------------------------------------ shared memory

def _it_layout(fmt: int) -> dict:
    """The form's stage as decode_i8_tc.cuh lays it out."""
    rows = 32 if fmt == Q8 else 16
    x_off = rows * 528
    sx_off = x_off + 16 * 48
    s_off = sx_off + 16 * 4
    stage = s_off + 512 * 2
    stages = 4 if fmt == Q8 else 6
    return dict(rows=rows, x_off=x_off, sx_off=sx_off, s_off=s_off, stage=stage,
                stages=stages, smem=stages * (stage + 8))


def test_the_layout_is_the_headers():
    hdr = _src("decode_i8_tc.cuh")
    for text in ("constexpr int kItRowLd = kItBlockCols + 16, kItXLd = 48;",
                 "constexpr int kItSlots = 16;", "constexpr int kItBlockCols = kItWarps * kItCols;",
                 "return FMT == kItQ8 ? 32 : 16; }", "return FMT == kItQ8 ? 4 : 6; }",
                 "return NT == 1 ? 3 : 2; }",
                 "return it_rows<FMT>() * kItRowLd + kItSlots * kItXLd + kItSlots * 4 + "
                 "kItBlockCols * 2;",
                 "return it_stages<FMT>() * (it_stage_bytes<FMT>() + 8);",
                 "constexpr int X_OFF = ROWS * kItRowLd, SX_OFF = X_OFF + kItSlots * kItXLd;",
                 "constexpr int S_OFF = SX_OFF + kItSlots * 4;"):
        assert text in hdr, text
    assert "__launch_bounds__(kItThreads, it_blocks_per_sm<1>())\n    lab_decode_i8tc(" in _src()


@pytest.mark.parametrize("fmt", [Q8, Q4RAW, I4])
def test_three_blocks_an_sm_fit(fmt):
    """Three blocks an SM (the launch bounds' count at one n8 tile): their
    rings fit its shared memory, each ring holds the warps' sums (4 warps x
    16 slots x 128 f32), stages and barriers stay 16-byte aligned, and
    every copy's destination is 16-byte aligned."""
    lay = _it_layout(fmt)
    assert 3 * (lay["smem"] + SMEM_RESERVED) <= SMEM_PER_SM
    assert lay["smem"] >= 4 * 16 * 128 * 4
    for key in ("stage", "x_off", "sx_off", "s_off"):
        assert lay[key] % 16 == 0, key
    assert 48 % 16 == 0 and 528 % 16 == 0


# ------------------------------------------- what the launcher hands the C side

def c_args(name: str, tk: int) -> dict:
    """The format, layout and scale grouping the wrapper of `name` hands the
    C side (ops/lab_kernels.py `_imatmul` by way of each wrapper)."""
    wfmt, xlayout = VARIANTS[name]
    tile = tk // 32
    if name.startswith("w4a8_split") or name == "w8a8_fulltk" or \
            (name.startswith("bitcast") and "g128" not in name):
        sg = tile
    elif "g128" in name:
        sg = 4
    else:
        sg, tile = 1, 1
    return dict(wfmt=wfmt, xlayout=xlayout, sg_units=sg, tile_units=tile)


class _FakeLib:
    def __init__(self):
        self.calls = []

    def llamago_lab_imatmul(self, xq, xq_hi, sx, q, s, out, ws, tm, k, n, wfmt, xlayout,
                            sg_units, tile_units, ksplit, per, stream):
        self.calls.append(dict(tm=tm, k=k, n=n, wfmt=wfmt, xlayout=xlayout, sg_units=sg_units,
                               tile_units=tile_units, ksplit=ksplit, per=per))
        return 0

    def llamago_lab_quantize_x(self, x, xq, sx, tm, k, stream):
        return 0


@pytest.mark.parametrize("tk", [1024, 512])
@pytest.mark.parametrize("tm", [8, 16])
def test_launcher_counts_and_hands_the_plan(monkeypatch, tm, tk):
    """Every integer variant on meta tensors (data pointers 0, never read):
    the codes, the scale grouping and the plan handed to the entry point,
    the f32 workspace allocated when K is split, and the count raised once
    a launch."""
    fake = _FakeLib()
    monkeypatch.setattr(lk, "_lib", lambda: fake)
    monkeypatch.setattr(lk, "_cuda_or_raise", lambda x, what: None)
    monkeypatch.setattr(lk, "_stream", lambda x: 0)
    wrappers = {lk.w4a8_matmul, lk.w8a8_matmul, lk.fulltk_matmul, lk.bitcast_i4_i8dot}
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    meta = torch.device("meta")
    k, n = 8192, 7168
    x = torch.empty((tm, k), dtype=torch.bfloat16, device=meta)
    leaves = {"q4": {"q4": torch.empty((k // 2, n), dtype=torch.uint8, device=meta)},
              "q8": {"q8": torch.empty((k, n), dtype=torch.int8, device=meta)}}
    for leaf in leaves.values():
        leaf["s"] = torch.empty((k // 32, n), dtype=torch.bfloat16, device=meta)
    want, workspaces = [], []
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        if t.dtype == torch.float32 and t.dim() == 1:
            workspaces.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", spy)
    for name in VARIANTS:
        v = lab.VARIANTS[name]
        v.fn(lab.HOISTS[v.hoist](x, tk), leaves[v.fmt], tk)
        a = c_args(name, tk)
        ksplit, per, ws = lk.lab_i8_plan(tm, k, n, a["sg_units"])
        assert ksplit > 1 and ws == ksplit * tm * n
        want.append(dict(tm=tm, k=k, n=n, **a, ksplit=ksplit, per=per))
    assert fake.calls == want
    assert workspaces == [lk.lab_i8_plan(tm, k, n, c["sg_units"])[2] for c in want]
    for fn in wrappers:
        assert fn.launches == sum(lab.VARIANTS[nm].counter[0] is fn for nm in VARIANTS)


# --------------------------------------------------------- the lanes, emulated

LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3
ROW_LD, X_LD = 528, 48


def _byte_perm(a, b, sel):
    src = [(a >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [(b >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(a)
    for j in range(4):
        out |= src[(sel >> (4 * j)) & 7] << np.uint32(8 * j)
    return out


def transpose4x4(w):
    t0, t1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[2], w[3], 0x5140)
    t2, t3 = _byte_perm(w[0], w[1], 0x7362), _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def i4_cols(a, b):
    f0, f = np.uint32(0xF0F0F0F0), np.uint32(4)
    alo, ahi, blo, bhi = (a << f) & f0, a & f0, (b << f) & f0, b & f0
    ta, tb = _byte_perm(alo, ahi, 0x5140), _byte_perm(alo, ahi, 0x7362)
    ua, ub = _byte_perm(blo, bhi, 0x5140), _byte_perm(blo, bhi, 0x7362)
    return [_byte_perm(ta, ua, 0x5410), _byte_perm(ta, ua, 0x7632),
            _byte_perm(tb, ub, 0x5410), _byte_perm(tb, ub, 0x7632)]


def _bytes_at(st, addr, nbytes):
    """[32, nbytes] uint8: each lane's bytes at its address."""
    return st[np.asarray(addr)[:, None] + np.arange(nbytes)[None, :]]


def _u32(v):
    return np.ascontiguousarray(v).view(np.uint32)[:, 0]


def _word(v, i):
    return _u32(v[:, 4 * i:4 * i + 4])


def _s8(reg, i):
    return ((reg >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(np.uint8).view(np.int8).astype(
        np.int64)


def lane_w(fmt, st, cw):
    """The lane's 16-byte reads of the step's weight rows."""
    if fmt == Q8:
        rows = [16 * (r >> 2) + 8 * ((r >> 1) & 1) + 2 * TIG + (r & 1) for r in range(8)]
    else:
        rows = [8 * (r >> 1) + 2 * TIG + (r & 1) for r in range(4)]
    return [_bytes_at(st, row * ROW_LD + cw, 16) for row in rows]


def it_cols(fmt, w, i, h):
    if fmt == Q8:
        return transpose4x4([_word(w[4 * h + e], i) for e in range(4)])
    if fmt == Q4RAW:
        c = transpose4x4([_word(w[e], i) for e in range(4)])
        return [(x if h == 0 else x >> np.uint32(4)) & np.uint32(0x0F0F0F0F) for x in c]
    return i4_cols(_word(w[2 * h], i), _word(w[2 * h + 1], i))


def lane_a(fmt, w):
    """A registers of tiles 0..7: [8][4] of [32] uint32."""
    tiles = [None] * 8
    for i in range(2):
        c00, c01 = it_cols(fmt, w, i, 0), it_cols(fmt, w, i + 2, 0)
        c10, c11 = it_cols(fmt, w, i, 1), it_cols(fmt, w, i + 2, 1)
        for j in range(4):
            tiles[4 * i + j] = [c00[j], c01[j], c10[j], c11[j]]
    return tiles


def lane_b(fmt, st, x_off, j, m_valid):
    """B registers of n8 tile j: slot 8j + gid, zero past the block's slots."""
    xr = x_off + (8 * j + GID) * X_LD
    if fmt == I4:
        b0, b1 = _u32(_bytes_at(st, xr + 4 * TIG, 4)), _u32(_bytes_at(st, xr + 16 + 4 * TIG, 4))
    else:
        def h(i):
            return _u32(np.concatenate([_bytes_at(st, xr + 2 * i, 2),
                                        np.zeros((32, 2), np.uint8)], 1))
        b0 = h(TIG) | (h(TIG + 4) << np.uint32(16))
        b1 = h(TIG + 8) | (h(TIG + 12) << np.uint32(16))
    ok = (8 * j + GID) < m_valid
    return np.where(ok, b0, 0).astype(np.uint32), np.where(ok, b1, 0).astype(np.uint32)


def mma_s8(dot, a, b0, b1):
    """mma.m16n8k32 s8 by the PTX fragment layout: dot [32, 4] += C."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for reg, (row, k0) in enumerate(((GID, 0), (GID + 8, 0), (GID, 16), (GID + 8, 16))):
        for i in range(4):
            A[row, k0 + 4 * TIG + i] = _s8(a[reg], i)
    for reg, k0 in ((b0, 0), (b1, 16)):
        for i in range(4):
            B[k0 + 4 * TIG + i, GID] = _s8(reg, i)
    C = A @ B
    dot += np.stack([C[GID, 2 * TIG], C[GID, 2 * TIG + 1], C[GID + 8, 2 * TIG],
                     C[GID + 8, 2 * TIG + 1]], axis=1)


def physical_row(fmt, k):
    """The step's row of K that logical k (0..31) of the A and B registers
    is: Q8_0 and Q4_0 permute within each half, int4 pairs keep the order."""
    if fmt == I4:
        return k
    h, tig, e = k // 16, (k % 16) // 4, k % 4
    return 16 * h + 8 * (e >> 1) + 2 * tig + (e & 1)


def build_stage(fmt, rng, *, q, s16, xq, xq_hi, xlayout, tm, sx, sx_ld, k, n, u, nb0, row0,
                slots, nt, fold, sg, tile, tile_rows):
    """One ring stage as the block's bulk copies fill it; what no copy
    writes holds garbage, as stale shared memory does."""
    lay = _it_layout(fmt)
    st = rng.integers(0, 256, lay["stage"], dtype=np.uint8)
    width = min(512, n - nb0)
    for r in range(lay["rows"]):
        st[r * ROW_LD:r * ROW_LD + width] = q[u * lay["rows"] + r, nb0:nb0 + width]
    for mm in range(slots):
        m = row0 + mm
        d = lay["x_off"] + mm * X_LD
        if xlayout == X_HALVES:
            off = m * (k // 2) + u * 16
            st[d:d + 16], st[d + 16:d + 32] = xq[off:off + 16], xq_hi[off:off + 16]
        else:
            off = m * k + u * 32 if xlayout == X_ROWS else (u * tm + m) * 32
            st[d:d + 32] = xq[off:off + 32]
    if fold:
        srow = (u // tile) * tile_rows + (u % tile) // sg
        st[lay["s_off"]:lay["s_off"] + 2 * width] = s16[srow, nb0:nb0 + width].view(np.uint8)
        if sx is not None:
            g = u // sg
            st[lay["sx_off"]:lay["sx_off"] + 32 * nt] = \
                sx[g * sx_ld + row0:g * sx_ld + row0 + 8 * nt].view(np.uint8)
    return st


def fold_into(acc, dot, xs, sxv, sc, fmt, nt):
    """A warp's fold at a group's or split's end: per lane f32(d), the
    product with sx rounded, the fused multiply-add with the column's
    scale."""
    for t in range(8):
        for j in range(nt):
            for e in range(4):
                d = dot[t, j, :, e].copy()
                if fmt == Q4RAW:
                    d -= 8 * xs[j, :, e & 1]
                if fmt == I4:
                    assert (d % 16 == 0).all()
                    d >>= 4
                p = (d.astype(np.float32) * sxv[j, :, e & 1]).astype(np.float32)
                acc[t, j, :, e] = (p.astype(np.float64) * sc[:, 8 * (e >> 1) + t]
                                   + acc[t, j, :, e]).astype(np.float32)


def emulate_i8tc(fmt, nt, *, q, s16, xq, xq_hi=None, xlayout, tm, sx, sx_ld, k, n, ksplit,
                 per, sg, tile, tile_rows, seed=0):
    """decode_i8tc_body lane by lane: every block (512 columns, a split of
    `per` steps, 8 nt slots) over ring stages that its copies fill (the
    weights q uint8 [rows of K, N], the scales s16 bf16 bits [*, N], xq and
    sx as flat memory in their layouts, garbage where no copy writes), the
    lanes' A and B registers, mma.m16n8k32 by the PTX layout, Q4_0's sum of
    xq by the lanes' dp4a and shuffles, the fold at each group's or split's
    end (one f32 conversion, the product with sx rounded, then the fused
    multiply-add with the scale), and the output placement. Returns the f32
    partials [ksplit, tm, N] the blocks write."""
    rng = np.random.default_rng(seed)
    steps = k // 32
    lay = _it_layout(fmt)
    ncols = -(-n // 512) * 512
    qpad = np.concatenate([q, rng.integers(0, 256, (q.shape[0], ncols - n), np.uint8)], 1)
    spad = np.concatenate([s16, rng.integers(0, 1 << 16, (s16.shape[0], ncols - n))
                           .astype(np.uint16)], 1)
    dst = np.full((ksplit, tm, n), np.nan, np.float32)
    for nb0 in range(0, n, 512):
        width = min(512, n - nb0)
        for y in range(ksplit):
            u0 = y * per
            n_it = min(per, steps - u0)
            for row0 in range(0, tm, 8 * nt):
                slots = min(8 * nt, tm - row0)
                acc = np.zeros((4, 8, nt, 32, 4), np.float32)
                dot = np.zeros((4, 8, nt, 32, 4), np.int64)
                xs = np.zeros((nt, 32, 2), np.int64)
                for it in range(n_it):
                    u = u0 + it
                    fold = (u + 1) % sg == 0 or it + 1 == n_it
                    st = build_stage(fmt, rng, q=qpad, s16=spad, xq=xq, xq_hi=xq_hi,
                                     xlayout=xlayout, tm=tm, sx=sx, sx_ld=sx_ld, k=k, n=n, u=u,
                                     nb0=nb0, row0=row0, slots=slots, nt=nt, fold=fold, sg=sg,
                                     tile=tile, tile_rows=tile_rows)
                    bs = [lane_b(fmt, st, lay["x_off"], j, slots) for j in range(nt)]
                    if fmt == Q4RAW:
                        for j, (b0, b1) in enumerate(bs):
                            v = sum(_s8(b0, i) + _s8(b1, i) for i in range(4))
                            per_slot = v.reshape(8, 4).sum(1)  # the xor shuffles
                            xs[j, :, 0] += per_slot[2 * TIG]
                            xs[j, :, 1] += per_slot[2 * TIG + 1]
                    for warp in range(4):
                        cw = warp * 128 + 16 * GID
                        a = lane_a(fmt, lane_w(fmt, st, cw))
                        for t in range(8):
                            for j in range(nt):
                                mma_s8(dot[warp, t, j], a[t], *bs[j])
                        assert np.abs(dot).max() < 2 ** 31
                        if not fold:
                            continue
                        sxv = np.ones((nt, 32, 2), np.float32)
                        if sx is not None:
                            for j in range(nt):
                                sxv[j] = _bytes_at(st, lay["sx_off"] + 4 * (8 * j + 2 * TIG),
                                                   8).view(np.float32)
                        sc = (_bytes_at(st, lay["s_off"] + 2 * cw, 32).view(np.uint16)
                              .astype(np.uint32) << np.uint32(16)).view(np.float32)
                        # garbage scales past N and sx past the slots may overflow
                        with np.errstate(over="ignore", invalid="ignore"):
                            fold_into(acc[warp], dot[warp], xs, sxv, sc, fmt, nt)
                        dot[warp] = 0
                    if fold:
                        xs[:] = 0
                red = np.full((8 * nt, 512), np.nan, np.float32)
                for warp in range(4):
                    cw = warp * 128 + 16 * GID
                    for t in range(8):
                        for j in range(nt):
                            for hh in range(2):
                                red[8 * j + 2 * TIG + hh, cw + t] = acc[warp, t, j, :, hh]
                                red[8 * j + 2 * TIG + hh, cw + 8 + t] = acc[warp, t, j, :, 2 + hh]
                dst[y, row0:row0 + slots, nb0:nb0 + width] = red[:slots, :width]
    return dst


def reduce_in_order(dst: np.ndarray) -> np.ndarray:
    """lab_reduce / w4x8_reduce: the splits' partials added in order."""
    out = np.zeros(dst.shape[1:], np.float32)
    for part in dst:
        out = (out + part).astype(np.float32)
    return out


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.bfloat16).contiguous().view(torch.int16).numpy().view(np.uint16)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy().reshape(-1) if t.dtype != torch.uint8 \
        else t.contiguous().numpy().reshape(-1)


def lab_operands(name, x, leaf, tk):
    """What the C side of `name` receives: (format, nt, keyword arguments of
    emulate_i8tc) as the wrapper lays the operands out on the card (the
    variants that quantize x themselves take the quantization kernel's
    xq [tm, K] and sx [K/32, tm], which are hoist_a8's values)."""
    v = lab.VARIANTS[name]
    ops = lab.HOISTS[v.hoist](x, tk)
    a = c_args(name, tk)
    tm, k = x.shape
    xq_hi = None
    if v.hoist is None:  # the quantization kernel's layout: rows
        xq, sx = lk.hoist_a8(x)
        xq = xq.transpose(0, 1).reshape(tm, k)
    elif a["xlayout"] == X_HALVES:  # the int8 halves, no activation scale
        (xq, xq_hi), sx = ops, None
    else:
        xq, sx = ops
    q = leaf["q8"].view(torch.uint8).numpy() if "q8" in leaf else leaf["q4"].numpy()
    n = q.shape[1]
    ksplit, per, _ = lk.lab_i8_plan(tm, k, n, a["sg_units"])
    return a["wfmt"], dict(
        q=q, s16=_bf16_bits(leaf["s"]), xq=_bytes(xq),
        xq_hi=None if xq_hi is None else _bytes(xq_hi), xlayout=a["xlayout"], tm=tm,
        sx=None if sx is None else sx.contiguous().numpy().reshape(-1), sx_ld=tm, k=k, n=n,
        ksplit=ksplit, per=per, sg=a["sg_units"], tile=a["tile_units"],
        tile_rows=a["tile_units"])


def xq_matrix(kw) -> np.ndarray:
    """xq [tm, K] int8 in natural order from the memory handed to the C
    side in its layout."""
    tm, k = kw["tm"], kw["k"]
    xq = kw["xq"].view(np.int8)
    if kw["xlayout"] == X_ROWS:
        return xq.reshape(tm, k)
    if kw["xlayout"] == X_BLOCKS:
        return xq.reshape(k // 32, tm, 32).transpose(1, 0, 2).reshape(tm, k)
    lo, hi = xq.reshape(tm, k // 32, 16), kw["xq_hi"].view(np.int8).reshape(tm, k // 32, 16)
    return np.concatenate([lo, hi], 2).reshape(tm, k)


K = N = 512


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((8, K)).astype(np.float32)).to(torch.bfloat16)
    x[1, 32:64] = 0  # a zero block: sx = 1
    return x, rng.standard_normal((K, N)).astype(np.float32)


def _plain_integers(fmt, leaf) -> np.ndarray:
    """[K, N] int64: the integers the A registers hold for each row of K,
    in natural order: Q8_0's, Q4_0's raw nibbles, 16 times an int4 pair's."""
    if fmt == Q8:
        return leaf["q8"].numpy().astype(np.int64)
    if fmt == Q4RAW:
        return quant.unpack_q4(leaf["q4"]).numpy().astype(np.int64) + 8
    return 16 * quant.unpack_w4x8(leaf["q4"]).numpy().astype(np.int64)


@pytest.mark.parametrize("name", ["w8a8", "w8a8_h", "w4a8", "w4a8_h", "w4a8_split_fulltk",
                                  "bitcast_i4_i8dot"])
def test_each_lane_holds_the_plain_integers_in_the_permuted_order(name):
    """Every A register byte a lane builds, put back by the PTX layout, is
    bit for bit the plain version's integer of its column at the row of K
    `physical_row` names, and every B register byte the slot's xq at the
    same row: the order of k is one permutation in A and B, so each group's
    int32 dot is the plain version's."""
    x, w = _inputs()
    leaf = lab.make_leaf(torch.from_numpy(w), lab.VARIANTS[name].fmt)
    fmt, kw = lab_operands(name, x, leaf, 256)
    want = _plain_integers(fmt, leaf)
    xq_rows = xq_matrix(kw)
    rng = np.random.default_rng(1)
    for u in range(K // 32):
        st = build_stage(fmt, rng, **{key: kw[key] for key in kw if key not in ("ksplit", "per")},
                         u=u, nb0=0, row0=0, slots=8, nt=1, fold=True)
        seen = np.full((32, 512), -999, np.int64)
        seen_x = np.full((32, 8), -999, np.int64)
        b0, b1 = lane_b(fmt, st, _it_layout(fmt)["x_off"], 0, 8)
        for reg, k0 in ((b0, 0), (b1, 16)):
            for i in range(4):
                seen_x[k0 + 4 * TIG + i, GID] = _s8(reg, i)
        for warp in range(4):
            cw = warp * 128 + 16 * GID
            a = lane_a(fmt, lane_w(fmt, st, cw))
            for t in range(8):
                for reg, (col, k0) in enumerate(((cw + t, 0), (cw + 8 + t, 0), (cw + t, 16),
                                                 (cw + 8 + t, 16))):
                    for i in range(4):
                        vals = _s8(a[t][reg], i)
                        if fmt == Q4RAW:  # the raw nibbles are 0..15 as int8
                            assert (vals >= 0).all() and (vals < 16).all()
                        seen[k0 + 4 * TIG + i, col] = vals
        rows = np.array([physical_row(fmt, kk) for kk in range(32)])
        assert sorted(rows) == list(range(32))
        np.testing.assert_array_equal(seen, want[32 * u + rows])
        np.testing.assert_array_equal(seen_x, xq_rows[:, 32 * u + rows].T)


def test_nibbles_become_sixteen_times_their_value_exactly():
    """Every byte of an int4 pair: (b << 4) & 0xF0 and b & 0xF0 read as int8
    are 16 times the low and high nibble's two's-complement value; Q4_0's
    raw nibble less 8 is the centered value, so the raw dot less 8 * sum(xq)
    is the centered dot."""
    b = np.arange(256, dtype=np.uint32)
    cols = i4_cols(b, b)
    lo, hi = _s8(cols[0], 0), _s8(cols[0], 1)
    v_lo = ((b & 0xF) ^ 8).astype(np.int64) - 8
    v_hi = ((b >> 4) ^ 8).astype(np.int64) - 8
    np.testing.assert_array_equal(lo, 16 * v_lo)
    np.testing.assert_array_equal(hi, 16 * v_hi)
    rng = np.random.default_rng(0)
    nib = rng.integers(0, 16, 32)
    xq = rng.integers(-127, 128, 32)
    assert int((nib * xq).sum() - 8 * xq.sum()) == int(((nib - 8) * xq).sum())


def _load_jax_lab():
    spec = importlib.util.spec_from_file_location("jax_kernel_lab_i8tc",
                                                  ROOT / "scripts" / "kernel_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jlab():
    return _load_jax_lab()


def _jax_variant(jlab, name, x, w, tk):
    """The JAX lab's kernel `name` through its make_call, in interpret mode."""
    kern, opts = jlab.VARIANTS[name]
    fmt = opts.get("fmt", "q4")
    leaf = jquant.quantize(jnp.asarray(w), 8 if fmt == "q8" else 4)
    call, ops_of = jlab.make_call(kern, opts, K, N, 8, tk, 256, fmt)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ops = jax.jit(lambda a: ops_of(a, leaf, "q8" if fmt == "q8" else "q4"))(xj)
    return np.asarray(call(*ops))


CASES = [(name, 256) for name in VARIANTS] + [
    (name, 128) for name in ("w8a8_fulltk", "w4a8_split_fulltk", "bitcast_i4_i8dot",
                             "bitcast_i4_i8dot_g128")]


@pytest.mark.parametrize("name,tk", CASES, ids=[f"{n}-tk{t}" for n, t in CASES])
def test_emulated_form_matches_plain_and_the_jax_lab(jlab, name, tk):
    """The emulated form (the lanes' registers, the mma layout, each group's
    int32 sum folded in f32, a split that cuts a k-tile folding its part,
    the splits added in order) against the plain version and the JAX lab's
    kernel in interpret mode, K = N = 512, m = 8."""
    x, w = _inputs()
    v = lab.VARIANTS[name]
    leaf = lab.make_leaf(torch.from_numpy(w), v.fmt)
    fmt, kw = lab_operands(name, x, leaf, tk)
    if v.row in ("L8", "L10") and "g128" not in name:
        # the splits cut the 256-row k-tiles and hold whole 128-row ones
        assert (kw["per"] < kw["sg"]) == (tk == 256)
    got = reduce_in_order(emulate_i8tc(fmt, 1, **kw))
    assert np.isfinite(got).all()
    plain = v.plain(lab.HOISTS[v.hoist](x, tk), leaf, tk).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=F32_TOL * np.abs(plain).max())
    want = _jax_variant(jlab, name, x, w, tk)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


def test_lab_rows_are_held_to_the_int8_rate():
    """The four rows run int8 products on the int8 tensor cores: their bound
    is against the int8 rate, and the bytes bound them at the lab's shape."""
    for name in VARIANTS:
        v = lab.VARIANTS[name]
        assert v.rate == "int8", name
        assert lab.variant_bound(name, 8192, 7168, 8, 1024)[1] == "bytes"
    assert kernels.i8tc_blocks_per_sm(1) == 3 and kernels.i8tc_blocks_per_sm(2) == 2
