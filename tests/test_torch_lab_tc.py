"""The kernel lab's float rows (L2, L3, L9, L12) on their tensor-core decode
form: its route, its split of K, the C entry point and mode codes it is
handed, its shared memory, and a numpy emulation of its lanes, against the
plain versions and the JAX lab's kernels in interpret mode.

On the card the float rows take `lab_decode_tc` (`ops/lab_kernels.py:
lab_plan`, `csrc/lab_matmul.cu`): the layout of K1's decode form
(`csrc/decode_tc.cuh`) with the weights as the A operand of bf16
mma.sync.m16n8k16 and the 8 rows of x a group as B, the weight rows, x and
the scales of a 32-row quant block brought by TMA bulk copies into a ring,
each quant block summed in a zeroed accumulator and added to the output in
f32, K split into one wave of blocks whose partials `lab_reduce` adds in
order. Per mode the A pairs are exact bf16 integers (the int4 values of L2
and L9's f32 form, whose scale folds on the block sum), or bf16 products
made by __hmul2_rn (and __hadd2_rn for split_bf16_h's second rounding), or
L12's raw bf16 rows by ldmatrix.trans. Here, without a card, the wrappers
take the plain versions; the tests pin the route and the plan, the mode
codes and the C signature, the shared memory an SM's blocks need, the
launcher on meta tensors, what each lane builds in every mode (bit for bit
the plain version's decoded weights, and split_bf16_h's two roundings where
one fused rounding differs), and the emulated block sums against the plain
versions and the JAX lab in interpret mode.
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
from llamago_tpu_torch.ops import _build, quant
from llamago_tpu_torch.ops import lab_kernels as lk

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "llamago_tpu_torch" / "csrc"
# of max|ref|, as tests/test_torch_lab.py holds these rows (chip_smoke's
# LAB_TOL allows 1e-4 on the card): the same weights to the bit, f32 sums in
# another order
F32_TOL = 1e-5
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for its blocks
SMEM_RESERVED = 1024  # bytes the card reserves for each resident block
MODES = {"i4native": lk._F_I4, "bitcast_i4": lk._F_I4, "bitcast_i4_bf16": lk._F_I4_BF16,
         "bf16dot": lk._F_Q4_BF16, "split_bf16_h": lk._F_Q4_BF16_FMA, "w16dot": lk._F_W16}


def _src(name="lab_matmul.cu") -> str:
    return (CSRC / name).read_text()


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("mode", lk._F_MODES)
@pytest.mark.parametrize("tm", [8, 16, 24, 64])
def test_every_float_row_takes_the_decode_form(tm, mode):
    """At every row count the lab takes (a multiple of 8) and in every mode:
    a plan of the tensor-core decode form, 8 rows of x a grid z, which the
    entry point launches as its only product kernel; `lab_fgemv` is gone."""
    ksplit, _ = lk.lab_plan(tm, 8192, 7168, mode)
    assert ksplit >= 1
    entry = _src().split('extern "C" int llamago_lab_fmatmul(')[1].split("\n}\n")[0]
    assert entry.count("return launch_decode_tc<") == 5 and "lab_fgemv" not in _src()


def test_lab_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="unknown mode"):
        lk.lab_plan(8, 8192, 7168, 5)
    with pytest.raises(ValueError, match="multiple of 8"):
        lk.lab_plan(12, 8192, 7168, lk._F_I4)


@pytest.mark.parametrize("mode", lk._F_MODES)
@pytest.mark.parametrize("tm,k,n", [(8, 8192, 7168), (16, 8192, 7168), (8, 512, 512),
                                    (8, 4096, 4096), (24, 1024, 16), (8, 32, 16), (8, 11008, 4096)])
def test_plan_splits_k_into_one_wave(tm, k, n, mode):
    """As many parts of K as one wave of blocks holds (512 columns by 8 rows
    a block; two blocks an SM in L12, three in the nibble modes), each of
    at least 4 quant blocks where K allows, none empty; a workspace only
    when K is split."""
    ksplit, ws = lk.lab_plan(tm, k, n, mode)
    nb = k // 32
    per = -(-nb // ksplit)
    assert ksplit >= 1 and -(-nb // per) == ksplit  # no empty part
    blocks = -(-n // 512) * (tm // 8)
    wave = (2 if mode == lk._F_W16 else 3) * 132
    assert blocks * ksplit <= max(wave, blocks)
    assert per >= min(4, nb) or ksplit == 1
    assert ws == (ksplit * tm * n if ksplit > 1 else 0)


def test_plan_at_the_labs_shape():
    """K = 8192, N = 7168, m = 8: 14 strips of 512 columns; 26 parts of 10
    quant blocks in the nibble modes (364 blocks), 18 of 15 in L12 (252)."""
    assert {m: lk.lab_plan(8, 8192, 7168, m)[0] for m in lk._F_MODES} == {
        lk._F_I4: 26, lk._F_I4_BF16: 26, lk._F_Q4_BF16: 26, lk._F_Q4_BF16_FMA: 26, lk._F_W16: 18}


def test_mode_codes_match_the_c_side():
    codes = re.search(r"constexpr int kFI4 = (\d), kFI4Bf16 = (\d), kFQ4Bf16 = (\d), "
                      r"kFQ4Bf16Fma = (\d), kFW16 = (\d);", _src())
    assert codes is not None
    assert [int(c) for c in codes.groups()] == [lk._F_I4, lk._F_I4_BF16, lk._F_Q4_BF16,
                                                lk._F_Q4_BF16_FMA, lk._F_W16]
    # a workspace when K is split, the halves of x in split_bf16_h
    assert "(ksplit > 1 && ws == nullptr) ||\n      (mode == kFQ4Bf16Fma && x_hi == nullptr)" \
        in _src()


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}


def test_entry_point_arguments_match_the_argtypes(monkeypatch):
    sig = re.search(r'extern "C" int llamago_lab_fmatmul\(([^)]*)\)', _src())
    params = [p.split() for p in sig.group(1).split(",")]
    assert [p[-1] for p in params] == ["x", "x_hi", "q", "s", "out", "ws", "tm", "K", "N",
                                       "mode", "ksplit", "stream"]

    class Lib:
        pass

    for name in ("llamago_lab_fmatmul", "llamago_lab_imatmul", "llamago_lab_quantize_x",
                 "llamago_lab_probe"):
        setattr(Lib, name, type("Fn", (), {})())
    monkeypatch.setattr(_build, "library", lambda name: Lib)
    fn = lk._lib.__wrapped__().llamago_lab_fmatmul
    assert fn.argtypes == [_C_TYPES[" ".join(p[:-1])] for p in params]
    assert fn.restype is ctypes.c_int


def test_the_form_is_k1s_layout_from_one_header():
    """lab_matmul.cu takes decode_tc.cuh's layout (its constants),
    tc_common.cuh's wrappers (word_of, q4_pair, mma_bf16, ldmatrix_x4_trans,
    the TMA copies) and, for the integer rows, decode_i8_tc.cuh, and
    rebuilds when any of the headers changes."""
    assert _build.source_files("lab_matmul") == ["lab_matmul.cu", "decode_i8_tc.cuh",
                                                 "decode_tc.cuh", "tc_common.cuh"]
    for use in ("kDtBlockCols", "word_of<I>(", "q4_pair<J, 0>(", "mma_bf16(part, a,",
                "ldmatrix_x4_trans(a,", "bulk_copy(", "mbar_wait(", "__hmul2_rn(",
                "__hadd2_rn("):
        assert use in _src(), use


def _lt(mode: int) -> dict:
    """The form's shared-memory layout per mode, as lab_matmul.cu's lt_*
    functions give it."""
    w16, i4 = mode == lk._F_W16, mode in (lk._F_I4, lk._F_I4_BF16)
    rows, ld = (32, 1024 + 16) if w16 else (16, 512 + (32 if i4 else 16))
    stage = rows * ld + 8 * 80 + (0 if w16 else 1024)
    stages, per_sm = (3, 2) if w16 else (4, 3)
    return dict(rows=rows, ld=ld, stage=stage, smem=stages * (stage + 8), per_sm=per_sm)


@pytest.mark.parametrize("mode", lk._F_MODES)
def test_the_blocks_an_sm_is_to_hold_fit(mode):
    """The launch bounds ask for lt_blocks_per_sm blocks an SM: their rings
    fit its shared memory, each ring holds the warps' sums (4 x 8 x 128
    f32), and stages and barriers stay 16-byte aligned."""
    src = _src()
    assert "__launch_bounds__(kDtThreads, lt_blocks_per_sm<MODE>()) lab_decode_tc" in src
    assert "return MODE == kFW16 ? 3 : 4; }" in src and "return MODE == kFW16 ? 2 : 3;" in src
    lt = _lt(mode)
    assert lt["per_sm"] * (lt["smem"] + SMEM_RESERVED) <= SMEM_PER_SM
    assert lt["smem"] >= 4 * 8 * 128 * 4 and lt["stage"] % 16 == 0


class _FakeLib:
    def __init__(self):
        self.calls = []

    def llamago_lab_fmatmul(self, x, x_hi, q, s, out, ws, tm, k, n, mode, ksplit, stream):
        self.calls.append(dict(tm=tm, k=k, n=n, mode=mode, ksplit=ksplit))
        return 0


@pytest.mark.parametrize("tm", [8, 16])
def test_launcher_counts_and_hands_the_mode(monkeypatch, tm):
    """The four wrappers on meta tensors (data pointers 0, never read): the
    mode and split handed to the entry point, and the count (`launches`)
    raised once a launch."""
    fake = _FakeLib()
    monkeypatch.setattr(lk, "_lib", lambda: fake)
    monkeypatch.setattr(lk, "_cuda_or_raise", lambda x, what: None)
    monkeypatch.setattr(lk, "_stream", lambda x: 0)
    fns = (lk.i4_matmul, lk.bf16_dequant_matmul, lk.bitcast_i4_matmul, lk.w16_matmul)
    for fn in fns:
        monkeypatch.setattr(fn, "launches", 0)
    meta = torch.device("meta")
    k, n = 8192, 7168
    x = torch.empty((tm, k), dtype=torch.bfloat16, device=meta)
    halves = tuple(torch.empty((tm, k // 2), dtype=torch.bfloat16, device=meta) for _ in "ab")
    s = torch.empty((k // 32, n), dtype=torch.bfloat16, device=meta)
    packed = torch.empty((k // 2, n), dtype=torch.uint8, device=meta)
    w16 = torch.empty((k, n), dtype=torch.bfloat16, device=meta)
    lk.i4_matmul(x, {"i4": packed, "s": s})
    lk.bf16_dequant_matmul(x, {"q4": packed, "s": s})
    lk.bf16_dequant_matmul(halves, {"q4": packed, "s": s}, fma_in_bf16=True)
    lk.bitcast_i4_matmul(x, {"q4": packed, "s": s})
    lk.bitcast_i4_matmul(x, {"q4": packed, "s": s}, bf16=True)
    lk.w16_matmul(x, {"w16": w16, "s": s})
    modes = [lk._F_I4, lk._F_Q4_BF16, lk._F_Q4_BF16_FMA, lk._F_I4, lk._F_I4_BF16, lk._F_W16]
    assert fake.calls == [dict(tm=tm, k=k, n=n, mode=m, ksplit=lk.lab_plan(tm, k, n, m)[0])
                          for m in modes]
    assert [fn.launches for fn in fns] == [1, 2, 2, 1]


# --------------------------------------------------------- the lanes, emulated

LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3


def _u32(a):
    return np.asarray(a, np.uint32)


def _byte_perm(a, b, sel):
    src = [(a >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [(b >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(a)
    for j in range(4):
        out |= src[(sel >> (4 * j)) & 7] << np.uint32(8 * j)
    return out


def _val(h16):
    """bf16 bits (uint32 < 2^16) -> f32 values."""
    return (np.asarray(h16, np.uint32) << np.uint32(16)).view(np.float32)


def _bits(f):
    """f32 -> bf16 bits, round to nearest even."""
    u = np.asarray(f, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32) & np.uint32(0xFFFF)


def _halves(w):
    return w & np.uint32(0xFFFF), w >> np.uint32(16)


def _pair(lo, hi):
    return lo | (hi << np.uint32(16))


def _q4_pair(j, sh, raw, lo, hi):
    """tc_common.cuh q4_pair<J, SH, RAW>: bf16 0x43nn (128 + n) less 128
    (RAW) or 136, exactly."""
    t = _byte_perm(lo, hi, j | ((4 + j) << 8))
    v = ((t >> np.uint32(sh)) & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    c = np.float32(128 if raw else 136)
    a, b = _halves(v)
    return _pair(_bits(_val(a) - c), _bits(_val(b) - c))


def _hmul2(a, b):  # __hmul2_rn: the exact product (in f32) rounded once
    (a0, a1), (b0, b1) = _halves(a), _halves(b)
    return _pair(_bits(_val(a0) * _val(b0)), _bits(_val(a1) * _val(b1)))


def _hadd2(a, b):  # __hadd2_rn: the sum, exact in f32 for these operands, rounded once
    (a0, a1), (b0, b1) = _halves(a), _halves(b)
    out = []
    for x, y in ((a0, b0), (a1, b1)):
        exact = _val(x).astype(np.float64) + _val(y).astype(np.float64)
        assert np.array_equal(exact.astype(np.float32).astype(np.float64), exact)
        out.append(_bits(exact.astype(np.float32)))
    return _pair(*out)


def _mma(part, a, b0, b1):
    """mma.m16n8k16 by the PTX layout: part [32, 4] += A (regs a[0..3], bf16
    pairs) times B (b0, b1): every product exact, one f32 rounding."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for reg, (row, kk) in enumerate(((GID, 2 * TIG), (GID + 8, 2 * TIG),
                                     (GID, 2 * TIG + 8), (GID + 8, 2 * TIG + 8))):
        lo, hi = _halves(a[reg])
        A[row, kk], A[row, kk + 1] = _val(lo), _val(hi)
    for breg, kk in ((b0, 2 * TIG), (b1, 2 * TIG + 8)):
        lo, hi = _halves(breg)
        B[kk, GID], B[kk + 1, GID] = _val(lo), _val(hi)
    C = A @ B
    add = np.stack([C[GID, 2 * TIG], C[GID, 2 * TIG + 1], C[GID + 8, 2 * TIG],
                    C[GID + 8, 2 * TIG + 1]], axis=1)
    return (part.astype(np.float64) + add).astype(np.float32)


def _word(v: np.ndarray, i: int):
    """Word i of a lane's 16 bytes (v: [32, 16] uint8)."""
    return np.ascontiguousarray(v[:, 4 * i:4 * i + 4]).view(np.uint32)[:, 0]


def _stage(mode, q, s16, xs, kb, nb0, n):
    """One ring stage as the block's bulk copies fill it: weight rows ld
    bytes apart (bytes past the block's width hold garbage, as stale shared
    memory does), x's 8 rows of 32 bf16 80 bytes apart, then the 512 bf16
    scales. q: the packed or bf16 weight bytes [rows of K, N * col bytes]."""
    lt = _lt(mode)
    rng = np.random.default_rng(kb)
    st = rng.integers(0, 256, lt["stage"], dtype=np.uint8)
    cb = 2 if mode == lk._F_W16 else 1
    width = min(512, n - nb0)
    for r in range(lt["rows"]):
        st[r * lt["ld"]:r * lt["ld"] + width * cb] = q[kb * lt["rows"] + r,
                                                         nb0 * cb:(nb0 + width) * cb]
    x_off = lt["rows"] * lt["ld"]
    for m in range(8):
        row = st[x_off + 80 * m:x_off + 80 * m + 64]
        if mode == lk._F_Q4_BF16_FMA:  # two copies of 32 bytes, from the halves at kb * 16
            row[:32] = xs[0][m, kb * 16:kb * 16 + 16].view(np.uint8)
            row[32:] = xs[1][m, kb * 16:kb * 16 + 16].view(np.uint8)
        else:
            row[:] = xs[m, kb * 32:kb * 32 + 32].view(np.uint8)
    if mode != lk._F_W16:
        s_off = x_off + 640
        st[s_off:s_off + 2 * width] = s16[kb, nb0:nb0 + width].view(np.uint8)
    return st, x_off


def lane_fragments(mode, st, x_off, warp):
    """What each lane of `warp` builds from a stage: the A pairs of tile t at
    step `step` (after the scale's bf16 ops), [8][2][4] arrays of [32]
    uint32; the B pairs of x, [4] of [32]; and the f32 scales (L2 and L9's
    f32 form fold them on the block sum), [8][2] of [32]."""
    lt = _lt(mode)
    ld = lt["ld"]
    xw = np.ascontiguousarray(np.stack(
        [st[x_off + 80 * GID + 4 * TIG + 16 * j + np.arange(4)[:, None]].T
         for j in range(4)])).view(np.uint32)[..., 0]
    frags = [[None, None] for _ in range(8)]
    folds = [[None, None] for _ in range(8)]
    if mode == lk._F_W16:
        mat, mr = LANE >> 3, LANE & 7
        off = (8 * (mat >> 1) + mr) * ld + 2 * (warp * 128 + 8 * (mat & 1))
        for t in range(8):
            for step in range(2):
                addr = off + 16 * step * ld + 32 * t  # bytes: each lane one 16-byte row
                rows = st[addr[:, None] + np.arange(16)[None, :]].view(np.uint16)  # [32, 8]
                regs = []
                for i in range(4):  # .trans: lane l gets M_i[2 (l % 4) + {0, 1}][l / 4]
                    m = rows[8 * i:8 * i + 8].astype(np.uint32)
                    regs.append(_pair(m[2 * TIG, GID], m[2 * TIG + 1, GID]))
                frags[t][step] = regs
        return frags, xw, folds
    i4 = mode in (lk._F_I4, lk._F_I4_BF16)
    cw = warp * 128 + 16 * GID
    w = []
    for r in range(4):
        row = 4 * r + TIG if i4 else 8 * (r >> 1) + 2 * TIG + (r & 1)
        v = st[(row * ld + cw)[:, None] + np.arange(16)[None, :]]
        w.append(v ^ np.uint8(0x88) if i4 else v)
    s_off = x_off + 640
    s0 = st[(s_off + 2 * cw)[:, None] + np.arange(16)[None, :]]
    s1 = st[(s_off + 2 * cw + 16)[:, None] + np.arange(16)[None, :]]
    for t in range(8):
        I, J = t >> 2, t & 3
        sel = 0x3232 if t & 1 else 0x1010
        sp = [_byte_perm(_word(s0, t >> 1), _u32(np.zeros(32)), sel),
              _byte_perm(_word(s1, t >> 1), _u32(np.zeros(32)), sel)]
        for step in range(2):
            if i4:
                cs = [_word(w[2 * step], I), _word(w[2 * step], I + 2),
                      _word(w[2 * step + 1], I), _word(w[2 * step + 1], I + 2)]
                a = [_q4_pair(J, 0, False, c, c >> np.uint32(4)) for c in cs]
            else:
                raw = mode == lk._F_Q4_BF16_FMA
                a = [_q4_pair(J, 4 * step, raw, _word(w[0], I), _word(w[1], I)),
                     _q4_pair(J, 4 * step, raw, _word(w[0], I + 2), _word(w[1], I + 2)),
                     _q4_pair(J, 4 * step, raw, _word(w[2], I), _word(w[3], I)),
                     _q4_pair(J, 4 * step, raw, _word(w[2], I + 2), _word(w[3], I + 2))]
            if mode != lk._F_I4:
                a = [_hmul2(a[e], sp[e & 1]) for e in range(4)]
            if mode == lk._F_Q4_BF16_FMA:
                bias = [_hmul2(sp[0], _u32(np.full(32, 0xC100C100))),
                        _hmul2(sp[1], _u32(np.full(32, 0xC100C100)))]
                a = [_hadd2(a[e], bias[e & 1]) for e in range(4)]
            frags[t][step] = a
        folds[t] = [_val(sp[0] & np.uint32(0xFFFF)), _val(sp[1] & np.uint32(0xFFFF))]
    return frags, xw, folds


def _columns(mode, warp, t):
    """Output columns (in the block) of A rows gid and gid + 8 of tile t."""
    if mode == lk._F_W16:
        base = warp * 128 + 16 * t + GID
        return base, base + 8
    base = warp * 128 + 16 * GID + t
    return base, base + 8


def seen_weights(mode, st, x_off):
    """The weights as the mma sees them for one stage: [32 rows of K, 512
    columns] f32, from every lane's A fragments by the PTX layout."""
    seen = np.full((32, 512), np.nan, np.float32)
    for warp in range(4):
        frags, _, _ = lane_fragments(mode, st, x_off, warp)
        for t in range(8):
            c_lo, c_hi = _columns(mode, warp, t)
            for step in range(2):
                for reg, (cols, k0) in enumerate(((c_lo, 0), (c_hi, 0), (c_lo, 8), (c_hi, 8))):
                    lo, hi = _halves(frags[t][step][reg])
                    k = 16 * step + k0 + 2 * TIG
                    seen[k, cols], seen[k + 1, cols] = _val(lo), _val(hi)
    return seen


def _operands(name, x, leaf):
    """The kernel's weight bytes [rows of K, N * col bytes], bf16 scale bits,
    and x's bf16 bits [8, K] (split_bf16_h: the halves x_lo, x_hi [8, K/2]
    of `hoist_split`)."""
    mode = MODES[name]
    if mode == lk._F_W16:
        q = leaf["w16"].view(torch.int16).numpy().view(np.uint8)
    else:
        q = leaf["i4" if name == "i4native" else "q4"].numpy()
    s16 = leaf["s"].view(torch.int16).numpy().view(np.uint16)
    def bits(a):
        return a.to(torch.bfloat16).contiguous().view(torch.int16).numpy().view(np.uint16)

    xs = tuple(bits(h) for h in lk.hoist_split(x)) if mode == lk._F_Q4_BF16_FMA else bits(x)
    return mode, q, s16, xs


def emulate(name, x, leaf):
    """lab_decode_tc lane by lane, with lab_reduce: x bf16 [8, K], the leaf of
    the variant `name`. Returns f32 [8, N]."""
    mode, q, s16, xs = _operands(name, x, leaf)
    k = x.shape[1]
    n = leaf["s"].shape[1]
    ksplit, _ = lk.lab_plan(8, k, n, mode)
    nb = k // 32
    per = -(-nb // ksplit)
    out = np.zeros((8, n), np.float32)
    for nb0 in range(0, n, 512):
        parts = []
        for y in range(ksplit):
            red = np.zeros((8, 512), np.float32)
            for warp in range(4):
                acc = np.zeros((8, 32, 4), np.float32)
                for kb in range(y * per, min((y + 1) * per, nb)):
                    st, x_off = _stage(mode, q, s16, xs, kb, nb0, n)
                    frags, xw, folds = lane_fragments(mode, st, x_off, warp)
                    for t in range(8):
                        part = np.zeros((32, 4), np.float32)
                        for step in range(2):
                            part = _mma(part, frags[t][step], xw[2 * step], xw[2 * step + 1])
                        if mode == lk._F_I4:  # fmaf(s, part, acc)
                            f = np.stack([folds[t][0], folds[t][0], folds[t][1], folds[t][1]], 1)
                            acc[t] = (f.astype(np.float64) * part + acc[t]).astype(np.float32)
                        else:
                            acc[t] = (acc[t] + part).astype(np.float32)
                for t in range(8):
                    c_lo, c_hi = _columns(mode, warp, t)
                    for h in range(2):
                        red[2 * TIG + h, c_lo] = acc[t][:, h]
                        red[2 * TIG + h, c_hi] = acc[t][:, 2 + h]
            parts.append(red)
        res = parts[0].copy()
        for p in parts[1:]:  # lab_reduce: the parts in order
            res = (res + p).astype(np.float32)
        out[:, nb0:nb0 + 512] = res[:, :min(512, n - nb0)]
    return out


K = N = 512


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((8, K)).astype(np.float32)).to(torch.bfloat16)
    x[1, 32:64] = 0
    return x, rng.standard_normal((K, N)).astype(np.float32)


def _plain_weights(name, leaf) -> np.ndarray:
    """[K, N] f32: the weights each plain version multiplies x by."""
    mode = MODES[name]
    if mode == lk._F_W16:
        return leaf["w16"].float().numpy()
    packed = leaf["i4" if name == "i4native" else "q4"]
    s = lk._block_scales(leaf["s"])
    if mode in (lk._F_I4, lk._F_I4_BF16):
        vals = quant.unpack_w4x8(packed)
        if mode == lk._F_I4:
            return vals.float().numpy()  # the integers: the scale folds on the block sum
        return (vals.to(torch.bfloat16) * lk._block_scales(leaf["s"], torch.bfloat16)).float().numpy()
    nib = lk._raw_nibbles(packed)
    if mode == lk._F_Q4_BF16:
        return (nib * s + (-8.0 * s)).to(torch.bfloat16).float().numpy()
    sb = s.to(torch.bfloat16)
    return (nib.to(torch.bfloat16) * sb + (-8.0 * s).to(torch.bfloat16)).float().numpy()


@pytest.mark.parametrize("name", list(MODES))
def test_each_lane_builds_the_plain_versions_weights(name):
    """Every A pair a lane builds, put back by the PTX layout, is bit for bit
    the weight the plain version multiplies (L2 and L9's f32 form: the int4
    value; the bf16 forms: the plain version's bf16 weight; L12: the raw
    row), for every column and row of K of every stage, but for the sign of
    a zero: bf16dot's (nib - 8) * s is -0 at nib = 8 under a negative scale
    where nib * s - 8 s is +0, and either adds nothing to a sum."""
    x, w = _inputs()
    leaf = lab.make_leaf(torch.from_numpy(w), lab.VARIANTS[name].fmt)
    mode, q, s16, xs = _operands(name, x, leaf)
    want = _plain_weights(name, leaf)
    for kb in range(K // 32):
        st, x_off = _stage(mode, q, s16, xs, kb, 0, N)
        seen = seen_weights(mode, st, x_off) + np.float32(0)  # -0 + 0 is +0
        np.testing.assert_array_equal(seen.view(np.uint32),
                                      (want[32 * kb:32 * kb + 32] + np.float32(0)).view(np.uint32))


def _two_roundings_case():
    """A bf16 scale and nibbles where bf16(bf16(nib * s) + bf16(-8 s)) is not
    bf16((nib - 8) * s): split_bf16_h's function is the former."""
    for bits in range(0x3C00, 0x3CA0):  # bf16 scales in [2^-7, 0.0195)
        s = torch.tensor([bits], dtype=torch.int16).view(torch.bfloat16).float()
        nib = torch.arange(16, dtype=torch.float32)
        two = (nib.to(torch.bfloat16) * s.to(torch.bfloat16)
               + (-8.0 * s).to(torch.bfloat16)).float()
        one = ((nib - 8) * s).to(torch.bfloat16).float()
        if (two != one).any():
            return float(s), (two != one).nonzero()[:, 0].tolist()
    raise AssertionError("no scale in the range rounds twice differently")


def test_split_bf16_h_rounds_twice_where_one_fused_rounding_differs():
    """A Q4_0 leaf whose every scale is such a case and whose nibbles run
    through 0..15: the lanes' split_bf16_h weights are the two-rounding
    values, bit for bit, where the fused (one rounding) value differs."""
    s, nibs = _two_roundings_case()
    nib = (torch.arange(K * N) % 16).reshape(K, N)
    vals = nib - 8
    qs = quant.pack_q4(vals.to(torch.int8)) if hasattr(quant, "pack_q4") else None
    if qs is None:  # byte j of a 32-block: rows j (low nibble) and j + 16 (high)
        blk = (vals + 8).to(torch.uint8).reshape(K // 32, 2, 16, N)
        qs = (blk[:, 0] | (blk[:, 1] << 4)).reshape(K // 2, N)
    leaf = {"q4": qs, "s": torch.full((K // 32, N), s, dtype=torch.bfloat16)}
    assert torch.equal(quant.unpack_q4(leaf["q4"]).to(torch.int64), vals)
    x, _ = _inputs()
    mode, q, s16, xs = _operands("split_bf16_h", x, leaf)
    st, x_off = _stage(mode, q, s16, xs, 0, 0, N)
    seen = seen_weights(mode, st, x_off)
    two = _plain_weights("split_bf16_h", leaf)[:32]
    fused = _plain_weights("bf16dot", leaf)[:32]
    np.testing.assert_array_equal(seen, two)
    differs = np.isin(nib[:32].numpy(), nibs)
    assert differs.any() and (seen[differs] != fused[differs]).all()


def _load_jax_lab():
    spec = importlib.util.spec_from_file_location("jax_kernel_lab_tc",
                                                  ROOT / "scripts" / "kernel_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jlab():
    return _load_jax_lab()


def _jax_variant(jlab, name, x, w):
    """The JAX lab's kernel `name` through its make_call, in interpret mode."""
    kern, opts = jlab.VARIANTS[name]
    fmt = opts.get("fmt", "q4")
    if fmt == "w16":
        leaf = {"q16": jnp.asarray(w).astype(jnp.bfloat16), "s": jnp.ones((K // 32, N),
                                                                          jnp.bfloat16)}
    else:
        leaf = jquant.quantize(jnp.asarray(w), 4)
        leaf = jlab.to_i4(leaf) if fmt == "i4" else leaf
    call, ops_of = jlab.make_call(kern, opts, K, N, 8, 256, 256, fmt)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ops = jax.jit(lambda a: ops_of(a, leaf, {"w16": "q16"}.get(fmt, "q4")))(xj)
    return np.asarray(call(*ops))


@pytest.mark.parametrize("name", list(MODES))
def test_block_sums_match_plain_and_the_jax_lab(jlab, name):
    """The emulated form (the lanes' weights, the mma layout, each quant
    block's sum added in f32, the splits added in order) against the plain
    version and the JAX lab's kernel in interpret mode, K = N = 512, m = 8."""
    x, w = _inputs()
    v = lab.VARIANTS[name]
    leaf = lab.make_leaf(torch.from_numpy(w), v.fmt)
    got = emulate(name, x, leaf)
    ops = lab.HOISTS[v.hoist](x, 256)
    plain = v.plain(ops, leaf, 256).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=F32_TOL * np.abs(plain).max())
    want = _jax_variant(jlab, name, x, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())
