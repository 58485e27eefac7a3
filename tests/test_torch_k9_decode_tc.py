"""K9's tensor-core decode form (bf16 x, at most 8 rows): its route, its
split of K, the C entry point it is handed, its shared memory, the lanes'
fragments and its order of sums, against the plain version and the JAX
kernel in interpret mode.

On the card a scale-on-output matmul of at most 8 rows with bf16 x takes
`so_decode_tc` (`ops/kernels.py:k9_form`, `csrc/dequant_matmul_so.cu`):
K1's tensor-core decode form (`csrc/decode_tc.cuh`) on the raw integers.
Per 32-row quant block b it computes s_b * (x_b . raw_b - 8 * sum(x_b) for
Q4_0), the TPU kernel's function with its f32 sums in another order: the
raw nibbles (0..15) are the A operand as exact bf16, the block's x sum is
taken in f32 by the lanes of each slot and comes off the block sum before
the scale, and the splits of K are added in a fixed order. Here, without a
card, the wrapper takes the plain version; the tests pin the routing rule
(more than 8 rows take K1's tile on the raw integers, tests/
test_torch_k9_tile.py; f32 x at decode rows takes the same form on its
three bf16 parts), the split plan, the form code
and the arguments the launcher hands the entry point, the shared memory
three blocks an SM need, a numpy emulation of what each lane copies,
builds, multiplies and folds, and a torch emulation of the order of sums,
against the plain version and the JAX kernel in interpret mode at m = 1,
3, 4 and 8, Q8_0 and Q4_0.
"""

import contextlib
import ctypes
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch import kernel_lab as lab
from llamago_tpu_torch.ops import _build, kernels, quant

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).parents[1] / "csrc"
# of max|ref|, as chip_smoke's K1_TOL: the port's and JAX's f32 sums run in
# another order, and a bf16 output may then round one step apart (2^-8)
BF16_TOL = 8e-3
# of max|ref|: f32 sums in another order, no bf16 rounding
F32_TOL = 1e-5
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for its blocks
SMEM_RESERVED = 1024  # bytes the card reserves for each resident block
MS = (1, 3, 4, 8)


def _src(name="dequant_matmul_so.cu") -> str:
    return (CSRC / name).read_text()


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def bf16_values(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def leaves(bits: int, scale_dtype: str, k: int = 1024, n: int = 128, seed: int = 90):
    """A Q8_0 or Q4_0 leaf of the port and the same numbers as a JAX leaf."""
    leaf = quant.quantize(torch.from_numpy(rnd((k, n), seed + bits, 0.1)), bits)
    leaf["s"] = leaf["s"].to(getattr(torch, scale_dtype))
    key = "q8" if bits == 8 else "q4"
    return leaf, {key: jnp.asarray(leaf[key].numpy()),
                  "s": jnp.asarray(leaf["s"].float().numpy(), scale_dtype)}


@contextlib.contextmanager
def jax_k9():
    """The JAX package's scale-on-output kernel in interpret mode, for any
    m <= 8 (the switch at 8), its jit cache cleared around the change."""
    old = jkernels.FORCE_INTERPRET, jkernels.SCALE_ON_OUTPUT_MAX_M
    jkernels.FORCE_INTERPRET, jkernels.SCALE_ON_OUTPUT_MAX_M = True, 8
    jkernels._dequant_matmul_2d.clear_cache()
    try:
        yield
    finally:
        jkernels.FORCE_INTERPRET, jkernels.SCALE_ON_OUTPUT_MAX_M = old
        jkernels._dequant_matmul_2d.clear_cache()


def jax_so(x: np.ndarray, jleaf: dict, dtype) -> np.ndarray:
    with jax_k9():
        xj = jnp.asarray(x, dtype)
        assert jkernels.can_fuse(xj, jleaf)
        return np.asarray(jax.block_until_ready(jkernels.dequant_matmul(xj, jleaf)), np.float32)


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("m", range(1, 9))
def test_decode_rows_route_by_dtype(m):
    """bf16 x takes the tensor-core decode form; f32 x, which the bf16
    tensor cores cannot take without rounding it, the same form on its
    three exact bf16 parts."""
    assert kernels.k9_form(m, torch.bfloat16) == "decode_tc"
    assert kernels.k9_form(m, torch.float32) == "f32_decode_tc"


@pytest.mark.parametrize("m", [9, 16, 17, 64])
def test_more_rows_keep_the_gemv(m):
    """Only a switch above 8 sends more rows to K9: they take K1's tile on
    the raw integers (its GEMV is gone), split as K1's, and with f32 x a
    workspace that adds x's block sums to K1's."""
    for dt in (torch.bfloat16, torch.float32):
        assert kernels.k9_form(m, dt) == kernels.k1_form(m, dt)
        form, ksplit, ws = kernels.k1_plan(m, 4096, 4096, dt)
        if dt == torch.float32:  # [K/32, m rounded up to 4]
            ws += 4096 // 32 * (-(-m // 4) * 4)
        assert kernels.k9_plan(m, 4096, 4096, dt) == (form, ksplit, ws)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
                                 (4096, 32768), (4096, 32000), (1024, 128), (32, 16)])
def test_decode_plan_is_k1s(m, k, n):
    """The decode form splits K as K1's does: one wave of blocks, at least 4
    quant blocks a split, a workspace only when K is split."""
    form, ksplit, ws = kernels.k9_plan(m, k, n, torch.bfloat16)
    assert form == "decode_tc" and ksplit == kernels.decode_tc_split_for(k, n)[0]
    assert ws == (ksplit * m * n if ksplit > 1 else 0)
    assert kernels.k1_plan(m, k, n, torch.bfloat16) == (form, ksplit, ws)


def test_form_codes_match_the_c_entry_point():
    enum = re.search(r"enum Form \{ kF32Tc = (\d), kTensorCore = (\d), kDecodeTc = (\d), "
                     r"kF32DecodeTc = (\d) \};", _src())
    assert enum is not None
    assert [int(v) for v in enum.groups()] == [
        kernels.K1_FORMS[f] for f in ("f32_tc", "tensor_core", "decode_tc", "f32_decode_tc")]
    # each form for its x dtype, the decode forms at most 8 rows only; a
    # workspace for the tile with f32 x, and for every form when K is split
    assert "const bool bf16_form = form == kTensorCore || form == kDecodeTc;" in _src()
    assert "((form == kDecodeTc || form == kF32DecodeTc) && M > 8)" in _src()
    assert "bf16_form != (x_bf16 != 0)" in _src()
    assert "((ksplit > 1 || form == kF32Tc) && w == nullptr)" in _src()


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}


def test_entry_point_arguments_match_the_argtypes(monkeypatch):
    sig = re.search(r'extern "C" int llamago_dequant_matmul_so\(([^)]*)\)', _src())
    params = [p.split() for p in sig.group(1).split(",")]
    assert [p[-1] for p in params] == ["x", "q", "s", "out", "ws", "M", "K", "N", "bits",
                                       "x_bf16", "s_bf16", "form", "ksplit", "stream"]

    class Lib:
        llamago_dequant_matmul_so = type("Fn", (), {})()

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    fn = kernels._lib_so.__wrapped__()
    assert fn.argtypes == [_C_TYPES[" ".join(p[:-1])] for p in params]
    assert fn.restype is ctypes.c_int


def test_k9_and_k1_share_the_decode_form_from_one_header():
    """One body (decode_tc.cuh), instantiated raw in K9 and centred in K1,
    each kernel under its own name; both sources ship their headers."""
    assert _build.source_files("dequant_matmul_so") == ["dequant_matmul_so.cu",
                                                        "decode_tc.cuh", "tc_common.cuh",
                                                        "tile_tc.cuh"]
    assert "decode_tc.cuh" in _build.source_files("dequant_matmul")
    assert "decode_tc_body<ST, BITS, true>" in _src()
    assert "decode_tc_body<ST, BITS, false>" in _src("dequant_matmul.cu")
    body = re.compile(r"void decode_tc_body\(")
    assert body.search(_src("decode_tc.cuh"))
    assert not any(body.search(p.read_text()) for p in CSRC.glob("*.cu"))
    assert "q4_pair<J, SH, RAW>" in _src("decode_tc.cuh")


def _dt_smem(bits: int, scale_bytes: int) -> int:
    h = _src("decode_tc.cuh")

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);", h).group(1).split("+")[0]
                   .strip().replace("kDtBlockCols", "512"))

    row_ld, x_ld = 512 + 16, 80
    rows = 32 if bits == 8 else 16
    assert const("kDtStages") == 3 and "kDtRowLd = kDtBlockCols + 16, kDtXLd = 80" in h
    return 3 * (rows * row_ld + 8 * x_ld + 512 * scale_bytes + 8)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scale_bytes", [4, 2])
def test_three_blocks_an_sm_fit(bits, scale_bytes):
    """so_decode_tc's launch bounds ask for three blocks an SM: the ring of
    three quant blocks and its barriers fit, and hold the warps' sums."""
    assert "__launch_bounds__(kDtThreads, 3) so_decode_tc" in _src()
    smem = _dt_smem(bits, scale_bytes)
    assert 3 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    assert smem >= 4 * 8 * 128 * 4
    assert (smem // 3 - 8) % 16 == 0


# ------------------------------------------- what the launcher hands the C side

class _FakeEntry:
    def __init__(self):
        self.calls = []

    def __call__(self, x, q, s, out, ws, m, k, n, bits, x_bf16, s_bf16, form, ksplit, stream):
        self.calls.append(dict(m=m, bits=bits, x_bf16=x_bf16, s_bf16=s_bf16, form=form,
                               ksplit=ksplit))
        return 0


@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 4, 8, 9])
def test_launcher_counts_and_hands_the_form(monkeypatch, m, bits, sdt):
    """K9 through `dequant_matmul` with the switch at 16 on meta tensors:
    the form code, split and workspace it hands its entry point, and its
    counts (`launches`, `launches_decode_tc`, and above 8 rows `launches_tc`
    and `launches_f32_tc`, the tile's)."""
    for attr in ("launches", "launches_decode_tc", "launches_f32_decode_tc", "launches_tc",
                 "launches_f32_tc"):
        monkeypatch.setattr(kernels.dequant_matmul_so, attr, 0)
    monkeypatch.setattr(kernels, "SCALE_ON_OUTPUT_MAX_M", 16)
    entry = _FakeEntry()
    monkeypatch.setattr(kernels, "_lib_so", lambda: entry)
    monkeypatch.setattr(kernels, "_cuda_or_raise", lambda x, what: None)
    monkeypatch.setattr(kernels, "_check_cuda_args", lambda *a, **kw: None)
    monkeypatch.setattr(kernels, "_stream", lambda x2: 0)
    meta = torch.device("meta")
    k, n = 4096, 4096
    key = "q8" if bits == 8 else "q4"
    w = {key: torch.empty((k if bits == 8 else k // 2, n), device=meta,
                          dtype=torch.int8 if bits == 8 else torch.uint8),
         "s": torch.empty((k // 32, n), dtype=sdt, device=meta)}
    workspaces = []
    empty = torch.empty

    def spy(*shape, **kw):
        x = empty(*shape, **kw)
        if x.dtype == torch.float32 and x.dim() == 1:
            workspaces.append(x.numel())
        return x

    xs = [empty((m, k), dtype=dt, device=meta) for dt in (torch.bfloat16, torch.float32)]
    monkeypatch.setattr(torch, "empty", spy)
    for x in xs:
        out = kernels.dequant_matmul(x, w)
        assert out.shape == (m, n) and out.dtype == x.dtype
    tc = m <= 8
    form, ksplit, ws = kernels.k9_plan(m, k, n, torch.bfloat16)
    assert form == ("decode_tc" if tc else "tensor_core") and (ws > 0) == (ksplit > 1)
    # f32 x: the same form on its three parts; the decode form splits as
    # with bf16 x, the tile as K1's f32 tile with x's block sums
    form32, ksplit32, ws32 = kernels.k9_plan(m, k, n, torch.float32)
    if tc:
        assert (form32, ksplit32, ws32) == ("f32_decode_tc", ksplit, ws)
    else:
        assert form32 == "f32_tc" and ws32 == kernels.k9_workspace(m, k, n, ksplit32)
    want = [dict(m=m, bits=bits, x_bf16=1, s_bf16=int(sdt == torch.bfloat16),
                 form=3 if tc else 2, ksplit=ksplit),
            dict(m=m, bits=bits, x_bf16=0, s_bf16=int(sdt == torch.bfloat16),
                 form=4 if tc else 1, ksplit=ksplit32)]
    assert entry.calls == want
    # one f32 workspace a call where it takes one
    assert workspaces == [n_ for n_ in (ws, ws32) if n_]
    so = kernels.dequant_matmul_so
    assert (so.launches, so.launches_decode_tc, so.launches_f32_decode_tc, so.launches_tc,
            so.launches_f32_tc) == (2, int(tc), int(tc), int(not tc), int(not tc))


def test_lab_row_l4_is_held_to_the_bf16_rate():
    """L4 runs K9 on bf16 x at the lab's m = 8: its decode form (bf16 mma),
    so its bound is against the bf16 rate, and the bytes bound it."""
    v = lab.VARIANTS["int8dot"]
    assert v.row == "L4" and v.rate == "bf16" and v.kernels == ("so_",)
    assert kernels.k9_form(8, torch.bfloat16) == "decode_tc"
    assert lab.variant_bound("int8dot", 8192, 7168, 8, 1024)[1] == "bytes"


# --------------------------------------------------- the lanes' fragments

LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3


def _byte_perm(a, b, sel):
    src = [(a >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [(b >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(a)
    for j in range(4):
        out |= src[(sel >> (4 * j)) & 7] << np.uint32(8 * j)
    return out


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _bf16_bits(f):
    u = np.asarray(f, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32) & np.uint32(0xFFFF)


def _pair_values(word):
    return _f32(word << np.uint32(16)), _f32(word & np.uint32(0xFFFF0000))


def _i8_pair(j, lo, hi):
    magic = np.full_like(lo, 0x4B000000)
    a = _f32(_byte_perm(lo, magic, 0x7440 | j)) - np.float32(8388736.0)
    b = _f32(_byte_perm(hi, magic, 0x7440 | j)) - np.float32(8388736.0)
    return _bf16_bits(a) | (_bf16_bits(b) << np.uint32(16))


def _q4_raw_pair(j, sh, lo, hi):
    """q4_pair<J, SH, true>: the nibble as it is, 0x43nn less 0x4300."""
    t = _byte_perm(lo, hi, j | ((4 + j) << 8))
    v = ((t >> np.uint32(sh)) & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    a, b = _pair_values(v)
    return _bf16_bits(a - np.float32(128)) | (_bf16_bits(b - np.float32(128)) << np.uint32(16))


def _mma(part, a, b0, b1):
    """mma.m16n8k16 over one warp by the PTX fragment layout: part (lanes x
    4) += the lanes' C values (every product exact, one f32 rounding)."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for reg, (row, kk) in enumerate(((GID, 2 * TIG), (GID + 8, 2 * TIG),
                                     (GID, 2 * TIG + 8), (GID + 8, 2 * TIG + 8))):
        lo, hi = _pair_values(a[reg])
        A[row, kk], A[row, kk + 1] = lo, hi
    for reg, kk in ((b0, 2 * TIG), (b1, 2 * TIG + 8)):
        lo, hi = _pair_values(reg)
        B[kk, GID], B[kk + 1, GID] = lo, hi
    C = (A @ B).astype(np.float32)
    part += np.stack([C[GID, 2 * TIG], C[GID, 2 * TIG + 1], C[GID + 8, 2 * TIG],
                      C[GID + 8, 2 * TIG + 1]], axis=1)


def _words(rows16):
    return np.ascontiguousarray(rows16).view(np.uint32)


def emulate_so_decode_tc(x_bf16: np.ndarray, leaf: dict, rng) -> np.ndarray:
    """so_decode_tc lane by lane, in numpy: the stage a block's bulk copies
    fill (its 512 columns of each weight row, x, the scales), the 16-byte
    reads each lane makes of it, the raw A pairs (bit for bit), the B pairs
    of x, the mma by the PTX fragment layout, Q4_0's 8 * sum(x_b) (each
    lane's 8 values of its slot added in order, the four lanes' sums by xor
    shuffles, then the lanes of slots 2 tig and 2 tig + 1), the fold, each
    warp's own columns and so_reduce's fixed-order sum of the splits.
    Weight bytes and scales past N are garbage; x rows past M are never
    copied (NaN in the stage). Returns f32 [M, N]."""
    m, k = x_bf16.shape
    bits = 8 if "q8" in leaf else 4
    q = leaf["q8"].numpy().view(np.uint8) if bits == 8 else leaf["q4"].numpy()
    n = q.shape[1]
    s = leaf["s"].float().numpy()
    ncols = -(-n // 512) * 512
    qpad = np.concatenate([q, rng.integers(0, 256, (q.shape[0], ncols - n), np.uint8)], 1)
    spad = np.concatenate([s, rng.standard_normal((s.shape[0], ncols - n)).astype(np.float32)],
                          1)
    xs = np.full((8, k), np.nan, np.float32)  # stage rows past M: never copied
    xs[:m] = x_bf16
    xbits = np.zeros((8, k), np.uint16)
    xbits[:m] = torch.from_numpy(x_bf16).to(torch.bfloat16).view(torch.int16).numpy().view(
        np.uint16)
    nb = k // 32
    ksplit, per = kernels.decode_tc_split_for(k, n)
    rows, wr = (32, 8) if bits == 8 else (16, 4)
    out = np.zeros((m, ncols), np.float32)
    for nb0 in range(0, ncols, 512):
        partials = []
        for y in range(ksplit):
            red = np.zeros((8, 512), np.float32)
            for warp in range(4):
                cols = nb0 + 128 * warp + 16 * GID[:, None] + np.arange(16)[None]
                acc = np.zeros((32, 8, 4), np.float32)
                for kb in range(y * per, min((y + 1) * per, nb)):
                    stage = qpad[kb * rows:(kb + 1) * rows]
                    w = [_words(stage[(16 * (r >> 2) + 8 * ((r >> 1) & 1) + 2 * TIG
                                       + (r & 1))[:, None], cols]) for r in range(wr)]
                    if bits == 8:
                        w = [v ^ np.uint32(0x80808080) for v in w]
                    xb = np.stack([xbits[GID[:, None], kb * 32 + 2 * TIG[:, None] + 8 * j
                                         + np.arange(2)] for j in range(4)], 1)
                    xw = np.ascontiguousarray(xb).view(np.uint32)[..., 0]
                    xw = np.where((GID < m)[:, None], xw, 0).astype(np.uint32)
                    xs8 = np.zeros((32, 2), np.float32)
                    if bits == 4:
                        part_sum = np.zeros(32, np.float32)
                        for i in range(8):  # x[gid][8 tig + i], added in order
                            part_sum = (part_sum + xs[GID, kb * 32 + 8 * TIG + i]).astype(
                                np.float32)
                        part_sum = np.where(GID < m, part_sum, np.float32(0))
                        y4 = part_sum.reshape(8, 4)
                        slot_sum = ((y4[:, 0] + y4[:, 1]) + (y4[:, 2] + y4[:, 3])).astype(
                            np.float32)
                        xs8 = np.stack([8 * slot_sum[2 * TIG], 8 * slot_sum[2 * TIG + 1]],
                                       1).astype(np.float32)
                    sc = spad[kb][cols]
                    for t in range(8):
                        i, j = t >> 2, t & 3
                        part = np.zeros((32, 4), np.float32)
                        for step in range(2):
                            if bits == 8:
                                r = 4 * step
                                a = [_i8_pair(j, w[r][:, i], w[r + 1][:, i]),
                                     _i8_pair(j, w[r][:, i + 2], w[r + 1][:, i + 2]),
                                     _i8_pair(j, w[r + 2][:, i], w[r + 3][:, i]),
                                     _i8_pair(j, w[r + 2][:, i + 2], w[r + 3][:, i + 2])]
                            else:
                                sh = 4 * step
                                a = [_q4_raw_pair(j, sh, w[0][:, i], w[1][:, i]),
                                     _q4_raw_pair(j, sh, w[0][:, i + 2], w[1][:, i + 2]),
                                     _q4_raw_pair(j, sh, w[2][:, i], w[3][:, i]),
                                     _q4_raw_pair(j, sh, w[2][:, i + 2], w[3][:, i + 2])]
                            _mma(part, a, xw[:, 2 * step], xw[:, 2 * step + 1])
                        if bits == 4:
                            part = (part - xs8[:, [0, 1, 0, 1]]).astype(np.float32)
                        for e, half in ((0, 0), (1, 0), (2, 1), (3, 1)):
                            acc[:, t, e] = (np.float64(sc[:, 8 * half + t]) * part[:, e]
                                            + acc[:, t, e]).astype(np.float32)
                for h in range(2):
                    slot = 2 * TIG + h
                    for t in range(8):
                        red[slot, 128 * warp + 16 * GID + t] = acc[:, t, h]
                        red[slot, 128 * warp + 16 * GID + 8 + t] = acc[:, t, 2 + h]
            partials.append(red[:m])
        res = partials[0].copy()
        for p in partials[1:]:
            res = (res + p).astype(np.float32)
        out[:, nb0:nb0 + 512] = res
    return out[:, :n]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(1, 256, 384), (3, 1024, 640), (4, 512, 128),
                                   (8, 512, 384)])
def test_fragment_layout_emulation_matches_plain_and_jax(m, k, n, bits):
    """The lanes' copies, raw A pairs, the x sums, the mma layout and the
    output placement, with garbage in the weight bytes and scales past N
    and NaN in the x rows past M (N short of a 512-column block at three
    shapes), against the plain version and the JAX kernel in interpret
    mode, in f32: what the card's build has to get right."""
    leaf = quant.quantize(torch.from_numpy(rnd((k, n), 80 + m, 0.1)), bits)
    x = bf16_values(rnd((m, k), 90 + m))
    got = emulate_so_decode_tc(x, leaf, np.random.default_rng(5))
    assert np.isfinite(got).all()
    want = kernels.dequant_matmul_so_plain(torch.from_numpy(x), leaf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())
    jleaf = {("q8" if bits == 8 else "q4"): jnp.asarray(leaf["q8" if bits == 8 else "q4"]
                                                        .numpy()),
             "s": jnp.asarray(leaf["s"].float().numpy())}
    jgot = jax_so(x, jleaf, jnp.float32)
    np.testing.assert_allclose(got, jgot, rtol=0, atol=F32_TOL * np.abs(jgot).max())


def test_raw_nibble_pairs_are_exact_and_not_centred():
    """Every nibble becomes its own bf16 value 0..15 (K1's centred pair
    would give nibble - 8): the offset goes through the block sum."""
    byte = np.arange(256, dtype=np.uint32)
    for j in range(4):
        for sh in (0, 4):
            got = _q4_raw_pair(j, sh, byte << np.uint32(8 * j),
                               byte[::-1] << np.uint32(8 * j))
            a, b = _pair_values(got)
            assert np.array_equal(a, (byte >> sh) & 0xF)
            assert np.array_equal(b, (byte[::-1] >> sh) & 0xF)
    assert "RAW ? 0x43004300u : 0x43084308u" in _src("tc_common.cuh")


# ---------------------------------------------------------------- function

CASES = [(m, bits, sdt) for m in MS for bits in (8, 4) for sdt in ("float32", "bfloat16")]


@pytest.mark.parametrize("m,bits,scale_dtype", CASES)
def test_k9_bf16_decode_matches_jax_interpret(m, bits, scale_dtype):
    """The wrapper's CPU route (the plain version) at the decode rows with
    bf16 x, the function the decode form computes on the card, against the
    JAX scale-on-output kernel in interpret mode."""
    leaf, jleaf = leaves(bits, scale_dtype)
    x = bf16_values(rnd((m, 1024), 100 + m))
    want = jax_so(x, jleaf, jnp.bfloat16)
    before = (kernels.dequant_matmul_so.launches, kernels.dequant_matmul_so.launches_decode_tc)
    got = kernels.dequant_matmul_so(torch.from_numpy(x).to(torch.bfloat16), leaf)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 128)
    assert (kernels.dequant_matmul_so.launches,
            kernels.dequant_matmul_so.launches_decode_tc) == before  # the CPU: no launch
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())


def decode_order(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """The decode form's order of sums, in f32: per 32-row quant block the
    exact dot of bf16 x with the raw integers, less 8 * the block's x sum
    for Q4_0, times the block's scale, added up block by block inside each
    split of `decode_tc_split_for`; the splits' partials then added in
    order (so_reduce)."""
    m, k = x.shape
    nb = k // 32
    xb = x.to(torch.float32).reshape(m, nb, 32)
    q4 = "q4" in leaf
    q = (quant.unpack_q4(leaf["q4"]) + 8 if q4 else leaf["q8"]).to(torch.float32)
    n = q.shape[-1]
    part = torch.einsum("mbk,bkn->bmn", xb, q.reshape(nb, 32, n))  # exact products
    if q4:
        part = part - 8 * xb.sum(-1).T[..., None]
    s = leaf["s"].to(torch.float32)
    ksplit, per = kernels.decode_tc_split_for(k, n)
    out = torch.zeros((m, n), dtype=torch.float32)
    for y in range(ksplit):
        acc = torch.zeros((m, n), dtype=torch.float32)
        for b in range(y * per, min((y + 1) * per, nb)):
            acc = acc + s[b] * part[b]
        out = out + acc
    return out


@pytest.mark.parametrize("m,bits,scale_dtype", CASES)
def test_decode_order_stays_within_the_tpu_function(m, bits, scale_dtype):
    """The reordering (the offset and scale on each block's f32 dot, K
    split) against the JAX kernel in f32, before any bf16 output rounding:
    JAX gets the bf16 x values widened to f32, exactly."""
    leaf, jleaf = leaves(bits, scale_dtype, k=4096)
    x = bf16_values(rnd((m, 4096), 110 + m))
    want = jax_so(x, jleaf, jnp.float32)
    got = decode_order(torch.from_numpy(x).to(torch.bfloat16), leaf).numpy()
    assert kernels.decode_tc_split_for(4096, 128)[0] > 1  # the splits are exercised
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())
