"""K1's tensor-core decode form (bf16 x, at most 8 rows): its route, its
split of K, the lanes' fragments and its order of sums, against the JAX
package on the CPU.

On the card a Q8_0 / Q4_0 matmul of at most 8 rows with bf16 x takes
`dq_decode_tc` (`ops/kernels.py:k1_form`): the weights are the A operand of
bf16 mma.sync.m16n8k16 and the slots are the 8 columns of B; per 32-row
quant block b it computes s_b * (x_b . q_b), the TPU kernel's f32 function
with its sums in another order. Here, without a card, the wrapper takes the
plain version; the tests pin the routing rule (f32 x takes the same form
on its three bf16 parts, K9 keeps its own GEMV plan above 8 rows), the
split plan and the form code the launcher
hands the entry point, a numpy emulation of what each lane copies, builds
and multiplies, the function at the decode row counts against the JAX
kernel in interpret mode, and a torch emulation of the kernel's order of
sums against the same JAX function in f32.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch import kernel_lab as lab
from llamago_tpu_torch.ops import _build, kernels, quant

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).parents[1] / "csrc"
# the 7B projections (name, K, N) chip_smoke times, the head padded to 32768
SHAPES_7B = (("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w13", 4096, 22016),
             ("w2", 11008, 4096), ("lm_head", 4096, 32768))
# of max|ref|: the port's and JAX's f32 sums run in another order, and a
# bf16 output may then round one step apart (2^-8 of a value)
BF16_TOL = 8e-3
# of max|ref|: f32 sums in another order, no bf16 rounding
F32_TOL = 1e-5


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def bf16_values(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, as f32 (exact)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def leaves(bits: int, scale_dtype: str, k: int = 4096, n: int = 128, seed: int = 70):
    """A Q8_0 or Q4_0 leaf of the port and the same numbers as a JAX leaf."""
    leaf = quant.quantize(torch.from_numpy(rnd((k, n), seed + bits, 0.1)), bits)
    leaf["s"] = leaf["s"].to(getattr(torch, scale_dtype))  # a file brings f32 scales
    key = "q8" if bits == 8 else "q4"
    jleaf = {key: jnp.asarray(leaf[key].numpy()),
             "s": jnp.asarray(leaf["s"].float().numpy(), scale_dtype)}
    return leaf, jleaf


def jax_k1(x: np.ndarray, jleaf: dict, dtype) -> np.ndarray:
    """The JAX K1 (`_dequant_mm_kernel`, rows padded to 8) in interpret
    mode, as f32."""
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    try:
        xj = jnp.asarray(x, dtype)
        assert jkernels.can_fuse(xj, jleaf)
        return np.asarray(jkernels.dequant_matmul(xj, jleaf), np.float32)
    finally:
        jkernels.FORCE_INTERPRET = old


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("m", range(1, 9))
def test_decode_rows_route_by_dtype(m):
    """bf16 x takes the tensor-core decode form; f32 x, which the bf16
    tensor cores cannot take without rounding it, the same form on its
    three exact bf16 parts."""
    assert kernels.k1_form(m, torch.bfloat16) == "decode_tc"
    assert kernels.k1_form(m, torch.float32) == "f32_decode_tc"


@pytest.mark.parametrize("m", [9, 16, 17, 64, 256])
def test_more_rows_route_as_before(m):
    assert kernels.k1_form(m, torch.bfloat16) == "tensor_core"
    assert kernels.k1_form(m, torch.float32) == "f32_tc"


def test_decode_form_code_matches_the_c_entry_point():
    src = (CSRC / "dequant_matmul.cu").read_text()
    enum = re.search(r"enum Form \{[^}]*kDecodeTc = (\d),", src)
    assert enum is not None
    assert int(enum.group(1)) == kernels.K1_FORMS["decode_tc"] == 3
    # the entry point takes the code, for bf16 x and at most 8 rows only;
    # the f32 forms only f32 x
    assert "form > kF32DecodeTc" in src
    assert "((form == kDecodeTc || form == kF32DecodeTc) && M > 8)" in src
    assert "const bool bf16_form = form == kTensorCore || form == kDecodeTc;" in src
    assert "bf16_form != (x_bf16 != 0)" in src


@pytest.mark.parametrize("fn", ["i8_pair", "q4_pair", "mbar_init", "mbar_init_fence",
                                "mbar_expect", "mbar_wait", "l2_evict_first", "bulk_copy"])
def test_decode_form_helpers_live_once_in_the_shared_header(fn):
    """The pair builders the decode form shares with dq_tc, and its TMA and
    mbarrier wrappers, are defined in tc_common.cuh and in no source; K1's
    library uses them (the decode form's body is in decode_tc.cuh, which
    K9 shares)."""
    pattern = re.compile(rf"__device__ __forceinline__ \w+ {fn}\(")
    assert pattern.search((CSRC / "tc_common.cuh").read_text())
    assert not any(pattern.search(p.read_text()) for p in CSRC.glob("*.cu"))
    uses = "".join((CSRC / rel).read_text() for rel in _build.source_files("dequant_matmul")
                   if rel != "tc_common.cuh")
    assert f"{fn}<" in uses or f"{fn}(" in uses


# ------------------------------------------------------------- split plan

def _check_split(k, n):
    nb = k // 32
    ksplit, per = kernels.decode_tc_split_for(k, n)
    assert ksplit >= 1 and per >= 1
    assert per == -(-nb // ksplit)  # the C side cuts at ceil(nb / ksplit)
    # whole quant blocks, every split non-empty, all of K covered
    spans = [(y * per, min((y + 1) * per, nb)) for y in range(ksplit)]
    assert all(a < b for a, b in spans) and spans[-1][1] == nb
    return ksplit, per


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("name,k,n", SHAPES_7B)
def test_decode_split_never_leaves_an_empty_split(name, k, n, m):
    ksplit, per = _check_split(k, n)
    # at least 4 quant blocks a split; one wave of the three blocks an SM
    # holds, as full as 4 quant blocks a split allow
    assert per >= 4
    blocks = -(-n // 512) * ksplit
    assert 256 <= blocks <= 396, (name, ksplit, blocks)
    form, ks, ws = kernels.k1_plan(m, k, n, torch.bfloat16)
    assert (form, ks) == ("decode_tc", ksplit)
    assert ws == (ksplit * m * n if ksplit > 1 else 0)


@pytest.mark.parametrize("k,n", [(32, 16), (96, 4000), (352, 144), (1376, 512),
                                 (512, 32000), (4096, 262144), (11008, 16)])
def test_decode_split_at_odd_shapes(k, n):
    ksplit, per = _check_split(k, n)
    nb, strips = k // 32, -(-n // 512)
    # no split when fewer than two splits of 4 quant blocks fit or the
    # strips fill a wave; never more blocks than a wave unless the strips do
    assert (ksplit == 1) == (nb < 8 or strips > 198)
    assert strips * ksplit <= max(396, strips)


# ------------------------------------------- what the launcher hands the C side

class _FakeEntry:
    """Stands in for a C entry point: records the form code, ksplit and
    workspace it is handed (data pointers of meta tensors are not read)."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, q, s, out, ws, m, k, n, bits, x_bf16, s_bf16, form, ksplit, stream):
        self.calls.append(dict(m=m, k=k, n=n, bits=bits, x_bf16=x_bf16, form=form,
                               ksplit=ksplit))
        return 0


def _launch_on_meta(monkeypatch, fn, lib_attr, m, bits, dtype, k=4096, n=4096):
    """Call a K1 / K9 wrapper on meta tensors with the C entry point, the
    stream and the argument checks stubbed (the launch counts are put back
    afterwards); returns the entry point's recorded calls."""
    for wrapper in (kernels.dequant_matmul, kernels.dequant_matmul_so):
        for attr in [a for a in vars(wrapper) if a.startswith("launches")]:
            monkeypatch.setattr(wrapper, attr, getattr(wrapper, attr))
    entry = _FakeEntry()
    monkeypatch.setattr(kernels, lib_attr, lambda: entry)
    monkeypatch.setattr(kernels, "_cuda_or_raise", lambda x, what: None)
    monkeypatch.setattr(kernels, "_check_cuda_args", lambda *a, **kw: None)
    monkeypatch.setattr(kernels, "_stream", lambda x2: 0)
    meta = torch.device("meta")
    x = torch.empty((m, k), dtype=dtype, device=meta)
    key = "q8" if bits == 8 else "q4"
    w = {key: torch.empty((k if bits == 8 else k // 2, n), dtype=torch.int8 if bits == 8
                          else torch.uint8, device=meta),
         "s": torch.empty((k // 32, n), dtype=torch.bfloat16, device=meta)}
    out = fn(x, w)
    assert out.shape == (m, n) and out.dtype == dtype
    return entry.calls


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_k1_hands_the_decode_form_to_its_entry_point(monkeypatch, m, bits):
    counts = (kernels.dequant_matmul.launches_tc, kernels.dequant_matmul.launches_decode_tc)
    calls = _launch_on_meta(monkeypatch, kernels.dequant_matmul, "_lib", m, bits,
                            torch.bfloat16)
    ksplit = kernels.decode_tc_split_for(4096, 4096)[0]
    assert calls == [dict(m=m, k=4096, n=4096, bits=bits, x_bf16=1, form=3, ksplit=ksplit)]
    assert (kernels.dequant_matmul.launches_tc,
            kernels.dequant_matmul.launches_decode_tc) == (counts[0], counts[1] + 1)
    # f32 x takes the same form on its three parts (code 4, the same split),
    # uncounted by the bf16 decode form
    calls = _launch_on_meta(monkeypatch, kernels.dequant_matmul, "_lib", m, bits,
                            torch.float32)
    assert calls[0]["form"] == 4 and calls[0]["ksplit"] == ksplit
    assert kernels.dequant_matmul.launches_decode_tc == counts[1] + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 3, 8, 16])
def test_k9_keeps_its_own_gemv_plan(monkeypatch, m, dtype):
    """K9 shares the launcher but plans with `k9_plan`, through its own
    entry point (`csrc/dequant_matmul_so.cu` takes K1's four codes, no
    other; its GEMV's code 0 is gone): decode rows hand it the decode form's
    code for x's dtype and its split, more than 8 rows the tile's and the
    tile's split."""
    assert "form < kF32Tc || form > kF32DecodeTc" in (CSRC / "dequant_matmul_so.cu").read_text()
    calls = _launch_on_meta(monkeypatch, kernels.dequant_matmul_so, "_lib_so", m, 8, dtype)
    if m <= 8:
        form = 3 if dtype == torch.bfloat16 else 4
        ksplit = kernels.decode_tc_split_for(4096, 4096)[0]
    else:
        form = 2 if dtype == torch.bfloat16 else 1
        ksplit = kernels.k1_plan(m, 4096, 4096, dtype)[1]
    assert calls == [dict(m=m, k=4096, n=4096, bits=8, x_bf16=int(dtype == torch.bfloat16),
                          form=form, ksplit=ksplit)]


# ------------------------------------------------------------------ the lab

@pytest.mark.parametrize("name", [n for n, v in lab.VARIANTS.items() if v.row in ("L1", "L5")])
def test_lab_k1_rows_are_held_to_the_bf16_rate(name):
    """L1 and L5 run K1 on bf16 x: at the lab's m = 8 the decode form (bf16
    mma), so their bound is against the bf16 rate (the bytes bound it)."""
    v = lab.VARIANTS[name]
    assert kernels.k1_form(8, torch.bfloat16) == "decode_tc"
    assert v.rate == "bf16" and v.kernels == ("dq_",)
    assert lab.variant_bound(name, 8192, 7168, 8, 1024)[1] == "bytes"


# --------------------------------------------------- the lanes' fragments

def _byte_perm(a, b, sel):
    """__byte_perm: byte j of the result is byte (sel >> 4j) & 7 of {b, a}."""
    src = [(a >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [(b >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(a)
    for j in range(4):
        out |= src[(sel >> (4 * j)) & 7] << np.uint32(8 * j)
    return out


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _bf16_bits(f):
    """f32 -> bf16 bits, round to nearest even (finite values)."""
    u = np.asarray(f, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32) & np.uint32(0xFFFF)


def _pair_values(word):
    """A bf16x2 register as its (low, high) f32 values."""
    return _f32(word << np.uint32(16)), _f32(word & np.uint32(0xFFFF0000))


def _i8_pair(j, lo, hi):
    magic = np.full_like(lo, 0x4B000000)
    a = _f32(_byte_perm(lo, magic, 0x7440 | j)) - np.float32(8388736.0)
    b = _f32(_byte_perm(hi, magic, 0x7440 | j)) - np.float32(8388736.0)
    return _bf16_bits(a) | (_bf16_bits(b) << np.uint32(16))


def _q4_pair(j, sh, lo, hi):
    t = _byte_perm(lo, hi, j | ((4 + j) << 8))
    v = ((t >> np.uint32(sh)) & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    a, b = _pair_values(v)
    # __hsub2 of two bf16 pairs: 128 + n - 136 is exact in bf16
    return _bf16_bits(a - np.float32(136)) | (_bf16_bits(b - np.float32(136)) << np.uint32(16))


LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3


def _mma(part, a, b0, b1):
    """mma.m16n8k16 over one warp: lane registers -> A [16, 16], B [16, 8]
    by the PTX fragment layout; part (lanes x 4) += the lanes' C values."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for reg, (row, kk) in enumerate(((GID, 2 * TIG), (GID + 8, 2 * TIG),
                                     (GID, 2 * TIG + 8), (GID + 8, 2 * TIG + 8))):
        lo, hi = _pair_values(a[reg])
        A[row, kk], A[row, kk + 1] = lo, hi
    for reg, kk in ((b0, 2 * TIG), (b1, 2 * TIG + 8)):
        lo, hi = _pair_values(reg)
        B[kk, GID], B[kk + 1, GID] = lo, hi
    C = (A @ B).astype(np.float32)  # every product exact, one f32 rounding
    part += np.stack([C[GID, 2 * TIG], C[GID, 2 * TIG + 1], C[GID + 8, 2 * TIG],
                      C[GID + 8, 2 * TIG + 1]], axis=1)


def _words(rows16):
    """[lanes, 16] bytes -> [lanes, 4] little-endian uint32 words."""
    return np.ascontiguousarray(rows16).view(np.uint32)


def emulate_decode_tc(x_bf16: np.ndarray, leaf: dict, rng) -> np.ndarray:
    """dq_decode_tc lane by lane, in numpy: the stage a block's bulk copies
    fill (its 512 columns of each weight row, x, the scales), the 16-byte
    reads each lane makes of it, the A pairs its builders make of them (bit
    for bit), the B pairs of x, the mma by the PTX fragment layout, the
    fold, each warp's own columns and dq_reduce's fixed-order sum of the
    splits. Weight bytes and scales past N are garbage; x rows past M are
    never copied (zeros in registers). Returns f32 [M, N]."""
    m, k = x_bf16.shape
    bits = 8 if "q8" in leaf else 4
    q = (leaf["q8"].numpy().view(np.uint8) if bits == 8 else leaf["q4"].numpy())
    n = q.shape[1]
    s = leaf["s"].float().numpy()
    ncols = -(-n // 512) * 512
    qpad = np.concatenate([q, rng.integers(0, 256, (q.shape[0], ncols - n), np.uint8)], 1)
    spad = np.concatenate([s, rng.standard_normal((s.shape[0], ncols - n)).astype(np.float32)],
                          1)
    xbits = torch.from_numpy(x_bf16).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    xb = np.zeros((8, k), np.uint16)
    xb[:m] = xbits
    nb = k // 32
    ksplit, per = kernels.decode_tc_split_for(k, n)
    rows, wr = (32, 8) if bits == 8 else (16, 4)
    out = np.zeros((m, ncols), np.float32)
    for nb0 in range(0, ncols, 512):
        partials = []
        for y in range(ksplit):
            red = np.zeros((8, 512), np.float32)
            for warp in range(4):
                cols = nb0 + 128 * warp + 16 * GID[:, None] + np.arange(16)[None]  # [lanes, 16]
                acc = np.zeros((32, 8, 4), np.float32)
                for kb in range(y * per, min((y + 1) * per, nb)):
                    stage = qpad[kb * rows:(kb + 1) * rows]  # the block's rows, by bulk copy
                    # w[r]: row 16*(r // 4) + 8*((r // 2) % 2) + 2*tig + r % 2
                    w = [_words(stage[(16 * (r >> 2) + 8 * ((r >> 1) & 1) + 2 * TIG
                                       + (r & 1))[:, None], cols]) for r in range(wr)]
                    if bits == 8:
                        w = [v ^ np.uint32(0x80808080) for v in w]
                    # B: slot gid at k = 2*tig + {0, 8, 16, 24}, 0 past M
                    xs = np.stack([xb[GID[:, None], kb * 32 + 2 * TIG[:, None] + 8 * j
                                      + np.arange(2)] for j in range(4)], 1)  # [lanes, 4, 2]
                    xw = np.ascontiguousarray(xs).view(np.uint32)[..., 0]
                    xw = np.where((GID < m)[:, None], xw, 0).astype(np.uint32)
                    sc = spad[kb][cols]  # [lanes, 16]: columns n .. n+15
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
                                a = [_q4_pair(j, sh, w[0][:, i], w[1][:, i]),
                                     _q4_pair(j, sh, w[0][:, i + 2], w[1][:, i + 2]),
                                     _q4_pair(j, sh, w[2][:, i], w[3][:, i]),
                                     _q4_pair(j, sh, w[2][:, i + 2], w[3][:, i + 2])]
                            _mma(part, a, xw[:, 2 * step], xw[:, 2 * step + 1])
                        for e, half in ((0, 0), (1, 0), (2, 1), (3, 1)):
                            acc[:, t, e] = np.float32(sc[:, 8 * half + t] * part[:, e]
                                                      + acc[:, t, e])
                for h in range(2):
                    slot = 2 * TIG + h
                    for t in range(8):
                        red[slot, 128 * warp + 16 * GID + t] = acc[:, t, h]
                        red[slot, 128 * warp + 16 * GID + 8 + t] = acc[:, t, 2 + h]
            partials.append(red[:m])
        res = partials[0].copy()
        for p in partials[1:]:
            res = res + p
        out[:, nb0:nb0 + 512] = res
    return out[:, :n]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(1, 256, 144), (3, 352, 528), (8, 512, 272)])
def test_fragment_layout_emulation_matches_the_plain_version(m, k, n, bits):
    """The lanes' copies, A / B pairs, mma layout and output placement, with
    garbage in the weight bytes past N, against the plain version in f32:
    what the card's first build has to get right."""
    leaf = quant.quantize(torch.from_numpy(rnd((k, n), 80 + m, 0.1)), bits)
    x = bf16_values(rnd((m, k), 90 + m))
    got = emulate_decode_tc(x, leaf, np.random.default_rng(5))
    want = kernels.dequant_matmul_plain(torch.from_numpy(x), leaf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


def test_pair_builders_are_exact():
    """Every int8 value and every nibble becomes its exact bf16 value."""
    q = np.arange(-128, 128, dtype=np.int32)
    lo = (q.astype(np.uint32) & 0xFF) ^ 0x80  # XORed with 0x80, byte 0
    hi = np.roll(lo, 1)
    for j in range(4):
        got = _i8_pair(j, lo << np.uint32(8 * j), hi << np.uint32(8 * j))
        a, b = _pair_values(got)
        assert np.array_equal(a, q) and np.array_equal(b, np.roll(q, 1))
    byte = np.arange(256, dtype=np.uint32)
    for j in range(4):
        for sh in (0, 4):
            got = _q4_pair(j, sh, byte << np.uint32(8 * j), byte[::-1] << np.uint32(8 * j))
            a, b = _pair_values(got)
            assert np.array_equal(a, ((byte >> sh) & 0xF) - 8.0)
            assert np.array_equal(b, ((byte[::-1] >> sh) & 0xF) - 8.0)


# ---------------------------------------------------------------- function

CASES = [(m, bits, sdt) for m in (1, 2, 4, 8) for bits in (8, 4)
         for sdt in ("float32", "bfloat16")]


@pytest.mark.parametrize("m,bits,scale_dtype", CASES)
def test_k1_bf16_decode_matches_jax_interpret(m, bits, scale_dtype):
    """The wrapper's CPU route (the plain version) at the decode rows with
    bf16 x: the function the decode form computes on the card."""
    leaf, jleaf = leaves(bits, scale_dtype)
    x = bf16_values(rnd((m, 4096), 100 + m))
    want = jax_k1(x, jleaf, jnp.bfloat16)
    before = (kernels.dequant_matmul.launches, kernels.dequant_matmul.launches_q4,
              kernels.dequant_matmul.launches_decode_tc)
    got = kernels.dequant_matmul(torch.from_numpy(x).to(torch.bfloat16), leaf)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 128)
    # the CPU takes the plain version: no launch is counted
    assert (kernels.dequant_matmul.launches, kernels.dequant_matmul.launches_q4,
            kernels.dequant_matmul.launches_decode_tc) == before
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())


def decode_order(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """The decode form's order of sums, in f32: per 32-row quant block the
    exact dot of bf16 x with the integer weights, times the block's scale,
    added up quant block by quant block inside each split of
    `decode_tc_split_for`; the splits' partials then added in order
    (dq_reduce)."""
    m, k = x.shape
    nb = k // 32
    q = (leaf["q8"] if "q8" in leaf else quant.unpack_q4(leaf["q4"])).to(torch.float32)
    n = q.shape[-1]
    # integers of at most 8 bits and bf16 x: every product exact in f32
    part = torch.einsum("mbk,bkn->bmn", x.to(torch.float32).reshape(m, nb, 32),
                        q.reshape(nb, 32, n))
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
    """The reordering (scale on each block's f32 dot, K split)
    against the JAX kernel's f32 x * f32(q * s) with f32 sums, before any
    bf16 output rounding: JAX gets the bf16 x values widened to f32,
    exactly."""
    leaf, jleaf = leaves(bits, scale_dtype)
    x = bf16_values(rnd((m, 4096), 110 + m))
    want = jax_k1(x, jleaf, jnp.float32)
    got = decode_order(torch.from_numpy(x).to(torch.bfloat16), leaf).numpy()
    assert kernels.decode_tc_split_for(4096, 128)[0] > 1  # the splits are exercised
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())
