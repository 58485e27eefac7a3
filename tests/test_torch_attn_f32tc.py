"""K7's and K2's f32 forms on the tensor cores ("prefill_f32tc",
"decode_f32tc"): f32 attention as three TF32 products, against the plain
versions and the JAX kernels on the CPU.

On the card an f32 cache takes `attn_prefill_f32tc` for K7 and
`attn_decode_f32tc` for K2 (`ops/attention.py:k7_form`, `k2_form`). Both
split
each f32 operand as big + small tf32 values (`split_tf32`,
`csrc/tc_common.cuh`) and take a product as small_a big_b + big_a small_b
+ big_a big_b on mma.sync.m16n8k8; K and V come in 32-slot tiles, 8
groups of 4 slots, by TMA bulk copies; P stays in the score registers
(`c_to_a` permutes the reduction index); K7's chunks merge in
`attn_prefill_merge<HD, float>`, K2's splits in `attn_combine<float>`.
Here, without a card, the tests pin the split bit for bit (a numpy copy
held to the source's constants, with inf, NaN, zero and subnormal
inputs), the routes, form codes, C signatures, shared memory and blocks
an SM, the ldmatrix and bank layouts, the launchers on meta tensors, and a
numpy emulation of every lane of both forms (the split, the three
products, the repack, the chunks, splits and merges in order) against
the plain versions and the JAX kernels in interpret mode, in f32.
"""

import inspect
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import attention as jattention
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch.ops import _build, attention

torch.set_num_threads(1)

CSRC = pathlib.Path(attention.__file__).parents[1] / "csrc"
# of max(1, |ref|): products of the split parts are exact, the dropped
# small_a small_b and small's rounding are under 2^-20 of a product, and the
# f32 sums run in another order (the card's kernels read 1e-6 to 6e-6)
TOL = 2e-5
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for its blocks
SMEM_RESERVED = 1024  # bytes the card reserves for each resident block
LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3
CANONICAL_NAN = np.uint32(0x7FFFFFFF)  # what the card's f32 arithmetic gives for a NaN


def _src(name: str) -> str:
    return (CSRC / name).read_text()


def _const(name: str, source: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _src(source)).group(1))


def _split_consts() -> tuple[int, int]:
    body = re.search(r"Tf32Pair split_tf32\(float a\) \{(.*?)\n\}", _src("tc_common.cuh"),
                     re.S).group(1)
    mask = re.search(r"__float_as_uint\(a\) & (0x[0-9A-F]+)u;", body)
    half = re.search(r"__uint_as_float\(big\)\) \+ (0x[0-9A-F]+)u\}", body)
    return int(mask.group(1), 16), int(half.group(1), 16)


MASK, HALF = _split_consts()


# ---------------------------------------------------------------- the split

def split(a) -> tuple[np.ndarray, np.ndarray]:
    """`split_tf32` in numpy: f32 a -> the registers (big, small) as uint32.
    big is a with its low 13 bits cleared; small is a - big (exact) plus
    half of tf32's last place on its bits. A NaN difference is the card's
    canonical NaN."""
    a = np.asarray(a, np.float32)
    big = a.view(np.uint32) & np.uint32(MASK)
    with np.errstate(invalid="ignore", over="ignore"):
        r = a - big.view(np.float32)
    rb = np.where(np.isnan(r), CANONICAL_NAN, r.view(np.uint32))
    return big, (rb.astype(np.uint64) + HALF).astype(np.uint32)


def read(bits) -> np.ndarray:
    """The value the tensor core reads from a tf32 register: the low 13
    bits ignored."""
    return (np.asarray(bits, np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def rna11(r: np.ndarray) -> np.ndarray:
    """r rounded to 11 significant bits, to nearest, ties away from zero,
    by frexp (independent of the bit trick; normal r only)."""
    m, e = np.frexp(r.astype(np.float64))
    return (np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11))


def wide(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)
    return (x * (1 + rng.random(n) * 2.0 ** -9)).astype(np.float32)


def test_the_split_constants_are_tf32s():
    """The source clears the 13 bits tf32 drops and adds half of its last
    place: the numpy model reads them from there."""
    assert MASK == 0xFFFFFFFF & ~((1 << 13) - 1) and HALF == 1 << 12


def test_split_of_random_f32_is_exact_up_to_small_rounding():
    a = wide(20000, 1)
    big, small = split(a)
    assert ((big & 0x1FFF) == 0).all()
    r = a.astype(np.float64) - read(big).astype(np.float64)
    # a - big is exact in f32, and small reads it rounded to nearest, ties away
    assert (read(big).astype(np.float64) + r == a.astype(np.float64)).all()
    np.testing.assert_array_equal(read(small).astype(np.float64), rna11(r))
    err = np.abs(a.astype(np.float64) - read(big) - read(small).astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(a)).all()
    # big is a truncation: |small| under tf32's last place of a
    assert (np.abs(read(small)) <= 2.0 ** -10 * np.abs(a)).all()


def test_split_ties_round_away_from_zero():
    """a = 1 + 2^-11 + 2^-22: big = 1 (truncated), and the difference 2^-11
    (1 + 2^-11) is a tie at 11 bits, which small rounds away from zero, on
    either sign."""
    for sign in (1.0, -1.0):
        big, small = split(np.float32(sign * (1.0 + 2.0 ** -11 + 2.0 ** -22)))
        assert read(big) == np.float32(sign)
        assert read(small) == np.float32(sign * (2.0 ** -11 + 2.0 ** -21))


def test_split_near_f32s_maximum_stays_finite():
    a = np.array([np.finfo(np.float32).max, -np.finfo(np.float32).max, 3.4e38], np.float32)
    big, small = split(a)
    assert np.isfinite(read(big)).all() and np.isfinite(read(small)).all()
    err = np.abs(read(big).astype(np.float64) + read(small) - a.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(a)).all()


def test_split_of_subnormals_and_tiny_normals():
    tiny = np.finfo(np.float32).tiny
    a = np.array([tiny, -tiny * 1.75, 1e-40, -3e-42, 1.4e-45, tiny * (1 + 2.0 ** -12)],
                 np.float32)
    big, small = split(a)
    got = read(big).astype(np.float64) + read(small)
    # tf32's grid below 2^-126 is 2^-136: within half of it
    assert (np.abs(got - a.astype(np.float64)) <= 2.0 ** -137).all()


def test_split_of_zeros_infinities_and_nans():
    """An inf or NaN goes whole into big and small reads 0 (-0: the
    canonical NaN of a - big carried by the half place); a NaN whose
    payload lies only in the low 13 bits reads as inf, the only NaN the
    card's arithmetic does not give."""
    vals = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FFFFFFF, 0x7FC00000,
                     0xFFC00001, 0x7F800001], np.uint32)
    big, small = split(vals.view(np.float32))
    np.testing.assert_array_equal(big, vals & np.uint32(MASK))
    assert (read(small) == 0).all()
    assert read(big)[0] == 0 and read(big)[1] == 0
    assert np.isposinf(read(big)[2]) and np.isneginf(read(big)[3])
    assert np.isnan(read(big)[4:7]).all() and np.isposinf(read(big)[7])


def test_three_products_hold_f32_products():
    """small_a big_b + big_a small_b + big_a big_b against the f64 product:
    within 2^-19 of |a b| (the dropped small_a small_b and the two
    roundings of small), where one tf32 product is 2^-11 off."""
    a, b = wide(5000, 3), wide(5000, 4)
    (ab, as_), (bb, bs) = split(a), split(b)
    got = (read(as_).astype(np.float64) * read(bb) + read(ab).astype(np.float64) * read(bs)
           + read(ab).astype(np.float64) * read(bb))
    exact = a.astype(np.float64) * b
    assert (np.abs(got - exact) <= 2.0 ** -19 * np.abs(exact)).all()
    one = read(ab).astype(np.float64) * read(bb)
    assert (np.abs(one - exact) > 2.0 ** -16 * np.abs(exact)).any()


# ------------------------------------------------------------------ routes

def test_routes_take_the_new_forms_for_f32():
    assert attention.k7_form(torch.float32) == "prefill_f32tc"
    assert attention.k2_form(torch.float32) == "decode_f32tc"


def test_form_codes_match_both_entry_points():
    enum = re.search(r"enum Form \{ kPrefillTc = (\d), kPrefillF32Tc = (\d) \};",
                     _src("attn_prefill.cu"))
    assert tuple(map(int, enum.groups())) == tuple(map(attention.K7_FORMS.index,
                                                       ("prefill_tc", "prefill_f32tc")))
    enum = re.search(r"enum Form \{ kDecodeTc = (\d), kDecodeF32Tc = (\d) \};",
                     _src("attn_decode.cu"))
    assert tuple(map(int, enum.groups())) == tuple(map(attention.K2_FORMS.index,
                                                       ("decode_tc", "decode_f32tc")))
    assert "form == kPrefillF32Tc" in _src("attn_prefill.cu")
    assert "form == kDecodeF32Tc" in _src("attn_decode.cu")


def test_the_old_f32_forms_are_gone():
    """The FMA forms of K7 (`attn_prefill_fma`) and K2 (`attn_partial`)
    lost every cell of the mirrored pair to the new forms (PERF.md)."""
    assert "attn_prefill_fma" not in _src("attn_prefill.cu")
    assert "attn_partial" not in _src("attn_decode.cu")
    for name in ("attn_prefill.cu", "attn_decode.cu"):
        assert "launch_fma" not in _src(name)
    assert "fma" not in attention.K7_FORMS + attention.K2_FORMS
    assert not hasattr(attention, "_FMA_SB")


@pytest.mark.parametrize("b,kv,t,g,hd,s", [(1, 32, 64, 1, 128, 1024), (1, 32, 256, 1, 128, 1024),
                                           (2, 2, 70, 2, 64, 500), (4, 32, 16, 1, 128, 1024),
                                           (4, 32, 32, 1, 128, 1024), (2, 2, 32, 8, 64, 320)])
def test_plans(b, kv, t, g, hd, s):
    """K7's f32 form takes the bf16 form's chunks. K2's f32 splits are whole
    64-slot tiles (two f32 tiles each, so a ring of two stages), as many as
    give each SM a block and no more, none shorter than a tile."""
    f32 = attention.prefill_plan(torch.float32, b, kv, t, g, hd, s)
    assert f32 == ("prefill_f32tc", *attention.prefill_plan(torch.bfloat16, b, kv, t, g, hd,
                                                            s)[1:])
    if t <= attention.MAX_T:
        form, sps, n, ws = attention.k2_plan(torch.float32, b, kv, t, g, hd, s)
        assert form == "decode_f32tc" and sps % 64 == 0 and n == -(-s // sps)
        blocks = b * kv * -(-t * g // 64)
        tiles = -(-s // 64)
        assert n <= max(1, attention.H100_SMS // blocks)
        assert sps == 64 or blocks * -(-tiles // (sps // 64 - 1)) > attention.H100_SMS
        assert ws == (b * kv * n * t * g * (hd + 2) if n > 1 else 0)


def test_k2_f32_plan_at_7b():
    """b = 4 or 8 slots, KV = 32: one split a (batch, kv head), no merge
    pass (the fastest at the serving fill on the card); one slot: four."""
    for b in (4, 8):
        for t in (1, 16, 32):
            assert attention.k2_plan(torch.float32, b, 32, t, 1, 128, 1024) == (
                "decode_f32tc", 1024, 1, 0)
    assert attention.k2_plan(torch.float32, 1, 32, 1, 1, 128, 1024)[1:3] == (256, 4)


class _FakeEntry:
    def __init__(self):
        self.calls = []

    def __call__(self, q, k, v, pos0, out, ws, b, t, kv, g, hd, s, scale, form, cps, chunks,
                 stream):
        self.calls.append(dict(ws=ws is not None, form=form, cps=cps, chunks=chunks))
        return 0


@pytest.mark.parametrize("which,t,b", [("k7", 64, 2), ("k7", 256, 2), ("k2", 16, 2),
                                       ("k2", 32, 2), ("k2", 1, 2), ("k2", 1, 4)])
def test_launchers_hand_the_f32_plans_to_the_entry_points(monkeypatch, which, t, b):
    """The launchers on meta tensors (data pointers 0, never read): the form
    code, plan and workspace each hands its entry point for an f32 cache,
    and the form it reports."""
    entry = _FakeEntry()
    monkeypatch.setattr(attention, "_prefill_lib" if which == "k7" else "_lib", lambda: entry)
    monkeypatch.setattr(attention, "_stream", lambda x: 0)
    kv, g, hd, s = 32, 1, 128, 1024
    meta = torch.device("meta")
    q5 = torch.empty((b, t, kv, g, hd), dtype=torch.float32, device=meta)
    kc = torch.empty((b, kv, s, hd), dtype=torch.float32, device=meta)
    pos0 = torch.empty((b,), dtype=torch.int32, device=meta)
    if which == "k7":
        form, cps, chunks, ws = attention.prefill_plan(torch.float32, b, kv, t, g, hd, s)
        out, got = attention._flash_attention_prefill_cuda(q5, kc, kc, pos0)
        code = attention.K7_FORMS.index(form)
    else:
        form, cps, chunks, ws = attention.k2_plan(torch.float32, b, kv, t, g, hd, s)
        out, got = attention._flash_attention_cuda(q5, kc, kc, pos0)
        code = attention.K2_FORMS.index(form)
    assert got == form and out.dtype == torch.float32 and out.shape == q5.shape
    assert entry.calls == [dict(ws=ws > 0, form=code, cps=cps, chunks=chunks)]
    assert form == ("prefill_f32tc" if which == "k7" else "decode_f32tc")
    assert (ws > 0) == (chunks > 1)


def test_flash_attention_counts_the_f32_forms():
    src = inspect.getsource(attention.flash_attention)
    assert "flash_attention.launches_decode_f32tc += 1" in src
    assert "flash_attention.launches_prefill_f32tc += 1" in src


# ----------------------------------------------- shared memory, blocks, banks

def _f32_stage(hd: int) -> int:
    return 2 * 8 * (4 * hd + 4) * 4


def test_the_layout_constants_are_the_sources():
    assert (_const("kF32Tile", "tc_common.cuh"), _const("kF32Group", "tc_common.cuh"),
            _const("kF32Pad", "tc_common.cuh")) == (32, 4, 4)
    assert _const("kF32Stages", "attn_prefill.cu") == 2
    assert _const("kF32Stages", "attn_decode.cu") == 2
    assert "__launch_bounds__(kTcThreads, 2) attn_prefill_f32tc(" in _src("attn_prefill.cu")
    assert "__launch_bounds__(kTcThreads, WS == 4 ? 3 : 2) attn_decode_f32tc(" in \
        _src("attn_decode.cu")


@pytest.mark.parametrize("hd", [64, 128])
def test_k7_f32_two_blocks_an_sm_fit(hd):
    """A ring of two 32-slot stages, the q-tile's 64 rows (16 bytes of
    padding a row) and two mbarriers: two blocks an SM (three stages, or
    64-slot tiles, would leave one at hd = 128)."""
    smem = 2 * _f32_stage(hd) + 64 * (hd + 4) * 4 + 2 * 8
    assert 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    assert 2 * (3 * _f32_stage(128) + 64 * 132 * 4 + 24 + SMEM_RESERVED) > SMEM_PER_SM


@pytest.mark.parametrize("hd,rows,blocks", [(128, 1, 2), (128, 16, 2), (128, 32, 2),
                                            (128, 64, 1), (64, 1, 5), (64, 64, 3)])
def test_k2_f32_blocks_an_sm(hd, rows, blocks):
    """K2's f32 form: a ring of two stages (every split holds two f32 tiles),
    q's big and small planes of the group's m16 tiles: the blocks an SM's
    shared memory holds (a group of four m16 tiles at hd = 128, t * g = 64
    in GQA models, one); the merge of the warps' parts fits the ring."""
    q_rows = (min(rows, 64) + 15) // 16 * 16
    smem = 2 * _f32_stage(hd) + 2 * q_rows * (hd + 4) * 4 + 2 * 8
    assert SMEM_PER_SM // (smem + SMEM_RESERVED) == blocks
    merge = 4 * (hd // 8) * 4 * 32 * 4 + 4 * 4 * 32 * 4
    assert merge <= 2 * _f32_stage(hd)


def test_fragment_reads_fall_on_distinct_banks():
    """K's B fragments (slot 4 gid + n: group gid, row n; words tig and tig +
    4), the permuted V reads (slots 4 (2 tig) + ks and 4 (2 tig + 1) + ks,
    word gid) and q's A fragments (rows gid | gid + 8, words tig | tig + 4)
    each touch 32 distinct banks; every slot of a tile is one column of one
    n-tile."""
    for hd in (64, 128):
        gld, qld = 4 * hd + 4, hd + 4
        for n in range(4):
            for d in (0, 4):
                assert len(set((GID * gld + n * hd + d + TIG) % 32)) == 32
        for ks in range(4):
            for extra in (0, gld):
                assert len(set((2 * TIG * gld + extra + ks * hd + GID) % 32)) == 32
        for rows in (GID, GID + 8):
            for d in (0, 4):
                assert len(set((rows * qld + d + TIG) % 32)) == 32
    assert sorted(4 * c + n for n in range(4) for c in range(8)) == list(range(32))


def _ldmatrix(flat, addrs, n):
    """ldmatrix (b16) on words: lanes 8i..8i+7 give the row addresses (in
    words) of matrix i < n; lane l receives word l % 4 of row l / 4."""
    return [flat[addrs[8 * i + GID] + TIG] for i in range(n)]


def test_ldmatrix_brings_the_fragments():
    """The lane addresses the kernels hand ldmatrix give the words the
    fragment layouts name: K's b0, b1 of two n-tiles (x4) or one (x2), q's
    a0..a3."""
    for hd in (64, 128):
        gld, qld = 4 * hd + 4, hd + 4
        tile = np.arange(8 * gld, dtype=np.int64)
        for n0 in (0, 2):
            for kk in (0, 3):
                krow = (LANE & 7) * gld + ((LANE >> 3) & 1) * 4 + ((LANE >> 4) & 1) * hd
                got = _ldmatrix(tile, krow + (n0 * hd) + kk * 8, 4)
                for j, (n, d) in enumerate(((n0, 0), (n0, 4), (n0 + 1, 0), (n0 + 1, 4))):
                    np.testing.assert_array_equal(got[j], GID * gld + n * hd + kk * 8 + d + TIG)
                krow1 = (LANE & 7) * gld + ((LANE >> 3) & 1) * 4
                got = _ldmatrix(tile, krow1 + n0 * hd + kk * 8, 2)
                for j, d in enumerate((0, 4)):
                    np.testing.assert_array_equal(got[j], GID * gld + n0 * hd + kk * 8 + d + TIG)
        qs = np.arange(64 * qld, dtype=np.int64)
        for w in range(4):
            qa = (w * 16 + (LANE & 7) + ((LANE >> 3) & 1) * 8) * qld + ((LANE >> 4) & 1) * 4
            got = _ldmatrix(qs, qa + 5 * 8, 4)
            for j, (r, d) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
                np.testing.assert_array_equal(got[j], (w * 16 + GID + r) * qld + 40 + d + TIG)
    src = _src("tc_common.cuh")
    assert "(lane & 7) * f32_gld<HD>() + ((lane >> 3) & 1) * 4 +" in src
    assert "(NT > 1 ? ((lane >> 4) & 1) * HD : 0) + n0 * HD" in src
    for name in ("attn_prefill.cu", "attn_decode.cu"):
        assert "(lane & 7) + ((lane >> 3) & 1) * 8) * QLD" in _src(name)


def test_both_forms_share_the_3xtf32_helpers():
    for name in ("attn_prefill", "attn_decode"):
        assert _build.source_files(name) == [f"{name}.cu", "tc_common.cuh"]
        src = _src(f"{name}.cu")
        assert "qk_f32tc<HD," in src and "pv_f32tc<HD," in src
        assert "Tf32Pair split_tf32(" not in src  # the split lives once
    assert len(re.findall(r"__device__ __forceinline__ Tf32Pair split_tf32\(",
                          _src("tc_common.cuh"))) == 1


# ----------------------------------------------------- the lanes, emulated

def _mma(c, a, b0, b1):
    """mma.m16n8k8 on tf32 over one warp: A [16, 8] from a[0..3] (rows gid |
    gid + 8 | gid | gid + 8, k tig | tig | tig + 4 | tig + 4), B [8, 8] from
    b0, b1 (k tig | tig + 4, n gid), as the tensor core reads them; c (lanes
    x 4) += A B, every product exact, one f32 rounding."""
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    with np.errstate(invalid="ignore", over="ignore"):
        for reg, (row, k) in enumerate(((GID, TIG), (GID + 8, TIG), (GID, TIG + 4),
                                        (GID + 8, TIG + 4))):
            A[row, k] = read(a[reg])
        B[TIG, GID], B[TIG + 4, GID] = read(b0), read(b1)
        C = A @ B
        return (c.astype(np.float64) + np.stack(
            [C[GID, 2 * TIG], C[GID, 2 * TIG + 1], C[GID + 8, 2 * TIG], C[GID + 8, 2 * TIG + 1]],
            axis=1)).astype(np.float32)


def _qk(s, qfrag, stage, n0, nt, hd):
    """qk_f32tc: s [nt, 32, 4] += Q K^T over n-tiles n0 .. of the K tile in
    `stage` (flat f32), three products, separate accumulators under four
    n-tiles."""
    gld = 4 * hd + 4
    p_acc = 3 if nt == 1 else 2 if nt == 2 else 1
    acc = np.zeros((p_acc, nt, 32, 4), np.float32)
    for kk in range(hd // 8):
        ab, as_ = qfrag(kk)
        bb, bs = [], []
        for n in range(nt):
            base = GID * gld + (n0 + n) * hd + kk * 8 + TIG
            x, y = split(stage[base]), split(stage[base + 4])
            bb.append((x[0], y[0]))
            bs.append((x[1], y[1]))
        for n in range(nt):
            acc[0, n] = _mma(acc[0, n], as_, *bb[n])
        for n in range(nt):
            acc[1 if p_acc == 3 else 0, n] = _mma(acc[1 if p_acc == 3 else 0, n], ab, *bs[n])
        for n in range(nt):
            acc[p_acc - 1, n] = _mma(acc[p_acc - 1, n], ab, *bb[n])
    tot = acc[0]
    for p in range(1, p_acc):
        tot = (tot + acc[p]).astype(np.float32)
    return (s + tot).astype(np.float32)


def _pv(o, p, stage, ks0, nt, hd):
    """pv_f32tc: o [hd / 8, 32, 4] += P V over k-steps ks0 .. (P from the
    score fragments p [nt, 32, 4] by c_to_a: a0 = c0, a1 = c2, a2 = c1, a3 =
    c3; V's b0 from slot 4 (2 tig) + ks, b1 from 4 (2 tig + 1) + ks)."""
    gld = 4 * hd + 4
    half = 8 * gld
    for ks in range(nt):
        ab, as_ = zip(*(split(p[ks][:, i]) for i in (0, 2, 1, 3)))
        for n in range(hd // 8):
            base = half + 2 * TIG * gld + GID + (ks0 + ks) * hd + n * 8
            x, y = split(stage[base]), split(stage[base + gld])
            o[n] = _mma(o[n], as_, x[0], y[0])
            o[n] = _mma(o[n], ab, x[1], y[1])
            o[n] = _mma(o[n], ab, x[0], y[0])
    return o


def _quad(v, op):
    v = op(v, v[LANE ^ 1])
    return op(v, v[LANE ^ 2])


def _load(ring_stage, kb, vb, j0, n, hd):
    """Tile of n visible slots from j0 into a stage: thread G < 8 copies K's
    group G of 4 slots, 8 + G V's (one bulk copy each); V rows past n
    zeroed; what no copy writes keeps its stale bits (NaN here)."""
    gld = 4 * hd + 4
    half = 8 * gld
    copied = 0
    for tid in range(16):
        grp, is_v = tid % 8, tid >= 8
        cnt = min(4, n - 4 * grp)
        if cnt > 0:
            dst = (half if is_v else 0) + grp * gld
            ring_stage[dst:dst + cnt * hd] = (vb if is_v else kb)[j0 + 4 * grp:
                                                                  j0 + 4 * grp + cnt].ravel()
            copied += cnt * hd * 4
    assert copied == 2 * n * hd * 4  # the mbarrier's expected bytes
    for r in range(n, 32):
        off = half + (r // 4) * gld + (r % 4) * hd
        ring_stage[off:off + hd] = 0.0


def _f32(x):
    return np.float32(x)


def _k7_block(qb, kb, vb, p0, g, r0, j_begin, j_end, scale2):
    """One attn_prefill_f32tc block: q-tile rows r0 .. r0 + 63 of qb [R, hd]
    over slots [j_begin, j_end). Returns {row: (unnormalized P V, max in log2
    units, sum)}."""
    R, hd = qb.shape
    qld, gld, stages = hd + 4, 4 * hd + 4, 2
    ring = [np.full(16 * gld, np.nan, np.float32) for _ in range(stages)]
    n_it = -(-(j_end - j_begin) // 32)
    for i in range(min(stages, n_it)):
        _load(ring[i], kb, vb, j_begin + 32 * i, min(32, j_end - j_begin - 32 * i), hd)
    qs = np.zeros(64 * qld, np.float32)
    for r in range(min(64, R - r0)):
        qs[r * qld:r * qld + hd] = qb[r0 + r]
    warps = []
    for w in range(4):
        rows = r0 + 16 * w + GID
        base = (16 * w + GID) * qld + TIG

        def qfrag(kk, base=base):
            return split(np.stack([qs[base + kk * 8], qs[base + 8 * qld + kk * 8],
                                   qs[base + kk * 8 + 4], qs[base + 8 * qld + kk * 8 + 4]]))

        warps.append(dict(qfrag=qfrag, active=16 * w < R - r0, rows=rows,
                          qp=(p0 + rows // g, p0 + (rows + 8) // g),
                          qp_first=p0 + (r0 + 16 * w) // g,
                          m=np.full((32, 2), -np.inf, np.float32),
                          l=np.zeros((32, 2), np.float32),
                          o=np.zeros((hd // 8, 32, 4), np.float32)))
    for it in range(n_it):
        stage = ring[it % stages]
        j0 = j_begin + 32 * it
        for w in (w for w in warps if w["active"]):
            s = _qk(np.zeros((4, 32, 4), np.float32), w["qfrag"], stage, 0, 4, hd)
            full = j0 + 32 <= j_end and j0 + 31 <= w["qp_first"]
            mx = np.full((32, 2), -np.inf, np.float32)
            for n in range(4):
                for e in range(4):
                    h, col = e >> 1, 2 * TIG + (e & 1)
                    slot = j0 + 4 * col + n
                    with np.errstate(invalid="ignore", over="ignore"):
                        v = (s[n][:, e] * scale2).astype(np.float32)
                    keep = True if full else (slot < j_end) & (slot <= w["qp"][h])
                    s[n][:, e] = np.where(keep, v, -np.inf)
                    mx[:, h] = np.fmax(mx[:, h], s[n][:, e])
            mx = _quad(mx, np.maximum)
            mn = np.maximum(w["m"], mx)
            ms = np.where(mn == -np.inf, _f32(0), mn).astype(np.float32)
            a = np.exp2(w["m"] - ms).astype(np.float32)
            w["m"] = mn
            w["l"] = (w["l"] * a).astype(np.float32)
            w["o"] = (w["o"] * a[None][:, :, [0, 0, 1, 1]]).astype(np.float32)
            for n in range(4):
                s[n] = np.exp2(s[n] - ms[:, [0, 0, 1, 1]]).astype(np.float32)
                w["l"][:, 0] = (w["l"][:, 0] + (s[n][:, 0] + s[n][:, 1])).astype(np.float32)
                w["l"][:, 1] = (w["l"][:, 1] + (s[n][:, 2] + s[n][:, 3])).astype(np.float32)
            w["o"] = _pv(w["o"], s, stage, 0, 4, hd)
        if it + stages < n_it:  # after the block barrier
            _load(ring[it % stages], kb, vb, j0 + 32 * stages,
                  min(32, j_end - j0 - 32 * stages), hd)
    out = {}
    for w in (w for w in warps if w["active"]):
        l_sum = _quad(w["l"], lambda x, y: (x + y).astype(np.float32))
        for h in range(2):
            for lane in range(32):
                row = w["rows"][lane] + 8 * h
                if row >= R:
                    continue
                pv = out.setdefault(row, [np.zeros(hd, np.float32), 0.0, 0.0])
                for n in range(hd // 8):
                    pv[0][n * 8 + 2 * TIG[lane]:n * 8 + 2 * TIG[lane] + 2] = \
                        w["o"][n][lane, 2 * h:2 * h + 2]
                pv[1], pv[2] = w["m"][lane, h], l_sum[lane, h]
    return out


def emulate_k7(q5, kc, vc, pos0, cps, chunks):
    """attn_prefill_f32tc and attn_prefill_merge<HD, float> on numpy f32:
    q5 [B, t, KV, g, hd], caches [B, KV, S, hd], pos0 [B]."""
    b_, t, kv, g, hd = q5.shape
    s = kc.shape[2]
    R = t * g
    scale2 = _f32(_f32(1.0 / hd ** 0.5) * np.float32(1.4426950408889634))
    out = np.full(q5.shape, np.nan, np.float32)
    for b in range(b_):
        p0 = int(pos0[b])
        for h in range(kv):
            qb = q5[b, :, h].reshape(R, hd)
            parts = {}
            for r0 in range(0, R, 64):
                vis = min(s, max(0, p0 + (r0 + min(64, R - r0) - 1) // g + 1))
                for c in range(chunks):
                    j_begin = c * cps
                    if j_begin >= vis and chunks > 1:
                        continue
                    j_end = max(j_begin, min(j_begin + cps, vis))
                    for row, part in _k7_block(qb, kc[b, h], vc[b, h], p0, g, r0, j_begin,
                                               j_end, scale2).items():
                        parts[(row, c)] = part
            for row in range(R):
                if chunks == 1:
                    pv, _, l = parts[(row, 0)]
                    with np.errstate(invalid="ignore", divide="ignore"):
                        v = (pv / np.float32(l)).astype(np.float32)
                else:
                    qp = p0 + row // g
                    if qp < 0:
                        v = np.full(hd, np.nan, np.float32)
                    else:
                        mx, den, num = _f32(-np.inf), _f32(0), np.zeros(hd, np.float32)
                        for c in range(min(qp // cps, chunks - 1) + 1):
                            pv, m, l = parts[(row, c)]
                            mn = max(mx, _f32(m))
                            a, w = np.exp2(_f32(mx - mn)), np.exp2(_f32(m - mn))
                            mx = mn
                            den = _f32(np.float64(den) * a + np.float64(w) * _f32(l))
                            num = (num.astype(np.float64) * a
                                   + np.float64(w) * pv.astype(np.float64)).astype(np.float32)
                        v = (num / den).astype(np.float32)
                out[b, row // g, h, row % g] = v
    return out


MASK_K2 = np.float32(-1e9)


def _k2_block(qb, kb, vb, p0, g, r0, rows, j_begin, j_end, scale):
    """One attn_decode_f32tc block: the group's rows r0 .. r0 + rows - 1 over
    the split's slots [j_begin, j_end). Returns (P V [rows, hd], max, sum)
    after the merge of the warps' parts."""
    R, hd = qb.shape
    mtiles = (min(R, 64) + 15) // 16
    ws_ = 4 if mtiles == 1 else 2 if mtiles == 2 else 1
    nt = 4 // ws_
    gld, qld = 4 * hd + 4, hd + 4
    q_rows = (min(R, 64) + 15) // 16 * 16
    qpad = np.zeros((q_rows, hd), np.float32)
    qpad[:rows] = qb[r0:r0 + rows]
    qbig, qsmall = (np.concatenate([x, np.zeros((q_rows, 4), np.uint32)], 1).ravel()
                    for x in split(qpad))
    ring_n = 2
    ring = [np.full(16 * gld, np.nan, np.float32) for _ in range(ring_n)]
    n_it = -(-(j_end - j_begin) // 32)
    for i in range(min(ring_n, n_it)):
        _load(ring[i], kb, vb, j_begin + 32 * i, min(32, j_end - j_begin - 32 * i), hd)
    warps = []
    for warp in range(4):
        mt, part = divmod(warp, ws_)
        base = (mt * 16 + GID) * qld + TIG

        def qfrag(kk, base=base):
            idx = [base + kk * 8, base + 8 * qld + kk * 8, base + kk * 8 + 4,
                   base + 8 * qld + kk * 8 + 4]
            return [qbig[i] for i in idx], [qsmall[i] for i in idx]

        row_lo = r0 + mt * 16 + GID
        warps.append(dict(mt=mt, part=part, active=mt * 16 < rows, qfrag=qfrag, row_lo=row_lo,
                          qp=(p0 + row_lo // g, p0 + (row_lo + 8) // g),
                          m=np.full((32, 2), MASK_K2, np.float32),
                          l=np.zeros((32, 2), np.float32),
                          o=np.zeros((hd // 8, 32, 4), np.float32)))
    for it in range(n_it):
        stage = ring[it % ring_n]
        j0 = j_begin + 32 * it
        for w in (w for w in warps if w["active"]):
            s = _qk(np.zeros((nt, 32, 4), np.float32), w["qfrag"], stage, w["part"] * nt, nt, hd)
            mx = np.full((32, 2), MASK_K2, np.float32)
            for n in range(nt):
                for e in range(4):
                    h, col = e >> 1, 2 * TIG + (e & 1)
                    slot = j0 + 4 * col + w["part"] * nt + n
                    with np.errstate(invalid="ignore", over="ignore"):
                        v = (s[n][:, e] * scale).astype(np.float32)
                    s[n][:, e] = np.where((slot < j_end) & (slot <= w["qp"][h]), v, MASK_K2)
                    mx[:, h] = np.fmax(mx[:, h], s[n][:, e])
            mx = _quad(mx, np.maximum)
            mn = np.maximum(w["m"], mx)
            a = np.exp(w["m"] - mn).astype(np.float32)
            w["m"] = mn
            w["l"] = (w["l"] * a).astype(np.float32)
            w["o"] = (w["o"] * a[None][:, :, [0, 0, 1, 1]]).astype(np.float32)
            for n in range(nt):
                s[n] = np.exp(s[n] - mn[:, [0, 0, 1, 1]]).astype(np.float32)
                w["l"][:, 0] = (w["l"][:, 0] + (s[n][:, 0] + s[n][:, 1])).astype(np.float32)
                w["l"][:, 1] = (w["l"][:, 1] + (s[n][:, 2] + s[n][:, 3])).astype(np.float32)
            w["o"] = _pv(w["o"], s, stage, w["part"] * nt, nt, hd)
        if it + ring_n < n_it:
            _load(ring[it % ring_n], kb, vb, j0 + 32 * ring_n,
                  min(32, j_end - j0 - 32 * ring_n), hd)
    for w in warps:
        w["l"] = _quad(w["l"], lambda x, y: (x + y).astype(np.float32))
    num = np.zeros((rows, hd), np.float32)
    mxo = np.zeros(rows, np.float32)
    den = np.zeros(rows, np.float32)
    for w in (w for w in warps if w["active"] and w["part"] == 0):
        m, l, o = w["m"].copy(), w["l"].copy(), w["o"].copy()
        for pp in range(1, ws_):  # the parts in order
            w2 = warps[w["mt"] * ws_ + pp]
            mn = np.maximum(m, w2["m"])
            a, b2 = np.exp(m - mn).astype(np.float32), np.exp(w2["m"] - mn).astype(np.float32)
            l = (l * a + w2["l"] * b2).astype(np.float32)
            o = (o * a[None][:, :, [0, 0, 1, 1]]
                 + w2["o"] * b2[None][:, :, [0, 0, 1, 1]]).astype(np.float32)
            m = mn
        for h in range(2):
            r = w["mt"] * 16 + GID + 8 * h
            ok = r < rows
            for n in range(hd // 8):
                for e in range(2):
                    num[r[ok], n * 8 + 2 * TIG[ok] + e] = o[n][ok, 2 * h + e]
            mxo[r[ok]], den[r[ok]] = m[ok, h], l[ok, h]
    return num, mxo, den


def emulate_k2(q5, kc, vc, pos0, sps, n_split):
    """attn_decode_f32tc and attn_combine<float> on numpy f32; the workspace
    starts as NaN, so a merge that reads a partial no split wrote gives
    NaN."""
    B, t, KV, g, hd = q5.shape
    S = kc.shape[2]
    R = t * g
    scale = np.float32(1.0 / np.sqrt(hd))
    qr = q5.transpose(0, 2, 1, 3, 4).reshape(B, KV, R, hd)
    out = np.full((B, KV, R, hd), np.nan, np.float32)
    for b, kvh in np.ndindex(B, KV):
        p0 = int(pos0[b])
        ws_o = np.full((n_split, R, hd), np.nan, np.float32)
        ws_m = np.full((n_split, R), np.nan, np.float32)
        ws_l = np.full((n_split, R), np.nan, np.float32)
        for r0 in range(0, R, 64):
            rows = min(64, R - r0)
            vis = min(S, p0 + (r0 + rows - 1) // g + 1)
            for sp in range(n_split):
                j_begin = sp * sps
                if j_begin >= vis:
                    continue
                o, m, l = _k2_block(qr[b, kvh], kc[b, kvh], vc[b, kvh], p0, g, r0, rows,
                                    j_begin, min(j_begin + sps, vis), scale)
                if n_split == 1:
                    out[b, kvh, r0:r0 + rows] = (o / l[:, None]).astype(np.float32)
                else:
                    ws_o[sp, r0:r0 + rows], ws_m[sp, r0:r0 + rows] = o, m
                    ws_l[sp, r0:r0 + rows] = l
        if n_split == 1:
            continue
        for r in range(R):  # attn_combine: splits in order
            last = min((p0 + r // g) // sps, n_split - 1)
            mx = np.max(np.append(ws_m[:last + 1, r], MASK_K2))
            num = np.zeros(hd, np.float32)
            den = np.float32(0)
            for sp in range(last + 1):
                w = np.exp(ws_m[sp, r] - mx).astype(np.float32)
                num = (np.float64(w) * ws_o[sp, r] + num).astype(np.float32)
                den = np.float32(np.float64(w) * ws_l[sp, r] + den)
            out[b, kvh, r] = num / den
    return out.reshape(B, KV, t, g, hd).transpose(0, 2, 1, 3, 4)


def _inputs(b, kv, g, hd, s, t, seed):
    rng = np.random.default_rng(seed)
    q5 = rng.standard_normal((b, t, kv, g, hd)).astype(np.float32)
    kc = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    vc = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    return q5, kc, vc


def _rel_err(got, ref):
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    return (np.abs(got - ref)[~nan] / np.maximum(1.0, np.abs(ref[~nan]))).max()


def _interpret(fn, *args):
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    try:
        return fn(*args)
    finally:
        jkernels.FORCE_INTERPRET = old


K7_CASES = [  # (b, kv, g, hd, S, t, pos0): ragged t, GQA, hd 64 and 128, rows
    # that see nothing, a window ending at S, t = 1, 16, 64 and 256
    (2, 2, 2, 64, 200, 70, [0, 130]),
    (1, 2, 4, 64, 130, 50, [-20]),
    (1, 1, 1, 128, 300, 100, [200]),
    (1, 1, 1, 64, 256, 256, [0]),
    (2, 1, 4, 128, 96, 16, [7, 80]),
    (1, 1, 1, 64, 64, 1, [63]),
    (1, 1, 1, 128, 160, 64, [96]),
]


@pytest.mark.parametrize("chunked", [False, True], ids=["plan", "chunks_of_64"])
@pytest.mark.parametrize("case", K7_CASES, ids=[f"case{i}" for i in range(len(K7_CASES))])
def test_k7_lane_emulation_matches_plain_and_jax(case, chunked):
    """attn_prefill_f32tc's lanes (copies, the split, three products, the
    repack, masks, exp2), the chunks and the merge in order, against
    `flash_attention_prefill_plain` and the JAX kernel in interpret mode,
    in f32, within TOL of max(1, |ref|); rows that see nothing give NaN."""
    b, kv, g, hd, s, t, pos0 = case
    q5, kc, vc = _inputs(b, kv, g, hd, s, t, seed=11 * t + hd)
    p0 = np.asarray(pos0, np.int32)
    _, cps, chunks, _ = attention.prefill_plan(torch.float32, b, kv, t, g, hd, s)
    if chunked:
        cps, chunks = 64, -(-s // 64)
    got = emulate_k7(q5, kc, vc, p0, cps, chunks)
    tt = [torch.from_numpy(a) for a in (q5, kc, vc)]
    plain = attention.flash_attention_prefill_plain(*tt, torch.from_numpy(p0)).numpy()
    assert _rel_err(got, plain) <= TOL
    jout = _interpret(jattention._flash_attention, *(jnp.asarray(a) for a in (q5, kc, vc)),
                      jnp.asarray(p0), 1.0 / hd ** 0.5)
    assert _rel_err(got, np.asarray(jout, np.float32)) <= TOL
    if min(pos0) < 0:
        assert np.isnan(got).any()


K2_CASES = [  # (t, g, hd, fills): t 1, 16, 32; g 1 and 4; hd 64 and 128; fills on and
    # off the 64-slot splits, S = 320 no multiple of a two-tile split
    (1, 4, 64, (1, 64, 65)),
    (16, 1, 128, (16, 101, 320)),
    (16, 4, 64, (17, 128, 129)),
    (32, 1, 64, (32, 200, 320)),
    (32, 4, 128, (40, 300)),
    (7, 4, 64, (7, 150)),
]


@pytest.mark.parametrize("case", K2_CASES, ids=[f"case{i}" for i in range(len(K2_CASES))])
def test_k2_lane_emulation_matches_plain_and_jax(case):
    """attn_decode_f32tc's lanes (q's planes, the warps' parts of the slots,
    three products, the repack, the -1e9 mask, expf, the merge of the parts
    in order) and attn_combine over the splits, under the plan's split and
    a split of one 64-slot tile, against `flash_attention_plain` and the JAX
    kernel in interpret mode, in f32, within TOL."""
    t, g, hd, fills = case
    s = 320
    rng = np.random.default_rng(t * 100 + g * 10 + hd)
    b = len(fills)
    q = rng.standard_normal((b, t, g, hd)).astype(np.float32)  # KV = 1
    kc = rng.standard_normal((b, 1, s, hd)).astype(np.float32)
    vc = rng.standard_normal((b, 1, s, hd)).astype(np.float32)
    pos0 = np.array([max(f - t, 0) for f in fills], np.int32)
    q5 = q.reshape(b, t, 1, g, hd)
    plain = attention.flash_attention_plain(*(torch.from_numpy(a) for a in (q5, kc, vc)),
                                            torch.from_numpy(pos0)).numpy()
    positions = jnp.asarray(pos0[:, None] + np.arange(t, dtype=np.int32)[None])

    def jax_k2():
        assert jattention.can_fuse_attention(jnp.asarray(q), jnp.asarray(kc))
        return jattention.flash_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                          positions)

    jout = np.asarray(_interpret(jax_k2), np.float32).reshape(q5.shape)
    plan = attention.decode_attn_plan(b, 1, t, g, hd, s, torch.float32)[:2]
    for sps, n_split in {plan, (64, 5)}:
        got = emulate_k2(q5, kc, vc, pos0, sps, n_split)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, plain, rtol=0, atol=TOL, err_msg=str(sps))
        np.testing.assert_allclose(got, jout, rtol=0, atol=TOL, err_msg=str(sps))
