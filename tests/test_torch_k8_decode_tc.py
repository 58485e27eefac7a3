"""K8's tensor-core form (bf16 q over the int8 cache): its route, its plan,
the arguments its launcher hands the C entry point, its shared memory, and
a numpy emulation of its lanes, against the plain version and the JAX
kernel in interpret mode.

On the card K8 with bf16 q takes `widening_tc` (`ops/attention.py:k8_form`,
`csrc/attn_decode_quant.cu`) when whole 64-slot tiles cover S: one block of
four warps per (batch, kv head, group of up to 64 query rows, split of
`k8_split` slots), the split's K and V tiles copied by the TMA unit in
groups of 8 rows with their scales, the int8 values widened to exact bf16
pairs in registers, both products on bf16 mma.sync.m16n8k16, p * sv
rounded to bf16 before P V, and the splits' partials merged in order by a
second launch (`quant_merge`). Here, without a card, the wrapper takes the
plain version; the tests pin the routing rule (f32 q and S without whole
tiles keep the CUDA-core form), the split plan, the form code and the one
workspace the launcher hands the entry point, the shared memory of the
blocks an SM is to hold, and an emulation of what each lane reads, widens,
multiplies, masks, rounds and merges, with stale shared memory, NaN in the
scale planes past the fill and NaN in the workspace, held against
`flash_attention_quant_plain` and the JAX kernel in interpret mode.
"""

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
# absolute, as chip_smoke's K4_TOL: bf16 outputs of size ~1 (one rounding),
# p * sv rounded to bf16 against the split's running maximum where the plain
# version rounds it against the S-block's, and f32 sums in another order
K8_TOL = 1e-2
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for its blocks
SMEM_RESERVED = 1024  # bytes the card reserves for each resident block
MASK = np.float32(-1e9)


def _src() -> str:
    return (CSRC / "attn_decode_quant.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _src()).group(1))


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("s", [64, 256, 320, 512, 1024, 4096])
def test_bf16_q_takes_the_tensor_cores_where_whole_tiles_cover_s(s):
    assert attention.k8_form(torch.bfloat16, s) == "widening_tc"
    assert attention.k8_form(torch.float32, s) == "widening"


@pytest.mark.parametrize("s", [520, 2000, 96, 40])
def test_s_without_whole_tiles_keeps_the_cuda_core_form(s):
    assert attention.k8_form(torch.bfloat16, s) == "widening"
    sb = attention._tpu_sb(s)
    assert attention.quant_plan(False, 2, 4, 1, 2, 64, s, torch.bfloat16) == (
        "widening", sb, s // sb, 2 * 4 * (s // sb) * 2 * 66)


@pytest.mark.parametrize("t,g", [(1, 1), (1, 4), (1, 8), (2, 4), (4, 2), (16, 1), (8, 4),
                                 (32, 1), (16, 8), (32, 8)])
@pytest.mark.parametrize("s", [64, 256, 512, 1024])
def test_split_plan(t, g, s):
    """Whole 64-slot tiles, at most S; four tiles where S allows, more only
    to keep at least 8 slots a row (the partials within a quarter of the
    int8 cache bytes they stand for): four tiles up to 32 rows."""
    sps = attention.k8_split(t, g, s)
    rows = t * g
    assert sps % 64 == 0 and 64 <= sps <= s
    assert sps >= min(s, 256) and sps >= min(s, 8 * rows)
    assert sps == min(s, 256) or sps - 64 < 8 * rows
    if rows <= 32:
        assert sps == min(s, 256)
    b, kv, hd = 2, 3, 128
    nsb = -(-s // sps)
    assert attention.quant_plan(False, b, kv, t, g, hd, s, torch.bfloat16) == (
        "widening_tc", sps, nsb, b * kv * nsb * rows * (hd + 2))
    # f32 q: the CUDA-core form on the TPU kernels' S-blocks; K4 unchanged
    sb = attention._tpu_sb(s)
    assert attention.quant_plan(False, b, kv, t, g, hd, s, torch.float32)[:3] == (
        "widening", sb, s // sb)
    assert attention.quant_plan(True, b, kv, t, g, hd, s, torch.bfloat16)[0] == \
        attention.k4_form(s)


def test_the_7b_shapes():
    """b = 8, KV = 32, S = 1024: four tiles a split (4 splits) at a decode
    step and at t = 32."""
    assert attention.quant_plan(False, 8, 32, 1, 1, 128, 1024, torch.bfloat16)[:3] == (
        "widening_tc", 256, 4)
    assert attention.quant_plan(False, 8, 32, 32, 1, 128, 1024, torch.bfloat16)[:3] == (
        "widening_tc", 256, 4)


def test_form_code_and_the_entry_points_rules():
    enum = re.search(r"enum Form \{[^}]*kWideningTc = (\d) \};", _src())
    assert enum is not None
    assert int(enum.group(1)) == attention.QUANT_FORMS.index("widening_tc") == 3
    # bf16 q only, S a multiple of 64, splits of whole tiles (not dividing S)
    assert "(form == kWideningTc && (!is_bf16 || S % kTile))" in _src()
    assert "(form != kWideningTc && S % SB)" in _src()
    assert "(tc && (SB % kTile || (hd != 64 && hd != 128)))" in _src()
    assert _const("kTile") == attention._K4_TILE


def test_k8_builds_from_its_one_source_and_the_shared_header():
    assert _build.source_files("attn_decode_quant") == ["attn_decode_quant.cu",
                                                        "tc_common.cuh"]
    pattern = re.compile(r"__device__ __forceinline__ void mma_bf16\(")
    assert len(pattern.findall((CSRC / "tc_common.cuh").read_text())) == 1
    assert "i8_pair<0>(wa, wb)" in _src()


def _wt_smem(hd: int, mt: int, scale_bytes: int, ring: int) -> int:
    grp = _const("kGrp") * hd + _const("kGrpPad")
    tile = _const("kTile") // _const("kGrp") * grp
    stage = 2 * tile + 2 * _const("kTile") * scale_bytes
    q = mt * 16 * (hd + 16) * 2
    p = mt * 16 * (_const("kTile") + 8) * 2
    return q + p + ring * stage + _const("kWtStages") * 8


@pytest.mark.parametrize("scale_bytes", [4, 2])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("mt,blocks", [(1, 4), (2, 3), (4, 2)])
def test_blocks_an_sm_fit_their_shared_memory(mt, blocks, hd, scale_bytes):
    """The launch bounds ask for four blocks an SM at one m16 tile of rows,
    three at two, two at four: their dynamic shared memory (q, P, two ring
    stages, the barriers), the static row statistics and the card's reserve
    fit; copies, ldmatrix rows and barriers stay 16-byte aligned."""
    assert ("__launch_bounds__(kTcThreads, MT == 1 ? 4 : MT == 2 ? 3 : 2) widening_tc"
            in _src())
    per_block = _wt_smem(hd, mt, scale_bytes, 2) + 4 * mt * 16 * 4 + SMEM_RESERVED
    assert blocks * per_block <= SMEM_PER_SM
    stage = _wt_smem(hd, mt, scale_bytes, 1) - _wt_smem(hd, mt, scale_bytes, 0)
    assert stage % 16 == 0 and (mt * 16 * (hd + 16) * 2) % 16 == 0
    assert ((_const("kTile") + 8) * 2) % 16 == 0


def test_staged_rows_spread_the_banks():
    """q's rows 8 words past a multiple of 32 (the lanes' 8-byte reads of
    rows gid at 2 tig), P's rows 36 words apart (the lanes' words at 4 gid
    + tig), the K groups 4 words apart (a K word per lane: 4 gid + tig, V
    words at 8 tig + gid)."""
    for hd in (64, 128):
        qw = (hd + 16) // 2
        banks = {(gid * qw + 2 * tig) % 32 for gid in range(4) for tig in range(4)}
        assert len(banks) == 16
        gw = (_const("kGrp") * hd + _const("kGrpPad")) // 4
        assert len({(gid * gw + tig) % 32 for gid in range(8) for tig in range(4)}) == 32
    pw = (_const("kTile") + 8) // 2
    assert len({(gid * pw + tig) % 32 for gid in range(8) for tig in range(4)}) == 32


# ------------------------------------------- what the launcher hands the C side

class _FakeEntry:
    """Stands in for the C entry point: records what it is handed (data
    pointers of meta tensors are 0 and are not read)."""

    def __init__(self):
        self.calls = []

    def __call__(self, q, k8, v8, ks, vs, pos0, out, ws, b, t, kv, g, hd, s, sb, scale,
                 is_bf16, form, scale_bf16, stream):
        self.calls.append(dict(b=b, t=t, kv=kv, g=g, hd=hd, s=s, sb=sb, is_bf16=is_bf16,
                               form=form, scale_bf16=scale_bf16))
        return 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kv,t,g,hd,s", [(8, 32, 1, 1, 128, 1024), (8, 32, 32, 1, 128, 1024),
                                           (2, 2, 16, 8, 64, 512), (1, 2, 7, 3, 64, 576),
                                           (2, 2, 1, 8, 64, 520)])
def test_launcher_hands_the_plan_to_the_entry_point(monkeypatch, b, kv, t, g, hd, s, sdt,
                                                    dtype):
    entry = _FakeEntry()
    monkeypatch.setattr(attention, "_quant_lib", lambda: entry)
    monkeypatch.setattr(attention, "_stream", lambda x: 0)
    meta = torch.device("meta")
    q5 = torch.empty((b, t, kv, g, hd), dtype=dtype, device=meta)
    k8 = torch.empty((b, kv, s, hd), dtype=torch.int8, device=meta)
    ks = torch.empty((b, kv, s), dtype=sdt, device=meta)
    pos0 = torch.empty((b,), dtype=torch.int32, device=meta)
    sizes = []
    empty = torch.empty

    def spy(*shape, **kw):
        x = empty(*shape, **kw)
        sizes.append((x.numel(), x.dtype))
        return x

    monkeypatch.setattr(torch, "empty", spy)
    form, sb, nsb, ws = attention.quant_plan(False, b, kv, t, g, hd, s, dtype)
    out, got = attention._flash_attention_quant_cuda(q5, k8, k8, pos0, ks, ks, False)
    assert got == form == attention.k8_form(dtype, s)
    assert out.shape == q5.shape and out.dtype == dtype
    assert entry.calls == [dict(b=b, t=t, kv=kv, g=g, hd=hd, s=s, sb=sb,
                                is_bf16=int(dtype == torch.bfloat16),
                                form=attention.QUANT_FORMS.index(form),
                                scale_bf16=int(sdt == torch.bfloat16))]
    assert sizes == [(ws, torch.float32)]  # one f32 workspace: every split's partials
    assert ws == b * kv * nsb * t * g * (hd + 2) and nsb == -(-s // sb)


# --------------------------------------------------- the lanes, emulated

LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _bf16_bits(f):
    """f32 -> bf16 bits, round to nearest even (finite values)."""
    u = np.asarray(f, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32) & np.uint32(0xFFFF)


def _pair(lo_f, hi_f):
    """pack_bf16: two f32 values rounded to a bf16 pair, lo in the low half."""
    return _bf16_bits(lo_f) | (_bf16_bits(hi_f) << np.uint32(16))


def _pair_values(word):
    word = np.asarray(word, np.uint32)
    return _f32(word << np.uint32(16)), _f32(word & np.uint32(0xFFFF0000))


def _byte_perm(x, y, sel):
    """__byte_perm: byte k of the result is byte (sel >> 4k) & 7 of {y, x}."""
    src = np.asarray(x, np.uint32).astype(np.uint64) | \
        np.asarray(y, np.uint32).astype(np.uint64) << np.uint64(32)
    out = np.zeros_like(src)
    for k in range(4):
        b = (src >> np.uint64(8 * ((sel >> 4 * k) & 7))) & np.uint64(0xFF)
        out |= b << np.uint64(8 * k)
    return out.astype(np.uint32)


def _widen(x, sel):
    """The byte `sel` picks into 0x4B0000uu (the f32 2^23 + u, u = q + 128
    after the XOR with 0x80), less 2^23 + 128: q exactly, in f32."""
    return _f32(_byte_perm(x, np.uint32(0x4B000000), sel)) - np.float32(8388736.0)


def _i8_pair_of_word(w, b0):
    """i8_pair_of_word<B0>: bytes B0, B0 + 1 of a word, the low half first."""
    return _pair(_widen(w, 0x7440 | b0), _widen(w, 0x7440 | (b0 + 1)))


def _i8_pair(j, lo, hi):
    """tc_common's i8_pair<J>: byte J of two words, `lo` the low half."""
    return _pair(_widen(lo, 0x7440 | j), _widen(hi, 0x7440 | j))


def _ld(smem, addr, nbytes):
    """Each lane's little-endian word of `nbytes` bytes at its byte address."""
    b = smem[np.asarray(addr)[:, None] + np.arange(nbytes)].astype(np.uint32)
    return sum(b[:, i] << np.uint32(8 * i) for i in range(nbytes)).astype(np.uint32)


def _mma(c, a, b0, b1):
    """mma.m16n8k16 bf16 over one warp: lane registers -> A [16, 16], B
    [16, 8] by the PTX fragment layout; c (lanes x 4, f32) += the lanes' C
    values of A B (products exact, summed in f64, rounded once)."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for reg, (row, kk) in enumerate(((GID, 2 * TIG), (GID + 8, 2 * TIG),
                                     (GID, 2 * TIG + 8), (GID + 8, 2 * TIG + 8))):
        lo, hi = _pair_values(a[reg])
        A[row, kk], A[row, kk + 1] = lo, hi
    for reg, kk in ((b0, 2 * TIG), (b1, 2 * TIG + 8)):
        lo, hi = _pair_values(reg)
        B[kk, GID], B[kk + 1, GID] = lo, hi
    C = A @ B
    got = np.stack([C[GID, 2 * TIG], C[GID, 2 * TIG + 1], C[GID + 8, 2 * TIG],
                    C[GID + 8, 2 * TIG + 1]], axis=1)
    c[:] = (c.astype(np.float64) + got).astype(np.float32)


def _ldmatrix_x4(smem16, row_ld, addrs):
    """ldmatrix.x4 on a uint16 array of rows `row_ld` wide: lanes 8i..8i+7
    give the element offsets of the 8 rows of matrix i; lane l receives
    M_i[l / 4][2 * (l % 4) + {0, 1}] in register i, the first in the low
    half."""
    regs = []
    for i in range(4):
        rows = smem16[np.asarray(addrs[8 * i:8 * i + 8])[:, None] + np.arange(8)]
        lo, hi = rows[GID, 2 * TIG], rows[GID, 2 * TIG + 1]
        regs.append(lo.astype(np.uint32) | hi.astype(np.uint32) << np.uint32(16))
    return regs


def _shfl_max(x):
    return np.repeat(x.reshape(8, 4).max(axis=1), 4)


def _shfl_sum(x):
    """The xor-shuffle sum over the four lanes of a row: (a + b) + (c + d)."""
    y = x.reshape(8, 4)
    return np.repeat((y[:, 0] + y[:, 1]) + (y[:, 2] + y[:, 3]), 4).astype(np.float32)


def _fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _tiles(rows: int) -> int:
    return 1 if rows <= 16 else 2 if rows <= 32 else 4


def _emulate_block(qr, k8, v8, sk_all, sv_all, p0, t, g, grp, sp, sps, rng):
    """One widening_tc block, lane by lane: qr [R, hd] (bf16 values, the
    query rows of one (batch, kv head), t-major), k8 / v8 [S, hd] int8 and
    the scales [S] of its cache (NaN past the fill). Shared memory starts as
    random bytes. Returns None for a block past its group's visible slots,
    else (the group's first row, P V partials [rows, hd], row maxima, row
    sums)."""
    R, hd = qr.shape
    S = k8.shape[0]
    mt_n = _tiles(R)
    r0 = grp * 16 * mt_n
    rows = min(16 * mt_n, R - r0)
    vis = min(S, p0 + (r0 + rows - 1) // g + 1)
    j_begin = sp * sps
    if j_begin >= vis:
        return None
    j_end = min(j_begin + sps, vis)
    n_it = -(-(j_end - j_begin) // 64)
    gb, tb, kk_n, cpl = 8 * hd + 16, 8 * (8 * hd + 16), hd // 16, hd // 32
    scale = np.float32(1.0 / hd ** 0.5)
    # q of the group's 16 * MT rows, bf16 bits, rows hd + 16 wide; P as bf16
    qld, pld = hd + 16, 72
    qs = np.zeros((16 * mt_n, qld), np.uint16)
    qs[:rows, :hd] = _bf16_bits(qr[r0:r0 + rows])
    qs = qs.ravel()
    ps = rng.integers(0, 1 << 16, 16 * mt_n * pld, dtype=np.uint16)
    stage = rng.integers(0, 256, 2 * tb, dtype=np.uint8)  # stale bytes, never finite-breaking
    m_r = np.full((mt_n, 2, 32), MASK, np.float32)
    l_r = np.zeros((4, mt_n, 2, 32), np.float32)
    o = np.zeros((4, mt_n, cpl, 32, 4), np.float32)
    qp = np.stack([[p0 + (r0 + mt * 16 + GID + 8 * h) // g for h in range(2)]
                   for mt in range(mt_n)])
    for it in range(n_it):
        j0 = j_begin + it * 64
        n = min(64, j_end - j0)
        for g8 in range(8):  # the bulk copies: visible rows only
            r8 = min(8, n - 8 * g8)
            for base, cache in ((0, k8), (tb, v8)):
                if r8 > 0:
                    dst = base + g8 * gb
                    stage[dst:dst + r8 * hd] = cache[j0 + 8 * g8:j0 + 8 * g8 + r8].view(
                        np.uint8).ravel()
        sk, sv = sk_all[j0:j0 + 64], sv_all[j0:j0 + 64]  # whole tiles of scales
        red = np.zeros((4, mt_n, 2, 32), np.float32)
        scores = np.zeros((4, mt_n, 2, 32, 4), np.float32)
        for w in range(4):  # Q K^T of n-tiles 2w, 2w + 1
            s = scores[w]
            for kk in range(kk_n):
                kb = []
                for nn in range(2):
                    word = _ld(stage, GID * gb + (2 * w + nn) * hd + kk * 16 + 4 * TIG, 4)
                    word = word ^ np.uint32(0x80808080)
                    kb.append((_i8_pair_of_word(word, 0), _i8_pair_of_word(word, 2)))
                for mt in range(mt_n):
                    lo = (mt * 16 + GID) * qld + kk * 16 + 4 * TIG  # bf16 elements
                    hi = lo + 8 * qld
                    words = [qs[lo].astype(np.uint32) | qs[lo + 1].astype(np.uint32) << 16,
                             qs[lo + 2].astype(np.uint32) | qs[lo + 3].astype(np.uint32) << 16,
                             qs[hi].astype(np.uint32) | qs[hi + 1].astype(np.uint32) << 16,
                             qs[hi + 2].astype(np.uint32) | qs[hi + 3].astype(np.uint32) << 16]
                    a = [words[0], words[2], words[1], words[3]]
                    for nn in range(2):
                        _mma(s[mt, nn], a, *kb[nn])
            for mt in range(mt_n):
                for h in range(2):
                    mx = np.full(32, MASK, np.float32)
                    for nn in range(2):
                        for e in range(2):
                            slot = 16 * TIG + 8 * e + 2 * w + nn
                            ok = (j0 + slot < j_end) & (j0 + slot <= qp[mt, h])
                            with np.errstate(invalid="ignore"):
                                v = (s[mt, nn, :, 2 * h + e] * scale).astype(np.float32) * sk[slot]
                            s[mt, nn, :, 2 * h + e] = np.where(ok, v.astype(np.float32), MASK)
                            mx = np.maximum(mx, s[mt, nn, :, 2 * h + e])
                    red[w, mt, h] = _shfl_max(mx)
        alpha = np.zeros((mt_n, 2, 32), np.float32)
        for mt in range(mt_n):
            for h in range(2):
                mn = np.maximum(m_r[mt, h], np.maximum(np.maximum(red[0, mt, h], red[1, mt, h]),
                                                       np.maximum(red[2, mt, h], red[3, mt, h])))
                alpha[mt, h] = np.exp((m_r[mt, h] - mn).astype(np.float32))
                m_r[mt, h] = mn
        for w in range(4):  # p, the warp's sums, p * sv in bf16 into P
            for mt in range(mt_n):
                for h in range(2):
                    psum = np.zeros(32, np.float32)
                    pw = []
                    for nn in range(2):
                        psv = []
                        for e in range(2):
                            slot = 16 * TIG + 8 * e + 2 * w + nn
                            p = np.exp((scores[w, mt, nn, :, 2 * h + e]
                                        - m_r[mt, h]).astype(np.float32))
                            psum = (psum + p).astype(np.float32)
                            with np.errstate(invalid="ignore"):
                                prod = (p * sv[slot]).astype(np.float32)
                            psv.append(np.where(j0 + slot < j_end, prod, np.float32(0)))
                        pw.append(_pair(psv[0], psv[1]))
                    l_r[w, mt, h] = _fma(l_r[w, mt, h], alpha[mt, h], _shfl_sum(psum))
                    r = mt * 16 + GID + 8 * h
                    col = 16 * w + 2 * TIG
                    for nn in range(2):
                        ps[r * pld + col + 8 * nn] = pw[nn] & np.uint32(0xFFFF)
                        ps[r * pld + col + 8 * nn + 1] = pw[nn] >> np.uint32(16)
        for w in range(4):  # O = O * alpha + P V, the warp's columns
            for mt in range(mt_n):
                for j in range(cpl):
                    for h in range(2):
                        o[w, mt, j, :, 2 * h:2 * h + 2] *= alpha[mt, h][:, None]
            vcol = tb + 2 * TIG * gb + w * (hd // 4) + cpl * GID
            for kst in range(4):
                v0 = vcol + 2 * kst * hd
                wv = [_ld(stage, a, cpl) ^ np.uint32(0x80808080 if cpl == 4 else 0x8080)
                      for a in (v0, v0 + gb, v0 + hd, v0 + gb + hd)]
                a = [_ldmatrix_x4(ps, pld, (mt * 16 + (LANE & 15)) * pld + kst * 16
                                  + (LANE >> 4) * 8) for mt in range(mt_n)]
                for j in range(cpl):
                    b0, b1 = _i8_pair(j, wv[0], wv[1]), _i8_pair(j, wv[2], wv[3])
                    for mt in range(mt_n):
                        _mma(o[w, mt, j], a[mt], b0, b1)
    pacc = np.full((rows, hd), np.nan, np.float32)
    pm = np.full(rows, np.nan, np.float32)
    pl = np.full(rows, np.nan, np.float32)
    for mt in range(mt_n):
        for h in range(2):
            r = mt * 16 + GID + 8 * h
            ok = r < rows
            lsum = (((l_r[0, mt, h] + l_r[1, mt, h]).astype(np.float32) + l_r[2, mt, h])
                    .astype(np.float32) + l_r[3, mt, h]).astype(np.float32)
            pm[r[ok]], pl[r[ok]] = m_r[mt, h][ok], lsum[ok]
            for w in range(4):
                for e in range(2):
                    for j in range(cpl):
                        col = w * (hd // 4) + cpl * (2 * TIG + e) + j
                        pacc[r[ok], col[ok]] = o[w, mt, j, ok, 2 * h + e]
    return r0, pacc, pm, pl


def emulate(q5, k8, v8, ks, vs, pos0, seed=0):
    """K8's tensor-core form and quant_merge, lane by lane: q5 [B, t, KV, g,
    hd] bf16 values, the int8 cache [B, KV, S, hd], scales [B, KV, S] as
    the kernel reads them (NaN past the fill allowed), pos0 [B]. The
    workspace starts as NaN, so a merge that read a partial no block wrote
    gives NaN. Returns q5's shape, rounded to bf16, and the blocks that
    ran."""
    rng = np.random.default_rng(seed)
    B, t, KV, g, hd = q5.shape
    S = k8.shape[2]
    R = t * g
    sps = attention.k8_split(t, g, S)
    nsb = -(-S // sps)
    groups = -(-R // (16 * _tiles(R)))
    rows = q5.transpose(0, 2, 1, 3, 4).reshape(B, KV, R, hd)
    out = np.full((B, KV, R, hd), np.nan, np.float32)
    ran = 0
    for b, kvh in np.ndindex(B, KV):
        p0 = int(pos0[b])
        ws_o = np.full((nsb, R, hd), np.nan, np.float32)
        ws_m = np.full((nsb, R), np.nan, np.float32)
        ws_l = np.full((nsb, R), np.nan, np.float32)
        for grp in range(groups):
            for sp in range(nsb):
                res = _emulate_block(rows[b, kvh], k8[b, kvh], v8[b, kvh], ks[b, kvh],
                                     vs[b, kvh], p0, t, g, grp, sp, sps, rng)
                if res is None:
                    continue
                ran += 1
                r0, pacc, pm, pl = res
                n = pacc.shape[0]
                ws_o[sp, r0:r0 + n], ws_m[sp, r0:r0 + n], ws_l[sp, r0:r0 + n] = pacc, pm, pl
        for r in range(R):  # quant_merge: the splits the row sees, in order, fmaf
            last = min((p0 + r // g) // sps, nsb - 1)
            mx = np.max(np.append(ws_m[:last + 1, r], MASK))
            num = np.zeros(hd, np.float32)
            den = np.float32(0)
            for sp in range(last + 1):
                w = np.exp((ws_m[sp, r] - mx).astype(np.float32))
                num = _fma(w, ws_o[sp, r], num)
                den = _fma(w, ws_l[sp, r], den)
            out[b, kvh, r] = num / den
    got = torch.from_numpy(out).to(torch.bfloat16).float().numpy()
    return got.reshape(B, KV, t, g, hd).transpose(0, 2, 1, 3, 4), ran


def _case(t, g, hd, s, fills, seed, bf16_scales=False):
    """One batch row per fill, KV = 1: q [B, t, g, hd] in bf16 values, the
    int8 cache and its scales quantized as the cache writer does, pos0 so
    that the last row sees `fill` slots. The kernel's view of the scale
    planes has NaN past each row's fill."""
    from llamago_tpu_torch.runtime.kv_cache import quantize_kv_rows

    rng = np.random.default_rng(seed)
    b = len(fills)
    q = torch.from_numpy(rng.standard_normal((b, t, g, hd)).astype(np.float32))
    q = q.bfloat16().float().numpy()
    k8, ks = quantize_kv_rows(torch.from_numpy(rng.standard_normal((b, 1, s, hd))
                                               .astype(np.float32)))
    v8, vs = quantize_kv_rows(torch.from_numpy(rng.standard_normal((b, 1, s, hd))
                                               .astype(np.float32) * 2))
    if bf16_scales:
        ks, vs = ks.bfloat16(), vs.bfloat16()
    pos0 = np.array([max(f - t, 0) for f in fills], np.int32)
    return q, k8.numpy(), v8.numpy(), ks, vs, pos0


def _poisoned(scales, pos0, t):
    """The scale planes as f32 with NaN from each row's fill on."""
    x = scales.float().numpy().copy()
    for b, p in enumerate(pos0):
        x[b, :, int(p) + t:] = np.nan
    return x


def _plain(q, k8, v8, ks, vs, pos0):
    b, t, g, hd = q.shape
    tq = torch.from_numpy(q).bfloat16().reshape(b, t, 1, g, hd)
    out = attention.flash_attention_quant_plain(
        tq, torch.from_numpy(k8), torch.from_numpy(v8), torch.from_numpy(pos0), ks, vs)
    assert out.dtype == torch.bfloat16
    return out.float().numpy().reshape(q.shape)


def _jax(q, k8, v8, ks, vs, pos0, monkeypatch):
    monkeypatch.setattr(jkernels, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jattention, "_I8DOT", False)
    jattention._flash_attention_lenaware_quant.clear_cache()
    b, t, g, hd = q.shape
    sdt = jnp.bfloat16 if ks.dtype == torch.bfloat16 else jnp.float32
    jq = jnp.asarray(q, jnp.bfloat16).reshape(b, t, g, hd)
    positions = jnp.asarray(pos0[:, None] + np.arange(t, dtype=np.int32)[None])
    jk8, jv8 = jnp.asarray(k8), jnp.asarray(v8)
    jks, jvs = jnp.asarray(ks.float().numpy(), sdt), jnp.asarray(vs.float().numpy(), sdt)
    assert jattention.can_fuse_attention_quant(jq, jk8)
    try:
        out = jattention.flash_attention_quant(jq, jk8, jv8, positions, jks, jvs)
    finally:
        jattention._flash_attention_lenaware_quant.clear_cache()
    return np.asarray(out, np.float32).reshape(q.shape)


def _check(t, g, hd, s, fills, seed, monkeypatch, bf16_scales=False, with_jax=True):
    q, k8, v8, ks, vs, pos0 = _case(t, g, hd, s, fills, seed, bf16_scales)
    q5 = q.reshape(q.shape[0], t, 1, g, hd)
    got, ran = emulate(q5, k8, v8, _poisoned(ks, pos0, t), _poisoned(vs, pos0, t), pos0, seed)
    got = got.reshape(q.shape)
    assert np.isfinite(got).all()
    # every block with a visible slot ran, and no other
    sps = attention.k8_split(t, g, s)
    r, mt = t * g, 16 * _tiles(t * g)
    assert ran == sum(-(-min(s, int(p) + (min(r, (grp + 1) * mt) - 1) // g + 1) // sps)
                      for p in pos0 for grp in range(-(-r // mt)))
    np.testing.assert_allclose(got, _plain(q, k8, v8, ks, vs, pos0), rtol=0, atol=K8_TOL)
    if with_jax:
        np.testing.assert_allclose(got, _jax(q, k8, v8, ks, vs, pos0, monkeypatch), rtol=0,
                                   atol=K8_TOL)


@pytest.mark.parametrize("fills", [(1, 63, 64), (65, 257, 512)], ids=["fills1-64", "fills65-S"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
def test_lane_emulation_at_decode(g, hd, fills, monkeypatch):
    """t = 1: one m16 tile of rows, two splits of four tiles, fills on a
    tile's edges (63, 64, 65) and the second split's (257)."""
    _check(1, g, hd, 512, fills, seed=g * 10 + hd + fills[0], monkeypatch=monkeypatch)


@pytest.mark.parametrize("t,g,hd,s,fills", [
    (16, 1, 128, 512, (1, 130, 300)),   # 16 rows, two splits
    (32, 1, 64, 512, (1, 257, 300)),    # two m16 tiles, two splits
    (4, 8, 128, 256, (40, 256)),        # GQA, two m16 tiles
    (16, 8, 64, 256, (20, 200)),        # 128 rows: two blocks of four m16 tiles, one split
    (7, 3, 64, 320, (9, 320)),          # ragged rows, a last split of one tile
], ids=["t16", "t32", "gqa_t4", "gqa_t16", "ragged"])
def test_lane_emulation_at_more_rows(t, g, hd, s, fills, monkeypatch):
    _check(t, g, hd, s, fills, seed=t * 100 + g + s, monkeypatch=monkeypatch)


@pytest.mark.parametrize("t,g,hd", [(1, 1, 128), (16, 8, 64), (32, 1, 64)])
def test_lane_emulation_with_bf16_scale_planes(t, g, hd, monkeypatch):
    """bf16 scale planes, widened as the kernel reads them; NaN past the
    fill in them too."""
    _check(t, g, hd, 256, (1, 100, 256), seed=7 + t + g, monkeypatch=monkeypatch,
           bf16_scales=True)


def test_lane_emulation_reads_nothing_it_did_not_write():
    """Stale shared memory (other seeds) changes no bit of the output, and
    NaN in the scale planes past the fill and in the workspace never
    reaches it: unread K rows and scales are masked by a select, p * sv is
    0 past the fill, V bytes there are finite."""
    q, k8, v8, ks, vs, pos0 = _case(4, 2, 64, 256, (3, 70, 200), seed=11)
    q5 = q.reshape(3, 4, 1, 2, 64)
    ksn, vsn = _poisoned(ks, pos0, 4), _poisoned(vs, pos0, 4)
    first, _ = emulate(q5, k8, v8, ksn, vsn, pos0, seed=1)
    assert np.isfinite(first).all()
    np.testing.assert_array_equal(emulate(q5, k8, v8, ksn, vsn, pos0, seed=2)[0], first)
    clean, _ = emulate(q5, k8, v8, ks.float().numpy(), vs.float().numpy(), pos0, seed=1)
    np.testing.assert_array_equal(clean, first)


@pytest.mark.parametrize("hd", [64, 128])
def test_pair_builders_are_exact(hd):
    """Every int8 value becomes its exact bf16 value, two bytes of a word
    (K: i8_pair_of_word) or one byte of two words (V: i8_pair, bytes 0 and
    1 only at hd = 64, whose words are 16 bits), each word XORed with 0x80
    a byte first, as the source does."""
    src = _src()
    assert "i8_pair_of_word<0>(w)" in src and "i8_pair_of_word<2>(w)" in src
    assert "^ 0x80808080u" in src and "^ 0x8080u" in src
    qv = np.arange(-128, 128, dtype=np.int64)
    u = ((qv & 0xFF) ^ 0x80).astype(np.uint32)
    word = u | np.roll(u, 1) << np.uint32(8) | np.roll(u, 2) << np.uint32(16) | \
        np.roll(u, 3) << np.uint32(24)
    if hd == 64:
        word &= np.uint32(0xFFFF)
    else:
        for b0 in (0, 2):
            lo, hi = _pair_values(_i8_pair_of_word(word, b0))
            assert np.array_equal(lo, np.roll(qv, b0))
            assert np.array_equal(hi, np.roll(qv, b0 + 1))
    for j in range(hd // 32):
        assert f"i8_pair<{j}>(wa, wb)" in src
        lo, hi = _pair_values(_i8_pair(j, word, np.roll(word, 5)))
        assert np.array_equal(lo, np.roll(qv, j)) and np.array_equal(hi, np.roll(np.roll(qv, j), 5))
