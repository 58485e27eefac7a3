"""K2's tensor-core form (a bf16 cache): its route, its split plan, the
arguments its launcher hands the C entry point, and a numpy emulation of
its lanes, against the plain version and the JAX package on the CPU.

On the card a bf16 cache takes `attn_decode_tc` (`ops/attention.py:k2_form`,
`csrc/attn_decode.cu`): bf16 mma.sync.m16n8k16 for Q K^T and P V with f32
accumulation, 64-slot K/V tiles in a ring of shared memory (rows padded by
16 bytes), the slots of a (batch, kv head) cut into splits that
`decode_attn_plan` plans on the host, each warp with its own running
statistics, merged in warp order within a block and in split order by the
merge pass (`attn_combine`, a second launch, shared with the f32 form). Here, without a card, the wrapper takes the plain
version; the tests pin the routing rule (f32 takes the 3xTF32 form,
tests/test_torch_attn_f32tc.py), the plan's invariants, the form code, plan and workspace the
launcher hands the entry point, the entry point's C signature against the
ctypes argtypes, and an emulation of what each lane reads, multiplies,
masks, rounds and merges, held against `flash_attention_plain` and the JAX
kernel in interpret mode.
"""

import ctypes
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
# absolute, as chip_smoke's K2_TOL: outputs are bf16 of size ~1 (one
# rounding), and the kernel rounds p to bf16 against each warp's running
# maximum where the plain version rounds against each S-block's
K2_TOL = 1e-2
SMS = 132
SMEM_PER_SM = 232448  # bytes of shared memory an H100 SM gives its blocks


def _src() -> str:
    return (CSRC / "attn_decode.cu").read_text()


# ------------------------------------------------------------------ routing

def test_k2_form_routes_by_cache_dtype():
    assert attention.k2_form(torch.bfloat16) == "decode_tc"
    # f32 takes the 3xTF32 form (tests/test_torch_attn_f32tc.py)
    assert attention.k2_form(torch.float32) == "decode_f32tc"


def test_k2_form_codes_match_the_c_entry_point():
    enum = re.search(r"enum Form \{ kDecodeTc = (\d), kDecodeF32Tc = (\d) \};", _src())
    assert enum is not None
    assert tuple(map(int, enum.groups())) == (attention.K2_FORMS.index("decode_tc"),
                                              attention.K2_FORMS.index("decode_f32tc"))
    # the two-pass f32 form is gone; both forms take the plan's whole tiles
    assert "attn_partial" not in _src() and "kFma" not in _src()
    assert "slots_per_split % kTile ||" in _src()
    assert attention.k2_plan(torch.float32, 2, 2, 1, 1, 64, 512) == \
        ("decode_f32tc", 64, 8, 2 * 2 * 8 * 1 * 66)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}


def test_entry_point_arguments_match_the_argtypes(monkeypatch):
    sig = re.search(r'extern "C" int llamago_attn_decode\(([^)]*)\)', _src())
    assert sig is not None
    params = [p.split() for p in sig.group(1).split(",")]
    assert [p[-1] for p in params] == [
        "q", "k", "v", "pos0", "out", "ws", "B", "t", "KV", "g", "hd", "S",
        "scale", "form", "slots_per_split", "n_split", "stream"]

    class Lib:
        llamago_attn_decode = type("Fn", (), {})()

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    fn = attention._lib.__wrapped__()
    assert fn.argtypes == [_C_TYPES[" ".join(p[:-1])] for p in params]
    assert fn.restype is ctypes.c_int


def test_ldmatrix_trans_lives_once_in_the_shared_header():
    """K2 and K7 share one copy of the transposed B-fragment load, and a
    change to the header rebuilds both."""
    pattern = re.compile(r"__device__ __forceinline__ void ldmatrix_x4_trans\(")
    assert len(pattern.findall((CSRC / "tc_common.cuh").read_text())) == 1
    assert not any(pattern.search(p.read_text()) for p in CSRC.glob("*.cu"))
    for name in ("attn_decode", "attn_prefill"):
        assert "ldmatrix_x4_trans(vb, vrow + n * 8);" in (CSRC / f"{name}.cu").read_text()
        assert _build.source_files(name) == [f"{name}.cu", "tc_common.cuh"]


# --------------------------------------------------------------- the plan

PLAN_SHAPES = [(4, 32, 1, 1, 128, 1024), (8, 32, 1, 1, 128, 1024),
               (4, 32, 32, 1, 128, 1024), (8, 32, 32, 1, 128, 1024),
               (4, 32, 16, 1, 128, 1024), (2, 2, 32, 8, 64, 512), (2, 2, 1, 8, 64, 512),
               (1, 8, 1, 8, 128, 8192), (3, 1, 32, 8, 128, 320), (1, 1, 1, 1, 64, 1),
               (2, 4, 7, 3, 64, 200), (16, 32, 1, 1, 128, 4096)]


@pytest.mark.parametrize("b,kv,t,g,hd,s", PLAN_SHAPES)
def test_plan_covers_the_cache_in_whole_tiles(b, kv, t, g, hd, s):
    sps, n_split, ws = attention.decode_attn_plan(b, kv, t, g, hd, s)
    assert sps >= 64 and sps % 64 == 0
    assert n_split == -(-s // sps)  # the C side checks this
    spans = [(i * sps, min((i + 1) * sps, s)) for i in range(n_split)]
    # every split holds slots at full fill, and together they cover [0, S)
    assert all(a < e for a, e in spans) and spans[0][0] == 0 and spans[-1][1] == s
    rows = t * g
    if n_split > 1:
        # a split's f32 partials within a quarter of the cache bytes it reads when full
        assert rows * hd * 4 <= 2 * sps * hd * 2 / 4
    assert ws == (b * kv * n_split * rows * (hd + 2) if n_split > 1 else 0)
    assert attention.k2_plan(torch.bfloat16, b, kv, t, g, hd, s) == \
        ("decode_tc", sps, n_split, ws)


def _stage_bytes(hd: int) -> int:
    return 2 * 64 * (hd + 8) * 2


@pytest.mark.parametrize("b", [4, 8])
def test_plan_fills_the_card_at_7b(b):
    """Full fill: at least two resident blocks an SM (blocks, and shared
    memory for two of them); the serving fills (about 100 to 300 slots):
    at least one block with work an SM."""
    kv, hd, s = 32, 128, 1024
    sps, n_split, _ = attention.decode_attn_plan(b, kv, 1, 1, hd, s)
    assert b * kv * n_split >= 2 * SMS
    stages = int(re.search(r"constexpr int kStages = (\d+);", _src()).group(1))
    ring = min(stages, sps // 64)
    assert 2 * ring * (_stage_bytes(hd) + 8) <= SMEM_PER_SM
    for fill in (100, 101, 128, 150, 200, 300):
        assert b * kv * -(-fill // sps) >= SMS, fill


def test_p_fits_where_the_stages_k_rows_were():
    """P goes through shared memory when warps share an m16 tile, that is
    for at most two m16 tiles (rows of 64 slots and 16 bytes of padding),
    in the stage's K rows once every warp has its scores (the kernel's
    static_assert, restated)."""
    for hd in (64, 128):
        assert 2 * 16 * PLD <= 64 * (hd + 8)
    assert "constexpr int kPLd = kTile + 8;" in _src()


# ------------------------------------------- what the launcher hands the C side

class _FakeEntry:
    """Stands in for the C entry point: records what it is handed (data
    pointers of meta tensors are 0 and are not read)."""

    def __init__(self):
        self.calls = []

    def __call__(self, q, k, v, pos0, out, ws, b, t, kv, g, hd, s, scale, form, sps, n_split,
                 stream):
        self.calls.append(dict(ws=ws is not None, b=b, t=t, kv=kv, g=g, hd=hd, s=s,
                               scale=scale, form=form, sps=sps, n_split=n_split))
        return 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,kv,t,g,hd,s", PLAN_SHAPES[:8])
def test_launcher_hands_the_plan_to_the_entry_point(monkeypatch, dtype, b, kv, t, g, hd, s):
    entry = _FakeEntry()
    monkeypatch.setattr(attention, "_lib", lambda: entry)
    monkeypatch.setattr(attention, "_stream", lambda x: 0)
    meta = torch.device("meta")
    q5 = torch.empty((b, t, kv, g, hd), dtype=dtype, device=meta)
    kc = torch.empty((b, kv, s, hd), dtype=dtype, device=meta)
    pos0 = torch.empty((b,), dtype=torch.int32, device=meta)
    workspaces = []
    empty = torch.empty

    def spy(*shape, **kw):
        x = empty(*shape, **kw)
        if kw.get("dtype") == torch.float32:
            workspaces.append(x.numel())
        return x

    monkeypatch.setattr(torch, "empty", spy)
    form, sps, n_split, ws = attention.k2_plan(dtype, b, kv, t, g, hd, s)
    for _ in range(2):
        out, got_form = attention._flash_attention_cuda(q5, kc, kc, pos0)
        assert got_form == form and out.shape == q5.shape and out.dtype == dtype
    assert entry.calls == 2 * [dict(ws=ws > 0, b=b, t=t, kv=kv, g=g, hd=hd, s=s,
                                     scale=1.0 / hd ** 0.5,
                                     form=attention.K2_FORMS.index(form), sps=sps,
                                     n_split=n_split)]
    assert workspaces == (2 * [ws] if ws else [])
    # a workspace exactly when the merge pass runs
    assert (ws > 0) == (n_split > 1)


# --------------------------------------------------- the lanes, emulated

LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3
MASK = np.float32(-1e9)


def bf16(a) -> np.ndarray:
    """a rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _bits(a) -> np.ndarray:
    """bf16-exact f32 values -> their bf16 bits."""
    return (np.ascontiguousarray(a, np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _values(bits) -> np.ndarray:
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


def _word(lo, hi) -> np.ndarray:
    return np.asarray(lo).astype(np.uint32) | (np.asarray(hi).astype(np.uint32) << 16)


def _pair(word):
    return _values(word & 0xFFFF), _values(word >> 16)


def _pack_bf16(lo, hi) -> np.ndarray:
    return _word(_bits(bf16(lo)), _bits(bf16(hi)))


def _mma(c, a, b0, b1):
    """mma.m16n8k16 over one warp: the lanes' registers -> A [16, 16] and
    B [16, 8] by the PTX fragment layout; c (lanes x 4, f32) += the lanes'
    C values of A B."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    with np.errstate(invalid="ignore", over="ignore"):  # unread rows may hold NaN bits
        for reg, (row, kk) in enumerate(((GID, 2 * TIG), (GID + 8, 2 * TIG),
                                         (GID, 2 * TIG + 8), (GID + 8, 2 * TIG + 8))):
            A[row, kk], A[row, kk + 1] = _pair(a[reg])
        for reg, kk in ((b0, 2 * TIG), (b1, 2 * TIG + 8)):
            B[kk, GID], B[kk + 1, GID] = _pair(reg)
        C = A @ B  # every product exact
        c += np.stack([C[GID, 2 * TIG], C[GID, 2 * TIG + 1], C[GID + 8, 2 * TIG],
                       C[GID + 8, 2 * TIG + 1]], axis=1).astype(np.float32)


def _ldmatrix_x4_trans(smem, rows, cols):
    """ldmatrix.x4.trans on a 2-D array of bf16 bits: lanes 8i..8i+7 give
    (row, column) addresses of the 8 rows of matrix i; lane l receives
    M_i[2 * (l % 4) + {0, 1}][l / 4] in register i."""
    regs = []
    for i in range(4):
        m = np.stack([smem[rows[8 * i + j], cols[8 * i + j]:cols[8 * i + j] + 8]
                      for j in range(8)])
        regs.append(_word(m[2 * TIG, GID], m[2 * TIG + 1, GID]))
    return regs


def _row_max(x):
    """The max over the four lanes of each row (the kernel's two xor
    shuffles), back on every lane."""
    return np.repeat(x.reshape(8, 4).max(axis=1), 4)


def _row_sum(x):
    """The kernel's xor-shuffle sum over the four lanes of a row: (a + b) +
    (c + d) for lanes a, b, c, d."""
    y = x.reshape(8, 4)
    return np.repeat((y[:, 0] + y[:, 1]) + (y[:, 2] + y[:, 3]), 4).astype(np.float32)


def _ldmatrix_x4(flat, addrs):
    """ldmatrix.x4 on flat bf16 bits: lanes 8i..8i+7 give the element
    addresses of the 8 rows of matrix i; lane l receives M_i[l / 4][2 *
    (l % 4) + {0, 1}] in register i."""
    regs = []
    for i in range(4):
        m = np.stack([flat[addrs[8 * i + j]:addrs[8 * i + j] + 8] for j in range(8)])
        regs.append(_word(m[GID, 2 * TIG], m[GID, 2 * TIG + 1]))
    return regs


PLD = 72  # P's row stride in shared memory (elements)


def emulate(q5, kc, vc, pos0, sps, n_split, seed=0):
    """What attn_decode_tc and its merge pass attn_combine compute, lane by
    lane: q5 [B, t, KV, g, hd] and the caches [B, KV, S, hd] as bf16-exact
    f32, pos0 [B]. Each tile of the ring starts as random bits (NaNs among
    them) where the kernel does not copy or zero it, and the workspace as
    NaN, so a merge that reads a partial no split wrote gives NaN. Returns
    q5's shape, bf16-exact f32."""
    rng = np.random.default_rng(seed)
    B, t, KV, g, hd = q5.shape
    S = kc.shape[2]
    R = t * g
    m_tiles = (min(R, 64) + 15) // 16
    WS = 4 if m_tiles == 1 else 2 if m_tiles == 2 else 1
    qbits = _bits(q5.transpose(0, 2, 1, 3, 4).reshape(B, KV, R, hd))  # t-major rows
    kbits, vbits = _bits(kc), _bits(vc)
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
                o, m, l = _emulate_split(qbits[b, kvh], kbits[b, kvh], vbits[b, kvh], rng,
                                         p0, g, r0, rows, j_begin, min(j_begin + sps, vis), WS)
                if n_split == 1:  # the block writes the output
                    out[b, kvh, r0:r0 + rows] = bf16(o / l[:, None])
                else:
                    ws_o[sp, r0:r0 + rows], ws_m[sp, r0:r0 + rows] = o, m
                    ws_l[sp, r0:r0 + rows] = l
        if n_split == 1:
            continue
        for r in range(R):  # attn_combine: a thread per (row, column), splits in order
            last = min((p0 + r // g) // sps, n_split - 1)
            mx = np.max(np.append(ws_m[:last + 1, r], MASK))
            num = np.zeros(hd, np.float32)
            den = np.float32(0)
            for sp in range(last + 1):
                w = np.exp(ws_m[sp, r] - mx).astype(np.float32)
                num = (np.float64(w) * ws_o[sp, r] + num).astype(np.float32)  # fmaf
                den = np.float32(np.float64(w) * ws_l[sp, r] + den)
            out[b, kvh, r] = bf16(num / den)
    return out.reshape(B, KV, t, g, hd).transpose(0, 2, 1, 3, 4)


def _emulate_split(qb, kb, vb, rng, p0, g, r0, rows, j_begin, j_end, WS):
    """One block over the tiles of its split. Warp w takes m16 tile w // WS
    and part w % WS: of each tile's slots in Q K^T, of the columns in P V;
    the WS warps of an m16 tile share each tile's row maxima and sums (and,
    for WS > 1, P through the stage's K rows). Returns the group's (P V,
    row max, row sum)."""
    R, hd = qb.shape
    LD, KK = hd + 8, hd // 16
    PART, COLS = 64 // WS, hd // WS
    NT, DT = PART // 8, COLS // 8
    scale = np.float32(1.0 / np.sqrt(hd))
    warps = []
    for warp in range(4):
        mt, part = divmod(warp, WS)
        if mt * 16 >= rows:
            warps.append(None)
            continue
        row_lo = r0 + mt * 16 + GID
        qf = [[np.zeros(32, np.uint32) for _ in range(4)] for _ in range(KK)]
        for kk in range(KK):
            c = kk * 16 + 2 * TIG
            for regs, row in (((0, 2), row_lo), ((1, 3), row_lo + 8)):
                ok = row < R
                rr = np.where(ok, row, 0)
                qf[kk][regs[0]] = np.where(ok, _word(qb[rr, c], qb[rr, c + 1]), 0)
                qf[kk][regs[1]] = np.where(ok, _word(qb[rr, c + 8], qb[rr, c + 9]), 0)
        warps.append(dict(mt=mt, part=part, qf=qf, qp=(p0 + row_lo // g, p0 + (row_lo + 8) // g),
                          m=[np.full(32, MASK, np.float32) for _ in range(2)],
                          l=[np.zeros(32, np.float32) for _ in range(2)],
                          o=np.zeros((DT, 32, 4), np.float32)))
    live = [w for w in warps if w is not None]
    for j0t in range(j_begin, j_end, 64):
        n = min(64, j_end - j0t)
        stage = rng.integers(0, 1 << 16, size=(128, LD), dtype=np.uint16)  # stale bits
        stage[rng.integers(0, 128, 16), rng.integers(0, LD, 16)] = 0x7FC0  # NaNs among them
        stage[:n, :hd] = kb[j0t:j0t + n]  # K rows by bulk copy
        stage[64:64 + n, :hd] = vb[j0t:j0t + n]  # V rows
        stage[64 + n:128, :hd] = 0  # V rows past the visible slots: zeroed
        for w in live:  # scores, mask, the warp's row maxima
            k0, j0 = w["part"] * PART, j0t + w["part"] * PART
            s = np.zeros((NT, 32, 4), np.float32)
            for kk in range(KK):
                for nt in range(NT):
                    row, col = k0 + nt * 8 + GID, kk * 16 + 2 * TIG
                    _mma(s[nt], w["qf"][kk], _word(stage[row, col], stage[row, col + 1]),
                         _word(stage[row, col + 8], stage[row, col + 9]))
            for nt in range(NT):
                for e in range(2):
                    slot = j0 + nt * 8 + 2 * TIG + e
                    for h in range(2):
                        with np.errstate(invalid="ignore", over="ignore"):
                            s[nt, :, 2 * h + e] = np.where(
                                (slot < j_end) & (slot <= w["qp"][h]),
                                s[nt, :, 2 * h + e] * scale, MASK)
            w["s"] = s
            w["mx"] = [_row_max(s[:, :, 2 * h:2 * h + 2].max(axis=(0, 2))) for h in range(2)]
        for w in live:  # the m16 tile's maxima over its WS warps
            peers = [v for v in live if v["mt"] == w["mt"]]
            w["mn"] = [np.maximum(w["m"][h], np.max([v["mx"][h] for v in peers], axis=0))
                       for h in range(2)]
        kflat = stage[:64].reshape(-1)  # P goes where the stage's K rows were
        for w in live:  # p, its row sums, P in bf16
            s, mn = w["s"], w["mn"]
            p = np.exp(s - np.stack([mn[0], mn[0], mn[1], mn[1]], axis=1)[None])
            w["ps"] = [_row_sum(np.sum([p[nt, :, 2 * h] + p[nt, :, 2 * h + 1]
                                        for nt in range(NT)], axis=0)) for h in range(2)]
            w["pf"] = [[None] * 4 for _ in range(4)]
            for nt in range(NT):
                lo, hi = _pack_bf16(p[nt, :, 0], p[nt, :, 1]), _pack_bf16(p[nt, :, 2], p[nt, :, 3])
                if WS == 1:
                    w["pf"][nt // 2][(nt & 1) * 2], w["pf"][nt // 2][(nt & 1) * 2 + 1] = lo, hi
                else:
                    c = w["part"] * PART + nt * 8 + 2 * TIG
                    for h, word in enumerate((lo, hi)):
                        addr = (w["mt"] * 16 + GID + 8 * h) * PLD + c
                        kflat[addr], kflat[addr + 1] = word & 0xFFFF, word >> 16
        for w in live:  # rescale, the tile's sums over the WS warps, O += P V
            peers = [v for v in live if v["mt"] == w["mt"]]
            for h in range(2):
                ps = w["ps"][h] if WS == 1 else np.float32(0)
                if WS > 1:
                    for v in peers:  # in part order
                        ps = (ps + v["ps"][h]).astype(np.float32)
                a = np.exp(w["m"][h] - w["mn"][h])
                w["l"][h] = (w["l"][h] * a + ps).astype(np.float32)
                w["o"][:, :, 2 * h:2 * h + 2] *= a[None, :, None]
                w["m"][h] = w["mn"][h]
            mat, mr = LANE >> 3, LANE & 7
            for ks in range(4):
                if WS > 1:
                    base = w["mt"] * 16 * PLD
                    w["pf"][ks] = _ldmatrix_x4(kflat, base + (LANE & 15) * PLD + ks * 16
                                               + (LANE >> 4) * 8)
                vrow = 64 + ks * 16 + (mat & 1) * 8 + mr
                for nt in range(0, DT, 2):
                    vfrag = _ldmatrix_x4_trans(stage, vrow,
                                               w["part"] * COLS + (mat >> 1) * 8 + nt * 8)
                    _mma(w["o"][nt], w["pf"][ks], vfrag[0], vfrag[1])
                    _mma(w["o"][nt + 1], w["pf"][ks], vfrag[2], vfrag[3])
    # the group's rows: each warp's columns of P V, the first part's max and sum
    num = np.zeros((rows, hd), np.float32)
    mx = np.zeros(rows, np.float32)
    den = np.zeros(rows, np.float32)
    for w in live:
        for h in range(2):
            r = w["mt"] * 16 + GID + 8 * h
            ok = r < rows
            for nt in range(DT):
                for e in range(2):
                    num[r[ok], w["part"] * COLS + nt * 8 + 2 * TIG[ok] + e] = w["o"][nt, ok, 2 * h + e]
            if w["part"] == 0:
                mx[r[ok]], den[r[ok]] = w["m"][h][ok], w["l"][h][ok]
    return num, mx, den


def _case(t, g, hd, s, fills, seed):
    rng = np.random.default_rng(seed)
    b = len(fills)
    q = bf16(rng.standard_normal((b, t, g, hd)))  # KV = 1
    k = bf16(rng.standard_normal((b, 1, s, hd)))
    v = bf16(rng.standard_normal((b, 1, s, hd)))
    pos0 = np.array([max(f - t, 0) for f in fills], np.int32)
    return q, k, v, pos0


def _plain(q, k, v, pos0):
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    b, t, h, hd = q.shape
    out = attention.flash_attention_plain(tq.reshape(b, t, 1, h, hd), tk, tv,
                                          torch.from_numpy(pos0))
    return out.float().numpy().reshape(q.shape)


def _jax(q, k, v, pos0):
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    try:
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        positions = jnp.asarray(pos0[:, None] + np.arange(q.shape[1], dtype=np.int32)[None])
        assert jattention.can_fuse_attention(jq, jk)
        return np.asarray(jattention.flash_attention(jq, jk, jv, positions),
                          np.float32).reshape(q.shape)
    finally:
        jkernels.FORCE_INTERPRET = old


S_EMU = 320  # five tiles, no multiple of a two-tile split
FILL_SETS = [(1, 63, 64), (65, 127, 128), (129, 200, S_EMU)]


@pytest.mark.parametrize("fills", FILL_SETS, ids=["fills1-64", "fills65-128", "fills129-S"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("t", [1, 16, 32])
def test_lane_emulation_matches_plain_and_jax(t, g, hd, fills):
    """The lanes' fragments, masks, statistics and merges give K2's function
    under the plan's split and under a two-tile split (slots 128: fills
    127, 128 and 129 sit on its edge, S = 320 is no multiple of it)."""
    q, k, v, pos0 = _case(t, g, hd, S_EMU, fills, seed=t * 100 + g * 10 + hd + fills[0])
    want_plain = _plain(q, k, v, pos0)
    want_jax = _jax(q, k, v, pos0)
    q5 = q.reshape(q.shape[0], t, 1, g, hd)
    plan = attention.decode_attn_plan(len(fills), 1, t, g, hd, S_EMU)[:2]
    for sps, n_split in {plan, (128, 3)}:
        got = emulate(q5, k, v, pos0, sps, n_split).reshape(q.shape)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want_plain, rtol=0, atol=K2_TOL, err_msg=str(sps))
        np.testing.assert_allclose(got, want_jax, rtol=0, atol=K2_TOL, err_msg=str(sps))


def test_lane_emulation_at_a_cache_of_no_whole_tile():
    """S = 200 ends inside a tile (the plain version then takes the whole
    cache as one block, as the TPU kernel's S-block of 8 allows)."""
    q, k, v, pos0 = _case(1, 8, 64, 200, (1, 150, 200), seed=5)
    q5 = q.reshape(3, 1, 1, 8, 64)
    for sps, n_split in ((64, 4), (128, 2), (256, 1)):
        got = emulate(q5, k, v, pos0, sps, n_split).reshape(q.shape)
        np.testing.assert_allclose(got, _plain(q, k, v, pos0), rtol=0, atol=K2_TOL)
