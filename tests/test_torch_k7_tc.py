"""K7's tensor-core form (a bf16 cache): its route, its chunk plan, the
arguments its launcher hands the C entry point, its shared memory, and a
numpy emulation of its lanes and of its merge pass, against the plain
version and the JAX kernel in interpret mode.

On the card a bf16 cache takes `attn_prefill_tc` (`ops/attention.py:k7_form`,
`csrc/attn_prefill.cu`): bf16 mma.sync.m16n8k16 for Q K^T and P V with f32
accumulation, four warps of 16 query rows each, 64-slot K/V tiles in a
ring of three stages that the TMA unit fills with one bulk copy per 8
slots (groups padded by 16 bytes, slots permuted within a tile so that a
fragment's rows fall on distinct banks), the slots of a q-tile cut into
chunks that `prefill_plan` plans from the shapes alone, each chunk's f32
partials merged in order by a second launch (`attn_prefill_merge`). Here,
without a card, the wrapper takes the plain version; the tests pin the
routing rule (f32 takes the 3xTF32 form, tests/test_torch_attn_f32tc.py),
the plan's invariants and its
values at the 7B windows, the form codes and the C signature, the shared
memory two blocks an SM need, the launcher on meta tensors, and an
emulation of what each lane copies, reads, multiplies, masks, rounds and
merges, with NaN in the shared memory no copy has written: ragged t, GQA
groups, hd 64, an S that is no multiple of 64, windows that end at S, and
rows that see nothing (NaN).
"""

import ctypes
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
# of max(1, |ref|), as chip_smoke's K7_TOL: outputs are bf16 (one rounding),
# and the kernel rounds p to bf16 against a running maximum where the plain
# version rounds the normalized p against the final one
K7_TOL = 1e-2
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for its blocks
SMEM_RESERVED = 1024  # bytes the card reserves for each resident block
LOG2E = np.float32(1.4426950408889634)


def _src() -> str:
    return (CSRC / "attn_prefill.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _src()).group(1))


# ------------------------------------------------------------------ routing

def test_k7_form_routes_by_cache_dtype():
    assert attention.k7_form(torch.bfloat16) == "prefill_tc"
    assert attention.k7_form(torch.float32) == "prefill_f32tc"


def test_k7_form_codes_match_the_c_entry_point():
    enum = re.search(r"enum Form \{ kPrefillTc = (\d), kPrefillF32Tc = (\d) \};", _src())
    assert enum is not None
    assert tuple(map(int, enum.groups())) == (attention.K7_FORMS.index("prefill_tc"),
                                              attention.K7_FORMS.index("prefill_f32tc"))
    # both forms take whole tiles a chunk, and a workspace when there is
    # more than one; the f32 FMA form is gone
    assert "slots_per_chunk % kBN ||\n      (n_chunks > 1 && ws == nullptr)" in _src()
    assert "attn_prefill_fma" not in _src() and "kFma" not in _src()


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}


def test_entry_point_arguments_match_the_argtypes(monkeypatch):
    sig = re.search(r'extern "C" int llamago_attn_prefill\(([^)]*)\)', _src())
    assert sig is not None
    params = [p.split() for p in sig.group(1).split(",")]
    assert [p[-1] for p in params] == [
        "q", "k", "v", "pos0", "out", "ws", "B", "t", "KV", "g", "hd", "S", "scale", "form",
        "slots_per_chunk", "n_chunks", "stream"]

    class Lib:
        llamago_attn_prefill = type("Fn", (), {})()

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    fn = attention._prefill_lib.__wrapped__()
    assert fn.argtypes == [_C_TYPES[" ".join(p[:-1])] for p in params]
    assert fn.restype is ctypes.c_int


def test_the_old_bf16_form_is_gone_and_k7_shares_the_ptx_wrappers():
    """The tensor-core form replaced attn_prefill_mma; the TMA copies,
    mbarriers, ldmatrix and mma come from tc_common.cuh."""
    assert "attn_prefill_mma" not in _src()
    assert _build.source_files("attn_prefill") == ["attn_prefill.cu", "tc_common.cuh"]
    for call in ("bulk_copy(", "mbar_wait(", "ldmatrix_x4(kb,", "ldmatrix_x4_trans(vb,"):
        assert call in _src()


# --------------------------------------------------------------- the plan

PLAN_SHAPES = [(1, 32, 64, 1, 128, 1024), (1, 32, 128, 1, 128, 1024),
               (1, 32, 256, 1, 128, 1024), (4, 32, 64, 1, 128, 1024),
               (2, 2, 70, 2, 64, 500), (2, 4, 33, 8, 128, 512), (1, 1, 40, 1, 64, 1),
               (2, 2, 100, 1, 128, 300), (1, 3, 200, 3, 64, 130), (16, 32, 256, 1, 128, 4096),
               (1, 8, 1000, 8, 128, 8192)]


@pytest.mark.parametrize("b,kv,t,g,hd,s", PLAN_SHAPES)
def test_plan_covers_the_cache_in_equal_chunks(b, kv, t, g, hd, s):
    form, cps, chunks, ws = attention.prefill_plan(torch.bfloat16, b, kv, t, g, hd, s)
    assert form == "prefill_tc" and cps % 64 == 0 and cps >= 64
    assert chunks == -(-s // cps)  # the C side checks this
    spans = [(i * cps, min((i + 1) * cps, s)) for i in range(chunks)]
    assert all(a < e for a, e in spans) and spans[-1][1] == s
    assert ws == (b * kv * chunks * t * g * (hd + 2) if chunks > 1 else 0)
    blocks = b * kv * -(-t * g // 64)
    if blocks >= attention._K7_MIN_BLOCKS:
        assert chunks == 1
    else:  # the shortest equal chunks that make no more than the blocks aimed at
        tiles, per = -(-s // 64), cps // 64
        wanted = min(tiles, -(-attention._K7_TARGET_BLOCKS // blocks))
        assert chunks <= wanted and (per == 1 or -(-tiles // (per - 1)) > wanted)


def test_plan_reads_the_shapes_only():
    """pos0 stays on the device: a CUDA graph of the prefill replays the
    same plan at every position."""
    assert list(inspect.signature(attention.prefill_plan).parameters) == [
        "dtype", "b", "kv", "t", "g", "hd", "s"]
    assert list(inspect.signature(attention.k7_chunk).parameters) == ["b", "kv", "t", "g", "s"]


def test_plan_at_the_7b_windows():
    """K7_SHAPE (b=1, KV=32, g=1, hd=128, S=1024): the 256-row windows give
    128 q-tiles and take one chunk; 128 and 64 rows are chunked."""
    plan = {t: attention.prefill_plan(torch.bfloat16, 1, 32, t, 1, 128, 1024)[1:3]
            for t in (64, 128, 256)}
    assert plan == {64: (128, 8), 128: (256, 4), 256: (1024, 1)}
    # the f32 form takes the same chunks (its blocks hold 64 query rows too)
    assert attention.prefill_plan(torch.float32, 1, 32, 64, 1, 128, 1000) == (
        "prefill_f32tc", 128, 8, 32 * 8 * 64 * 130)


def test_two_blocks_an_sm_fit():
    """attn_prefill_tc's launch bounds ask for two blocks an SM: the ring of
    three stages (each 2 x 8 groups of 8 slots, 16 bytes of padding a group)
    and its barriers fit twice."""
    src = _src()
    assert "__launch_bounds__(kTcThreads, 2) attn_prefill_tc" in src
    assert (_const("kTcThreads"), _const("kStages"), _const("kGroup"), _const("kPadB")) == (
        128, 3, 8, 8)
    for hd in (64, 128):
        stage = 2 * 8 * (8 * hd + 8) * 2
        smem = 3 * (stage + 8)
        assert stage % 16 == 0 and 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM


class _FakeEntry:
    def __init__(self):
        self.calls = []

    def __call__(self, q, k, v, pos0, out, ws, b, t, kv, g, hd, s, scale, form, cps, chunks,
                 stream):
        self.calls.append(dict(ws=ws is not None, form=form, cps=cps, chunks=chunks))
        return 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,kv,t,g,hd,s", [(1, 32, 64, 1, 128, 1024), (1, 32, 256, 1, 128, 1024),
                                           (2, 2, 70, 2, 64, 500)])
def test_launcher_hands_the_plan_to_the_entry_point(monkeypatch, dtype, b, kv, t, g, hd, s):
    """K7's launcher on meta tensors (data pointers 0, never read): the form
    code, chunks and workspace it hands its entry point, and the form it
    reports (which `flash_attention` counts in `launches_prefill_tc`)."""
    entry = _FakeEntry()
    monkeypatch.setattr(attention, "_prefill_lib", lambda: entry)
    monkeypatch.setattr(attention, "_stream", lambda x: 0)
    meta = torch.device("meta")
    q5 = torch.empty((b, t, kv, g, hd), dtype=dtype, device=meta)
    kc = torch.empty((b, kv, s, hd), dtype=dtype, device=meta)
    pos0 = torch.empty((b,), dtype=torch.int32, device=meta)
    workspaces = []
    empty = torch.empty

    def spy(*shape, **kw):
        x = empty(*shape, **kw)
        if kw.get("dtype") == torch.float32 and x.dim() == 1:
            workspaces.append(x.numel())
        return x

    monkeypatch.setattr(torch, "empty", spy)
    form, cps, chunks, ws = attention.prefill_plan(dtype, b, kv, t, g, hd, s)
    out, got_form = attention._flash_attention_prefill_cuda(q5, kc, kc, pos0)
    assert got_form == form and out.shape == q5.shape and out.dtype == dtype
    assert entry.calls == [dict(ws=ws > 0, form=attention.K7_FORMS.index(form), cps=cps,
                                chunks=chunks)]
    assert workspaces == ([ws] if ws else [])
    assert (ws > 0) == (chunks > 1)  # a workspace exactly when the merge pass runs
    assert "flash_attention.launches_prefill_tc += 1" in inspect.getsource(
        attention.flash_attention)


# ----------------------------------------------------- the lanes' emulation

LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3
TILE, GROUP = 64, 8


def bf16(a) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _ldsm(flat, addrs, trans=False):
    """ldmatrix.x4 (.trans): lanes 8i .. 8i+7 give the rows of matrix i
    (element offsets into `flat`); lane l receives M_i[l / 4][2 (l % 4) +
    {0, 1}], or transposed M_i[2 (l % 4) + {0, 1}][l / 4]. [32, 4, 2]."""
    rows = flat[addrs[:, None] + np.arange(8)[None, :]]
    out = np.empty((32, 4, 2), np.float32)
    for i in range(4):
        m = rows[8 * i:8 * i + 8]
        for e in range(2):
            out[:, i, e] = m[2 * TIG + e, GID] if trans else m[GID, 2 * TIG + e]
    return out


def _mma(c, a, b0, b1):
    """mma.m16n8k16 over one warp by the PTX fragment layout: c [32, 4] +=
    A (regs a[:, 0..3], halves lo/hi) times B (b0, b1), every product exact,
    one f32 rounding."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for reg, (row, kk) in enumerate(((GID, 2 * TIG), (GID + 8, 2 * TIG),
                                     (GID, 2 * TIG + 8), (GID + 8, 2 * TIG + 8))):
        A[row, kk], A[row, kk + 1] = a[:, reg, 0], a[:, reg, 1]
    for breg, kk in ((b0, 2 * TIG), (b1, 2 * TIG + 8)):
        B[kk, GID], B[kk + 1, GID] = breg[:, 0], breg[:, 1]
    with np.errstate(invalid="ignore"):
        C = A @ B
    add = np.stack([C[GID, 2 * TIG], C[GID, 2 * TIG + 1], C[GID + 8, 2 * TIG],
                    C[GID + 8, 2 * TIG + 1]], axis=1)
    return (c.astype(np.float64) + add).astype(np.float32)


def _quad(v, op):
    """The value of the four lanes of a row (xor shuffles by 1, then 2)."""
    v = op(v, v[LANE ^ 1])
    return op(v, v[LANE ^ 2])


def _f32(x):
    return np.float32(x)


def _emulate_block(qb, kb, vb, p0, g, r0, j_begin, j_end, scale2):
    """One block of attn_prefill_tc: the q-tile at rows r0 .. r0+63 of qb [R,
    hd] over the slots [j_begin, j_end) of kb, vb [S, hd]. Returns, per row
    of the tile, (unnormalized P V [hd], maximum, sum) as the warps leave
    them, the sum added over the row's four lanes."""
    R, hd = qb.shape
    gld, half = GROUP * hd + 8, GROUP * (GROUP * hd + 8)
    stages = 3
    ring = [np.full(2 * half, np.nan, np.float32) for _ in range(stages)]  # never copied: NaN
    n_it = -(-(j_end - j_begin) // TILE)

    def load(st, it):  # thread G < 8 K's group G, 8 + G V's; V rows past n zeroed
        j0 = j_begin + it * TILE
        n = min(TILE, j_end - j0)
        copied = 0
        for tid in range(2 * GROUP):
            grp, is_v = tid & 7, tid >= GROUP
            cnt = min(GROUP, n - GROUP * grp)
            if cnt > 0:
                dst = (half if is_v else 0) + grp * gld
                src = (vb if is_v else kb)[j0 + GROUP * grp:j0 + GROUP * grp + cnt]
                ring[st][dst:dst + cnt * hd] = src.ravel()
                copied += cnt * hd * 2
        assert copied == 2 * n * hd * 2  # the stage's mbarrier expects these bytes
        for r in range(n, TILE):
            off = half + (r >> 3) * gld + (r & 7) * hd
            ring[st][off:off + hd] = 0.0

    for i in range(min(stages, n_it)):
        load(i, i)
    dt, kk_steps = hd // 8, hd // 16
    krow = (LANE & 7) * gld + (LANE >> 4) * hd + ((LANE >> 3) & 1) * 8
    state = []
    for w in range(4):
        rows = r0 + 16 * w + GID
        lo = np.where((rows < R)[:, None], qb[np.minimum(rows, R - 1)], 0)
        hi = np.where((rows + 8 < R)[:, None], qb[np.minimum(rows + 8, R - 1)], 0)
        qf = [np.stack([np.stack([lo[LANE, k0 + 2 * TIG], lo[LANE, k0 + 2 * TIG + 1]], 1),
                        np.stack([hi[LANE, k0 + 2 * TIG], hi[LANE, k0 + 2 * TIG + 1]], 1),
                        np.stack([lo[LANE, k0 + 8 + 2 * TIG], lo[LANE, k0 + 9 + 2 * TIG]], 1),
                        np.stack([hi[LANE, k0 + 8 + 2 * TIG], hi[LANE, k0 + 9 + 2 * TIG]], 1)],
                       1) for k0 in range(0, hd, 16)]
        state.append(dict(qf=qf, qp=[p0 + rows // g, p0 + (rows + 8) // g],
                          qp_first=p0 + (r0 + 16 * w) // g, active=16 * w < R - r0,
                          m=np.full((32, 2), -np.inf, np.float32),
                          l=np.zeros((32, 2), np.float32),
                          o=[np.zeros((32, 4), np.float32) for _ in range(dt)]))
    for it in range(n_it):
        st = it % stages
        stage = ring[st]
        j0 = j_begin + it * TILE
        for w in range(4):
            ws_ = state[w]
            if not ws_["active"]:
                continue
            s = [np.zeros((32, 4), np.float32) for _ in range(8)]
            for kk in range(kk_steps):
                for n in range(0, 8, 2):
                    kbr = _ldsm(stage, krow + n * hd + kk * 16)
                    s[n] = _mma(s[n], ws_["qf"][kk], kbr[:, 0], kbr[:, 1])
                    s[n + 1] = _mma(s[n + 1], ws_["qf"][kk], kbr[:, 2], kbr[:, 3])
            full = j0 + TILE <= j_end and j0 + TILE - 1 <= ws_["qp_first"]
            mx = np.full((32, 2), -np.inf, np.float32)
            for n in range(8):
                for e in range(4):
                    h = e >> 1
                    slot = j0 + 16 * TIG + 8 * (e & 1) + n  # position 8n + 2 tig + (e & 1)
                    with np.errstate(invalid="ignore"):
                        v = (s[n][:, e] * scale2).astype(np.float32)
                    keep = True if full else (slot < j_end) & (slot <= ws_["qp"][h])
                    s[n][:, e] = np.where(keep, v, -np.inf)
                    mx[:, h] = np.fmax(mx[:, h], s[n][:, e])
            mx = _quad(mx, np.maximum)
            mn = np.maximum(ws_["m"], mx)
            ms = np.where(mn == -np.inf, np.float32(0), mn).astype(np.float32)
            a = np.exp2(ws_["m"] - ms).astype(np.float32)
            ws_["m"] = mn
            ws_["l"] = (ws_["l"] * a).astype(np.float32)
            for n in range(dt):
                ws_["o"][n] = (ws_["o"][n] * a[:, [0, 0, 1, 1]]).astype(np.float32)
            pf = [np.zeros((32, 4, 2), np.float32) for _ in range(4)]
            for n in range(8):
                p = np.exp2(s[n] - ms[:, [0, 0, 1, 1]]).astype(np.float32)
                ws_["l"][:, 0] = (ws_["l"][:, 0] + (p[:, 0] + p[:, 1])).astype(np.float32)
                ws_["l"][:, 1] = (ws_["l"][:, 1] + (p[:, 2] + p[:, 3])).astype(np.float32)
                pb = bf16(p)
                pf[n // 2][:, (n & 1) * 2] = pb[:, 0:2]
                pf[n // 2][:, (n & 1) * 2 + 1] = pb[:, 2:4]
            for ks in range(4):
                vrow = half + (LANE & 7) * gld + (2 * ks + ((LANE >> 3) & 1)) * hd + (LANE >> 4) * 8
                for n in range(0, dt, 2):
                    vbr = _ldsm(stage, vrow + n * 8, trans=True)
                    ws_["o"][n] = _mma(ws_["o"][n], pf[ks], vbr[:, 0], vbr[:, 1])
                    ws_["o"][n + 1] = _mma(ws_["o"][n + 1], pf[ks], vbr[:, 2], vbr[:, 3])
        if it + stages < n_it:  # after the block barrier: every warp is done with it
            load(st, it + stages)
    out = {}
    for w in range(4):
        ws_ = state[w]
        if not ws_["active"]:
            continue
        l_sum = _quad(ws_["l"], lambda x, y: (x + y).astype(np.float32))
        for h in range(2):
            rows = r0 + 16 * w + GID + 8 * h
            for lane in range(32):
                if rows[lane] >= R:
                    continue
                pv = out.setdefault(rows[lane], [np.zeros(hd, np.float32), 0.0, 0.0])
                for n in range(dt):
                    pv[0][n * 8 + 2 * TIG[lane]:n * 8 + 2 * TIG[lane] + 2] = \
                        ws_["o"][n][lane, 2 * h:2 * h + 2]
                pv[1], pv[2] = ws_["m"][lane, h], l_sum[lane, h]
    return out


def emulate(q5, kc, vc, pos0, cps, chunks):
    """attn_prefill_tc and attn_prefill_merge on numpy bf16 values: q5 [B, t,
    KV, g, hd], caches [B, KV, S, hd], pos0 [B]. Returns the bf16 output as
    f32 [B, t, KV, g, hd]."""
    b_, t, kv, g, hd = q5.shape
    s = kc.shape[2]
    R = t * g
    scale2 = _f32(_f32(1.0 / hd ** 0.5) * LOG2E)
    out = np.full(q5.shape, np.nan, np.float32)  # what no lane writes stays NaN
    for b in range(b_):
        p0 = int(pos0[b])
        for h in range(kv):
            qb = q5[b, :, h].reshape(R, hd)
            parts = {}
            for r0 in range(0, R, 64):
                rows = min(64, R - r0)
                vis = min(s, max(0, p0 + (r0 + rows - 1) // g + 1))
                for c in range(chunks):
                    j_begin = c * cps
                    if j_begin >= vis and chunks > 1:
                        continue  # no work: the merge gives it no weight
                    j_end = max(j_begin, min(j_begin + cps, vis))
                    for row, part in _emulate_block(qb, kc[b, h], vc[b, h], p0, g, r0,
                                                    j_begin, j_end, scale2).items():
                        parts[(row, c)] = part
            for row in range(R):
                if chunks == 1:
                    pv, _, l = parts[(row, 0)]
                    with np.errstate(invalid="ignore", divide="ignore"):
                        v = (pv / np.float32(l)).astype(np.float32)
                else:  # the merge: chunks 0 .. qp / cps in order, online
                    qp = p0 + row // g
                    if qp < 0:
                        v = np.full(hd, np.nan, np.float32)
                    else:
                        mx, den, num = np.float32(-np.inf), np.float32(0), np.zeros(hd, np.float32)
                        for c in range(min(qp // cps, chunks - 1) + 1):
                            pv, m, l = parts[(row, c)]
                            mn = max(mx, np.float32(m))
                            a, w = np.exp2(_f32(mx - mn)), np.exp2(_f32(m - mn))
                            mx = mn
                            den = _f32(np.float64(den) * a + np.float64(w) * _f32(l))
                            num = (num.astype(np.float64) * a + np.float64(w) * pv.astype(
                                np.float64)).astype(np.float32)
                        v = (num / den).astype(np.float32)
                out[b, row // g, h, row % g] = bf16(v)
    return out


CASES = [  # (b, kv, g, hd, S, t, pos0): ragged t, GQA, hd 64, S no multiple of 64, the
    # window ending at S, rows that see nothing
    (2, 2, 2, 64, 200, 70, [0, 130]),
    (1, 2, 3, 64, 130, 50, [-20]),
    (1, 1, 1, 128, 300, 100, [200]),
    (2, 1, 8, 128, 256, 9, [7, 247]),
]


def _case(b, kv, g, hd, s, t, pos0, seed=3):
    rng = np.random.default_rng(seed)
    q5 = bf16(rng.standard_normal((b, t, kv, g, hd)))
    kc = bf16(rng.standard_normal((b, kv, s, hd)))
    vc = bf16(rng.standard_normal((b, kv, s, hd)))
    return q5, kc, vc, np.asarray(pos0, np.int32)


def _rel_err(got, ref):
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    return (np.abs(got - ref)[~nan] / np.maximum(1.0, np.abs(ref[~nan]))).max()


@pytest.mark.parametrize("chunked", [False, True], ids=["plan", "chunks_of_64"])
@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_lane_emulation_matches_plain_and_jax(case, chunked):
    """The lanes' copies, fragments, masks and exponentials, the chunks and
    the merge in order, against `flash_attention_prefill_plain` and the JAX
    kernel in interpret mode, both in bf16: the plan's chunks, and chunks of
    one tile (every row merged over many chunks, the chunks past a q-tile's
    end skipped)."""
    b, kv, g, hd, s, t, pos0 = case
    q5, kc, vc, p0 = _case(*case)
    _, cps, chunks, _ = attention.prefill_plan(torch.bfloat16, b, kv, t, g, hd, s)
    if chunked:
        cps, chunks = 64, -(-s // 64)
    got = emulate(q5, kc, vc, p0, cps, chunks)
    tt = [torch.from_numpy(a).to(torch.bfloat16) for a in (q5, kc, vc)]
    plain = attention.flash_attention_prefill_plain(*tt, torch.from_numpy(p0)).float().numpy()
    assert _rel_err(got, plain) <= K7_TOL
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    try:
        jout = jattention._flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q5, kc, vc)),
                                           jnp.asarray(p0), 1.0 / hd ** 0.5)
    finally:
        jkernels.FORCE_INTERPRET = old
    assert _rel_err(got, np.asarray(jout, np.float32)) <= K7_TOL
    if min(pos0) < 0:
        assert np.isnan(got).any()  # a row that sees nothing gives NaN


def test_groups_put_a_fragments_rows_on_distinct_banks():
    """The 8 rows one ldmatrix matrix reads (one slot of each group, K and V
    alike) fall in 8 distinct 16-byte bank groups, and every slot of a tile
    is read once as a score position (the permutation is one to one)."""
    for hd in (64, 128):
        gld = 8 * hd + 8
        krow = (LANE & 7) * gld + (LANE >> 4) * hd + ((LANE >> 3) & 1) * 8
        vrow = (LANE & 7) * gld + ((LANE >> 3) & 1) * hd + (LANE >> 4) * 8
        for rows in (krow, vrow):
            for i in range(4):
                banks = (rows[8 * i:8 * i + 8] * 2 // 16) % 8
                assert sorted(banks) == list(range(8))
        slots = sorted(8 * (q & 7) + (q >> 3) for q in range(64))
        assert slots == list(range(64))
