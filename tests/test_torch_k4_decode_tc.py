"""K4's tensor-core form (the int8 cache, S-blocks of whole 64-slot tiles):
its route, its plan, the arguments its launcher hands the C entry point,
the package data that carries its sources, and a numpy emulation of its
lanes, against the plain version, the JAX kernel and the CUDA-core form.

On the card K4 takes `quant_partial_tc` (`ops/attention.py:k4_form`,
`csrc/attn_decode_quant.cu`) when the TPU kernels' S-block holds whole
64-slot tiles: one block per (batch, kv head, S-block), its K and V rows
copied by the TMA unit in groups of 8 rows (16 bytes of padding after each
group), int8 mma.sync.m16n8k32 for Q K^T and P V (exact in int32), the
softmax and the per-S-block requantization of p*sv with the CUDA-core
form's f32 operations, p8 through shared memory in the order of the PV
product's k, and the S-blocks' partials merged in S-block order by a second
launch (`quant_merge`, the merge of every form). Here, without a card, the wrapper takes the plain
version; the tests pin the routing rule (S-blocks under 64 slots keep the
CUDA-core form), the plan, the form code and the one workspace the launcher
hands the entry point, and an emulation of what each lane reads, multiplies,
masks, rounds and merges, held against `flash_attention_quant_i8dot_plain`
and the JAX kernel in interpret mode, and bit for bit against the CUDA-core
form's p8 and PV partials.
"""

import ctypes
import fnmatch
import functools
import pathlib
import re
import tomllib
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import attention as jattention
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch.ops import _build, attention

torch.set_num_threads(1)

ROOT = pathlib.Path(attention.__file__).parents[2]
CSRC = ROOT / "llamago_tpu_torch" / "csrc"
# absolute, as chip_smoke's K4_TOL: bf16 outputs of size ~1 (one rounding),
# and the kernel's per-S-block statistics merged in a second pass against
# the plain version's running ones
K4_TOL = 1e-2
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for its blocks
SMEM_RESERVED = 1024  # bytes the card reserves for each resident block


def _src() -> str:
    return (CSRC / "attn_decode_quant.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _src()).group(1))


# ------------------------------------------------------------ packaging

def _package_globs() -> list[str]:
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    return data["llamago_tpu_torch"]


@pytest.mark.parametrize("name", _build.SOURCES)
def test_every_file_a_kernel_builds_from_ships_as_package_data(name):
    """An installed package holds what nvcc reads: each source and every
    header it includes matches one of the port's package-data globs."""
    globs = _package_globs()
    for rel in _build.source_files(name):
        assert any(fnmatch.fnmatch(f"csrc/{rel}", g) for g in globs), (rel, globs)


def test_the_shared_tile_header_ships_with_both_matmuls():
    """K1's and K9's tile body lives in tile_tc.cuh: both sources build
    from it, and it matches a package-data glob."""
    globs = _package_globs()
    for name in ("dequant_matmul", "dequant_matmul_so"):
        assert "tile_tc.cuh" in _build.source_files(name)
    assert any(fnmatch.fnmatch("csrc/tile_tc.cuh", g) for g in globs)


def test_the_native_host_library_source_ships_as_package_data():
    """native/ builds from ggjt_kernels.cpp at first use: the source matches
    a package-data glob, so an installed package can build it."""
    from llamago_tpu_torch import native

    rel = pathlib.Path(native._SRC).relative_to(ROOT / "llamago_tpu_torch").as_posix()
    assert rel == "native/ggjt_kernels.cpp"
    assert any(fnmatch.fnmatch(rel, g) for g in _package_globs()), _package_globs()


def test_a_missing_quoted_include_raises_with_its_name(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "gone.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="gone.cuh"):
        _build.source_files("k")
    with pytest.raises(FileNotFoundError, match="gone.cuh"):
        _build.lib_path("k")


def test_k4_builds_with_the_shared_header():
    assert _build.source_files("attn_decode_quant") == ["attn_decode_quant.cu",
                                                        "tc_common.cuh"]
    pattern = re.compile(r"__device__ __forceinline__ void mma_s8\(")
    assert len(pattern.findall((CSRC / "tc_common.cuh").read_text())) == 1
    assert not any(pattern.search(p.read_text()) for p in CSRC.glob("*.cu"))


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("s,sb,form", [
    (1024, 256, "i8dot_tc"), (256, 256, "i8dot_tc"), (768, 256, "i8dot_tc"),
    (4096, 256, "i8dot_tc"), (384, 128, "i8dot_tc"), (320, 64, "i8dot_tc"),
    (192, 64, "i8dot_tc"), (520, 8, "i8dot"), (2000, 16, "i8dot"), (96, 32, "i8dot"),
    (40, 8, "i8dot")])
def test_k4_form_takes_the_tensor_cores_for_whole_tiles(s, sb, form):
    assert attention._tpu_sb(s) == sb
    assert attention.k4_form(s) == form
    b, kv, t, g, hd = 2, 4, 3, 2, 64
    ws = b * kv * (s // sb) * t * g * (hd + 2)
    for dt in (torch.bfloat16, torch.float32):
        assert attention.quant_plan(True, b, kv, t, g, hd, s, dt) == (form, sb, s // sb, ws)
    # K8 with f32 q keeps its CUDA-core form for every shape, on the same
    # S-blocks (bf16 q: tests/test_torch_k8_decode_tc.py)
    assert attention.quant_plan(False, b, kv, t, g, hd, s, torch.float32) == (
        "widening", sb, s // sb, ws)


def test_quant_plan_refuses_a_cache_without_an_s_block():
    with pytest.raises(ValueError):
        attention.quant_plan(True, 1, 1, 1, 1, 64, 36, torch.bfloat16)


def test_form_codes_match_the_c_entry_point():
    enum = re.search(r"enum Form \{ kWidening = (\d), kI8dot = (\d), kI8dotTc = (\d), "
                     r"kWideningTc = (\d) \};", _src())
    assert enum is not None
    assert tuple(map(int, enum.groups())) == tuple(
        attention.QUANT_FORMS.index(f) for f in ("widening", "i8dot", "i8dot_tc", "widening_tc"))
    assert _const("kTile") == attention._K4_TILE


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}


def test_entry_point_arguments_match_the_argtypes(monkeypatch):
    sig = re.search(r'extern "C" int llamago_attn_decode_quant\(([^)]*)\)', _src())
    assert sig is not None
    params = [p.split() for p in sig.group(1).split(",")]
    assert [p[-1] for p in params] == [
        "q", "k8", "v8", "ks", "vs", "pos0", "out", "ws", "B", "t", "KV", "g", "hd", "S",
        "SB", "scale", "is_bf16", "form", "scale_bf16", "stream"]

    class Lib:
        llamago_attn_decode_quant = type("Fn", (), {})()

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    fn = attention._quant_lib.__wrapped__()
    assert fn.argtypes == [_C_TYPES[" ".join(p[:-1])] for p in params]
    assert fn.restype is ctypes.c_int


def _tc_smem_bytes(hd: int, tiles: int) -> int:
    grp = _const("kGrp") * hd + _const("kGrpPad")
    tile = _const("kTile") // _const("kGrp") * grp
    sb = tiles * _const("kTile")
    return 2 * tiles * tile + 2 * sb * 4 + 16 * (sb + _const("kPPad")) + 2 * tiles * 8


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("tiles", [1, 2, 4])
def test_three_blocks_fit_an_sm(hd, tiles):
    """The kernel's launch bounds ask for three blocks an SM: their shared
    memory (the S-block's K and V, its scales, p8 of 16 rows, the barriers,
    and, static, the row statistics and q8 of 16 rows) fits."""
    assert "__launch_bounds__(kTcThreads, 3) quant_partial_tc" in _src()
    static = 3 * 4 * 16 * 4 + 16 * (hd + 16) + 16 * 4  # row statistics, q8, q scales
    per_block = _tc_smem_bytes(hd, tiles) + static + SMEM_RESERVED
    assert 3 * per_block <= SMEM_PER_SM
    # 16-byte alignment of every copy, ldmatrix row and the barriers
    assert (_const("kGrp") * hd + _const("kGrpPad")) % 16 == 0
    assert (tiles * 64 + _const("kPPad")) % 16 == 0


def test_padded_layouts_spread_the_banks():
    """The 8 slots of an n-tile (one per group) and the 8 rows of p8 an
    ldmatrix reads start on distinct groups of four banks."""
    for hd in (64, 128):
        stride = (_const("kGrp") * hd + _const("kGrpPad")) // 4  # words
        assert sorted((r * stride) % 32 // 4 for r in range(8)) == list(range(8))
    for sb in (64, 128, 256):
        stride = (sb + _const("kPPad")) // 4
        assert sorted((r * stride) % 32 // 4 for r in range(8)) == list(range(8))


# ------------------------------------------- what the launcher hands the C side

class _FakeEntry:
    """Stands in for the C entry point: records what it is handed (data
    pointers of meta tensors are 0 and are not read)."""

    def __init__(self):
        self.calls = []

    def __call__(self, q, k8, v8, ks, vs, pos0, out, ws, b, t, kv, g, hd, s, sb, scale,
                 is_bf16, form, scale_bf16, stream):
        self.calls.append(dict(b=b, t=t, kv=kv, g=g, hd=hd, s=s, sb=sb, scale=scale,
                               is_bf16=is_bf16, form=form, scale_bf16=scale_bf16))
        return 0


LAUNCH_SHAPES = [(8, 32, 1, 1, 128, 1024), (8, 32, 32, 1, 128, 1024),
                 (2, 2, 16, 8, 64, 512), (2, 4, 1, 2, 128, 320), (1, 2, 7, 3, 64, 384),
                 (2, 2, 1, 8, 64, 520), (1, 8, 32, 1, 128, 2000)]


@pytest.mark.parametrize("i8dot", [True, False], ids=["k4", "k8"])
@pytest.mark.parametrize("b,kv,t,g,hd,s", LAUNCH_SHAPES)
def test_launcher_hands_the_plan_to_the_entry_point(monkeypatch, i8dot, b, kv, t, g, hd, s):
    entry = _FakeEntry()
    monkeypatch.setattr(attention, "_quant_lib", lambda: entry)
    monkeypatch.setattr(attention, "_stream", lambda x: 0)
    meta = torch.device("meta")
    q5 = torch.empty((b, t, kv, g, hd), dtype=torch.bfloat16, device=meta)
    k8 = torch.empty((b, kv, s, hd), dtype=torch.int8, device=meta)
    ks = torch.empty((b, kv, s), dtype=torch.bfloat16, device=meta)
    pos0 = torch.empty((b,), dtype=torch.int32, device=meta)
    workspaces = []
    empty = torch.empty

    def spy(*shape, **kw):
        x = empty(*shape, **kw)
        workspaces.append((x.numel(), x.dtype))
        return x

    monkeypatch.setattr(torch, "empty", spy)
    form, sb, nsb, ws = attention.quant_plan(i8dot, b, kv, t, g, hd, s, q5.dtype)
    for _ in range(2):
        out, got_form = attention._flash_attention_quant_cuda(q5, k8, k8, pos0, ks, ks, i8dot)
        assert got_form == form and out.shape == q5.shape and out.dtype == q5.dtype
    if i8dot:
        assert form == ("i8dot_tc" if sb >= 64 else "i8dot")
    else:  # bf16 q: K8's tensor-core form where whole 64-slot tiles cover S
        assert form == ("widening_tc" if s % 64 == 0 else "widening")
    assert entry.calls == 2 * [dict(b=b, t=t, kv=kv, g=g, hd=hd, s=s, sb=sb,
                                     scale=1.0 / hd ** 0.5, is_bf16=1,
                                     form=attention.QUANT_FORMS.index(form), scale_bf16=1)]
    # one f32 workspace a call: every S-block's partials, maxima and sums
    assert workspaces == 2 * [(ws, torch.float32)]
    assert ws == b * kv * nsb * t * g * (hd + 2)


# --------------------------------------------------- the lanes, emulated

LANE = np.arange(32)
GID, TIG = LANE >> 2, LANE & 3
MASK = np.float32(-1e9)
INV127 = np.float32(1.0) / np.float32(127.0)


def _word(b4) -> np.ndarray:
    """[..., 4] int8 values -> uint32 words, the first in the low byte."""
    u = np.asarray(b4).astype(np.int64) & 0xFF
    return (u[..., 0] | u[..., 1] << 8 | u[..., 2] << 16 | u[..., 3] << 24).astype(np.uint32)


def _bytes(w) -> np.ndarray:
    """uint32 words -> [..., 4] int8, the low byte first."""
    return np.ascontiguousarray(np.asarray(w, np.uint32)).view(np.int8).reshape(-1, 4)


def _ld32(smem, addr) -> np.ndarray:
    """Each lane's 32-bit word at its byte address."""
    return _word(smem[np.asarray(addr)[:, None] + np.arange(4)].view(np.int8))


def _st32(smem, addr, words):
    smem[np.asarray(addr)[:, None] + np.arange(4)] = _bytes(words).view(np.uint8)


def _mma_s8(c, a, b0, b1):
    """mma.m16n8k32 on int8 over one warp: the lanes' registers -> A [16, 32]
    and B [32, 8] by the PTX fragment layout; c (lanes x 4, int64) += the
    lanes' C values of A B."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    k = 4 * TIG[:, None] + np.arange(4)
    for reg, (row, k0) in enumerate(((GID, 0), (GID + 8, 0), (GID, 16), (GID + 8, 16))):
        A[row[:, None], k0 + k] = _bytes(a[reg])
    for reg, k0 in ((b0, 0), (b1, 16)):
        B[k0 + k, GID[:, None]] = _bytes(reg)
    C = A @ B
    c += np.stack([C[GID, 2 * TIG], C[GID, 2 * TIG + 1], C[GID + 8, 2 * TIG],
                   C[GID + 8, 2 * TIG + 1]], axis=1)


def _ldmatrix_x4(smem, addrs, trans=False):
    """ldmatrix.x4 (.trans) on bytes read as b16: lanes 8i..8i+7 give the
    addresses of the 8 rows (16 bytes each) of matrix i; lane l receives
    M_i[l / 4][2 * (l % 4) + {0, 1}] (trans: M_i[2 * (l % 4) + {0, 1}][l /
    4]) in register i, the first in the low half."""
    regs = []
    for i in range(4):
        rows = smem[np.asarray(addrs[8 * i:8 * i + 8])[:, None] + np.arange(16)]
        h = np.ascontiguousarray(rows).view(np.uint16)  # [8, 8]
        lo, hi = (h[2 * TIG, GID], h[2 * TIG + 1, GID]) if trans else \
            (h[GID, 2 * TIG], h[GID, 2 * TIG + 1])
        regs.append(lo.astype(np.uint32) | hi.astype(np.uint32) << 16)
    return regs


def _byte_perm(x, y, sel):
    src = np.asarray(x).astype(np.uint64) | np.asarray(y).astype(np.uint64) << 32
    out = np.zeros_like(src)
    for k in range(4):
        out |= ((src >> np.uint64(8 * ((sel >> 4 * k) & 7))) & np.uint64(0xFF)) << np.uint64(8 * k)
    return out.astype(np.uint32)


def _row_max(x):
    """The max over the four lanes of each row (two xor shuffles)."""
    return np.repeat(x.reshape(8, 4).max(axis=1), 4)


def _row_sum(x):
    """The xor-shuffle sum over the four lanes of a row: (a + b) + (c + d)."""
    y = x.reshape(8, 4)
    return np.repeat((y[:, 0] + y[:, 1]) + (y[:, 2] + y[:, 3]), 4).astype(np.float32)


def _quant(x, s):
    """round(x / s) clipped to +-127, half to even, in f32 (the CUDA-core
    form's quant: an IEEE f32 division)."""
    return np.clip(np.rint((np.asarray(x, np.float32) / s).astype(np.float32)), -127, 127)


def _fma(a: float, b: float, c: float) -> float:
    """a * b + c in f64, rounded once: exact rationals, then float(), which
    rounds the quotient of two ints correctly."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _rcp_seed(d: float) -> float:
    """A model of rcp.approx.ftz.f64's result: 1 / d with the 20 fraction
    bits of its high word and a zero low word, within 2^-20 of 1 / d."""
    hi = np.array(1.0 / d).view(np.uint64) & np.uint64(0xFFFFFFFF00000000)
    return float(hi.view(np.float64))


@functools.lru_cache(maxsize=None)
def _rcp_d(s: float, seed_err: float = 0.0) -> float:
    """The tensor-core form's rcp_d(s): the seed (times 1 + seed_err) and
    the kernel's three Newton steps r = fma(r, fma(-d, r, 1), r), each fma
    rounded once."""
    d = float(np.float32(s))
    r = _rcp_seed(d) * (1.0 + seed_err)
    for _ in range(3):
        r = _fma(r, _fma(-d, r, 1.0), r)
    return r


def _quant_r(x, rs):
    """The tensor-core form's quant_r: x * rs in f64, rounded to f32, then
    rint and the clip to +-127."""
    y = (np.asarray(x, np.float32).astype(np.float64) * rs).astype(np.float32)
    return np.clip(np.rint(y), -127, 127)


def _emulate_block(qr, k8, v8, sk_all, sv_all, p0, t, g, si, sb, scale, rng):
    """One quant_partial_tc block, lane by lane: qr [R, hd] f32 (the query
    rows of one (batch, kv head), t-major), k8 / v8 [S, hd] int8 and the
    f32 scales [S] of its cache. Shared memory starts as random bytes. Returns
    (P V partials [R, hd], row maxima [R], row sums [R], p8 [R, SB] by slot)."""
    R, hd = qr.shape
    S = k8.shape[0]
    tiles = sb // 64
    gb, tb = 8 * hd + 16, 8 * (8 * hd + 16)
    pld, nt, kks, ch = sb + 16, 2 * tiles, hd // 32, hd // 64
    j0 = si * sb
    nvis = min(sb, min(p0 + t - 1, S - 1) - j0 + 1)
    ks_off, vs_off, p_off = 0, tiles * tb, 2 * tiles * tb
    smem = rng.integers(0, 256, p_off + 16 * pld, dtype=np.uint8)  # stale bytes
    sk = np.zeros(sb, np.float32)
    sv = np.zeros(sb, np.float32)
    sk[:nvis], sv[:nvis] = sk_all[j0:j0 + nvis], sv_all[j0:j0 + nvis]
    for tile in range(tiles):  # the bulk copies: 8 visible rows each
        n_tile = min(64, nvis - tile * 64)
        for grp in range(8):
            rows = min(8, n_tile - grp * 8)
            if rows <= 0:
                continue
            src = slice(j0 + tile * 64 + grp * 8, j0 + tile * 64 + grp * 8 + rows)
            for base, cache in ((ks_off, k8), (vs_off, v8)):
                dst = base + tile * tb + grp * gb
                smem[dst:dst + rows * hd] = cache[src].view(np.uint8).ravel()
    pacc = np.full((R, hd), np.nan, np.float32)
    pm = np.full(R, np.nan, np.float32)
    pl = np.full(R, np.nan, np.float32)
    p8_by_slot = np.full((R, sb), 99, np.int64)
    scale = np.float32(scale)
    for rb in range(0, R, 16):
        # q rows rb .. rb + 15 quantized once (a warp a row) into Q8 [16, hd +
        # 16] bytes, zeros past R; then every warp's A fragments from it
        qld = hd + 16
        q8s = rng.integers(0, 256, 16 * qld, dtype=np.uint8)
        qsc_s = np.zeros(16, np.float32)
        for r in range(16):
            x = qr[rb + r] if rb + r < R else np.zeros(hd, np.float32)
            a = np.abs(x).max()
            sq = np.float32(a * INV127) if a > 0 else np.float32(1)
            q8s[r * qld:r * qld + hd] = _quant_r(x, _rcp_d(float(sq))).astype(
                np.int8).view(np.uint8)
            qsc_s[r] = scale * sq
        qf = []
        for kk in range(kks):
            lo = GID * qld + kk * 32 + 4 * TIG
            qf.append([_ld32(q8s, lo), _ld32(q8s, lo + 8 * qld), _ld32(q8s, lo + 16),
                       _ld32(q8s, lo + 8 * qld + 16)])
        qsc = [qsc_s[GID], qsc_s[GID + 8]]
        warps = []
        for w in range(4):  # scores of the warp's n-tiles, masked, row maxima
            tile_w = w * nt // 8
            has_k = tile_w * 64 < nvis
            acc = np.zeros((nt, 32, 4), np.int64)
            if has_k:
                for kk in range(kks):
                    for n in range(nt):
                        v = w * nt + n
                        addr = ks_off + (v >> 3) * tb + GID * gb + (v & 7) * hd + kk * 32 + 4 * TIG
                        _mma_s8(acc[n], qf[kk], _ld32(smem, addr), _ld32(smem, addr + 16))
            s = np.zeros((nt, 32, 4), np.float32)
            slots = np.zeros((nt, 32, 4), np.int64)
            for n in range(nt):
                v = w * nt + n
                for h in range(2):
                    qp = p0 + (rb + GID + 8 * h) // g
                    for e in range(2):
                        slot = (v >> 3) * 64 + 16 * TIG + 8 * e + (v & 7)
                        ok = has_k & (slot < nvis) & (j0 + slot <= qp)
                        sc = (acc[n, :, 2 * h + e].astype(np.float32) * qsc[h]) * sk[slot]
                        s[n, :, 2 * h + e] = np.where(ok, sc, MASK)
                        slots[n, :, 2 * h + e] = slot
            mx = [_row_max(np.maximum(s[:, :, 2 * h:2 * h + 2].max(axis=(0, 2)), MASK))
                  for h in range(2)]
            warps.append(dict(s=s, slots=slots, mx=mx))
        m = [np.max([w_["mx"][h] for w_ in warps], axis=0) for h in range(2)]
        for w_ in warps:  # p, its sums in the lane's order, p * sv, its maxima
            ls = [np.zeros(32, np.float32) for _ in range(2)]
            pmx = [np.zeros(32, np.float32) for _ in range(2)]
            for n in range(nt):
                for h in range(2):
                    for e in range(2):
                        c = 2 * h + e
                        p = np.exp((w_["s"][n, :, c] - m[h]).astype(np.float32))
                        ls[h] = (ls[h] + p).astype(np.float32)
                        psv = (p * sv[w_["slots"][n, :, c]]).astype(np.float32)
                        pmx[h] = np.maximum(pmx[h], psv)
                        w_["s"][n, :, c] = psv
            w_["ls"] = [_row_sum(x) for x in ls]
            w_["pmx"] = [_row_max(x) for x in pmx]
        sp, rsp, lsum = [], [], []
        for h in range(2):
            pmax = np.max([w_["pmx"][h] for w_ in warps], axis=0)
            sp.append(np.where(pmax > 0, (pmax * INV127).astype(np.float32), np.float32(1)))
            rsp.append(np.array([_rcp_d(float(v)) for v in sp[h]]))
            tot = warps[0]["ls"][h]
            for w_ in warps[1:]:  # in warp order
                tot = (tot + w_["ls"][h]).astype(np.float32)
            lsum.append(tot)
        for w, w_ in enumerate(warps):  # p8 into shared memory, words of two n-tiles
            for n in range(0, nt, 2):
                v = w * nt + n
                for h in range(2):
                    r = GID + 8 * h
                    q8 = [_quant_r(w_["s"][n + dn, :, 2 * h + e], rsp[h])
                          for dn in range(2) for e in range(2)]
                    q8 = np.where((rb + r < R)[:, None], np.stack(q8, axis=1), 0)  # pad rows: 0
                    addr = p_off + r * pld + (v >> 2) * 32 + (v & 2) * 8 + 4 * TIG
                    _st32(smem, addr, _word(q8))
        for h in range(2):  # the block's statistics, from warp 0's lanes
            r = rb + GID + 8 * h
            ok = r < R
            pm[r[ok]], pl[r[ok]] = m[h][ok], lsum[h][ok]
        pv = [np.zeros((ch, 2, 32, 4), np.int64) for _ in range(4)]
        for kst in range(2 * tiles):  # P V, each warp its columns
            tile, i0 = kst >> 1, (kst & 1) * 4
            if tile * 64 >= nvis:
                break
            a = _ldmatrix_x4(smem, p_off + ((LANE & 7) + 8 * ((LANE >> 3) & 1)) * pld
                             + kst * 32 + 16 * (LANE >> 4))
            for w in range(4):
                for c in range(ch):
                    r4 = _ldmatrix_x4(smem, vs_off + tile * tb + (LANE & 7) * gb
                                      + (i0 + (LANE >> 3)) * hd + (w * ch + c) * 16, trans=True)
                    for e, sel in enumerate((0x6420, 0x7531)):
                        _mma_s8(pv[w][c, e], a, _byte_perm(r4[0], r4[1], sel),
                                _byte_perm(r4[2], r4[3], sel))
        for w in range(4):
            for h in range(2):
                row = rb + GID + 8 * h
                ok = row < R
                for c in range(ch):
                    col = (w * ch + c) * 16 + 4 * TIG
                    o = pv[w][c]
                    for j, (e, cc) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
                        pacc[row[ok], col[ok] + j] = (o[e, ok, 2 * h + cc].astype(np.float32)
                                                      * sp[h][ok])
        # p8 back in slot order: byte e of the word at k 16 * half + 4 * tig
        # of k-step kst holds slot 64 * tile + 16 * tig + i0 + 2 * half + e
        # // 2 + 8 * (e % 2)
        rows = min(16, R - rb)
        pbytes = smem[p_off:p_off + 16 * pld].view(np.int8).reshape(16, pld)
        for kst in range(2 * tiles):
            for half in range(2):
                for tig in range(4):
                    for e in range(4):
                        slot = (64 * (kst >> 1) + 16 * tig + (kst & 1) * 4 + 2 * half + e // 2
                                + 8 * (e % 2))
                        p8_by_slot[rb:rb + rows, slot] = pbytes[:rows, kst * 32 + 16 * half
                                                                + 4 * tig + e]
    return pacc, pm, pl, p8_by_slot


def _cuda_core_block(qr, k8, v8, sk_all, sv_all, p0, t, g, si, sb, scale):
    """The CUDA-core form's p8 and P V partials of the same block: each
    (row, slot) and (row, column) on its own, the same f32 operations."""
    R, hd = qr.shape
    S = k8.shape[0]
    j0 = si * sb
    nvis = min(sb, min(p0 + t - 1, S - 1) - j0 + 1)
    a = np.abs(qr).max(axis=1)
    sq = np.where(a > 0, (a * INV127).astype(np.float32), np.float32(1))
    q8 = _quant(qr, sq[:, None]).astype(np.int64)
    sk = np.zeros(sb, np.float32)
    sv = np.zeros(sb, np.float32)
    sk[:nvis], sv[:nvis] = sk_all[j0:j0 + nvis], sv_all[j0:j0 + nvis]
    kb = np.zeros((sb, hd), np.int64)
    kb[:nvis] = k8[j0:j0 + nvis]
    acc = q8 @ kb.T
    qsc = (np.float32(scale) * sq).astype(np.float32)
    sc = (acc.astype(np.float32) * qsc[:, None]) * sk[None, :]
    slot = np.arange(sb)
    qp = p0 + np.arange(R) // g
    sc = np.where((slot[None] < nvis) & (j0 + slot[None] <= qp[:, None]), sc, MASK)
    m = np.maximum(sc.max(axis=1), MASK)
    psv = (np.exp((sc - m[:, None]).astype(np.float32)) * sv[None]).astype(np.float32)
    pmax = np.maximum(psv.max(axis=1), 0)
    sp = np.where(pmax > 0, (pmax * INV127).astype(np.float32), np.float32(1))
    p8 = _quant(psv, sp[:, None]).astype(np.int64)
    pv = (p8[:, :nvis] @ v8[j0:j0 + nvis].astype(np.int64)).astype(np.float32) * sp[:, None]
    return p8, pv, m


def emulate(q5, k8, v8, ks, vs, pos0, out_dtype="float32", seed=0, parent=None):
    """K4's tensor-core form and its merge pass, lane by lane: q5 [B, t, KV,
    g, hd] f32, the int8 cache [B, KV, S, hd], f32 scales [B, KV, S], pos0
    [B]. The workspace starts as NaN, so a merge that read a partial no
    block wrote gives NaN. With `parent` a list, each block's p8 and P V
    partials are held bit for bit against the CUDA-core form's and the
    count of blocks is appended. Returns q5's shape, rounded to out_dtype."""
    rng = np.random.default_rng(seed)
    B, t, KV, g, hd = q5.shape
    S = k8.shape[2]
    sb = attention._tpu_sb(S)
    nsb, R = S // sb, t * g
    scale = 1.0 / hd ** 0.5
    rows = q5.transpose(0, 2, 1, 3, 4).reshape(B, KV, R, hd)
    out = np.full((B, KV, R, hd), np.nan, np.float32)
    blocks = 0
    for b, kvh in np.ndindex(B, KV):
        p0 = int(pos0[b])
        last_blk = min((p0 + t - 1) // sb, nsb - 1)
        ws_o = np.full((nsb, R, hd), np.nan, np.float32)
        ws_m = np.full((nsb, R), np.nan, np.float32)
        ws_l = np.full((nsb, R), np.nan, np.float32)
        for si in range(last_blk + 1):  # later blocks return at once
            args = (rows[b, kvh], k8[b, kvh], v8[b, kvh], ks[b, kvh], vs[b, kvh], p0, t, g,
                    si, sb, scale)
            ws_o[si], ws_m[si], ws_l[si], p8 = _emulate_block(*args, rng)
            if parent is not None:
                want_p8, want_pv, want_m = _cuda_core_block(*args)
                np.testing.assert_array_equal(p8, want_p8)
                np.testing.assert_array_equal(ws_o[si], want_pv)
                np.testing.assert_array_equal(ws_m[si], want_m)
                blocks += 1
        for r in range(R):  # quant_merge: S-blocks in order, fmaf
            mx = np.max(np.append(ws_m[:last_blk + 1, r], MASK))
            num = np.zeros(hd, np.float32)
            den = np.float32(0)
            for si in range(last_blk + 1):
                w = np.exp((ws_m[si, r] - mx).astype(np.float32))
                num = (np.float64(w) * ws_o[si, r] + num).astype(np.float32)
                den = np.float32(np.float64(w) * ws_l[si, r] + den)
            out[b, kvh, r] = num / den
    if parent is not None:
        parent.append(blocks)
    got = torch.from_numpy(out).to(getattr(torch, out_dtype)).float().numpy()
    return got.reshape(B, KV, t, g, hd).transpose(0, 2, 1, 3, 4)


def _case(t, g, hd, s, fills, seed, bf16=False):
    """Inputs of one (batch row per fill, KV = 1) case: q [B, t, g, hd],
    the int8 cache and its f32 scales quantized as the cache writer does,
    pos0 so that the last row sees `fill` slots."""
    from llamago_tpu_torch.runtime.kv_cache import quantize_kv_rows

    rng = np.random.default_rng(seed)
    b = len(fills)
    q = rng.standard_normal((b, t, g, hd)).astype(np.float32)
    k8, ks = quantize_kv_rows(torch.from_numpy(rng.standard_normal((b, 1, s, hd))
                                               .astype(np.float32)))
    v8, vs = quantize_kv_rows(torch.from_numpy(rng.standard_normal((b, 1, s, hd))
                                               .astype(np.float32)))
    if bf16:  # q and the scale planes in bf16, widened to f32 as the kernel reads them
        q = torch.from_numpy(q).bfloat16().float().numpy()
        ks, vs = ks.bfloat16().float(), vs.bfloat16().float()
    pos0 = np.array([max(f - t, 0) for f in fills], np.int32)
    return q, k8.numpy(), v8.numpy(), ks.numpy(), vs.numpy(), pos0


def _plain(q, k8, v8, ks, vs, pos0, bf16):
    b, t, g, hd = q.shape
    dt = torch.bfloat16 if bf16 else torch.float32
    tq = torch.from_numpy(q).to(dt).reshape(b, t, 1, g, hd)
    tks, tvs = (torch.from_numpy(a).to(dt) for a in (ks, vs))
    out = attention.flash_attention_quant_i8dot_plain(
        tq, torch.from_numpy(k8), torch.from_numpy(v8), torch.from_numpy(pos0), tks, tvs)
    return out.float().numpy().reshape(q.shape)


def _jax(q, k8, v8, ks, vs, pos0, bf16, monkeypatch):
    monkeypatch.setattr(jkernels, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jattention, "_I8DOT", True)
    jattention._flash_attention_lenaware_quant.clear_cache()
    dt = jnp.bfloat16 if bf16 else jnp.float32
    b, t, g, hd = q.shape
    jq = jnp.asarray(q, dt).reshape(b, t, g, hd)
    positions = jnp.asarray(pos0[:, None] + np.arange(t, dtype=np.int32)[None])
    jk8, jv8 = jnp.asarray(k8), jnp.asarray(v8)
    jks, jvs = jnp.asarray(ks, dt), jnp.asarray(vs, dt)
    assert jattention.can_fuse_attention_quant(jq, jk8)
    try:
        out = jattention.flash_attention_quant(jq, jk8, jv8, positions, jks, jvs)
    finally:
        jattention._flash_attention_lenaware_quant.clear_cache()
    return np.asarray(out, np.float32).reshape(q.shape)


def _check(t, g, hd, s, fills, seed, monkeypatch, bf16=False, with_jax=True):
    q, k8, v8, ks, vs, pos0 = _case(t, g, hd, s, fills, seed, bf16)
    q5 = q.reshape(q.shape[0], t, 1, g, hd)
    parent = []
    got = emulate(q5, k8, v8, ks, vs, pos0, "bfloat16" if bf16 else "float32", seed,
                  parent).reshape(q.shape)
    assert np.isfinite(got).all()
    sb = attention._tpu_sb(s)
    # every block with a visible slot ran, and no other
    assert parent[0] == sum(min((int(p) + t - 1) // sb, s // sb - 1) + 1 for p in pos0)
    np.testing.assert_allclose(got, _plain(q, k8, v8, ks, vs, pos0, bf16), rtol=0,
                               atol=K4_TOL)
    if with_jax:
        np.testing.assert_allclose(got, _jax(q, k8, v8, ks, vs, pos0, bf16, monkeypatch),
                                   rtol=0, atol=K4_TOL)


S_EMU = 512  # two S-blocks of 256 (four tiles each)
FILL_SETS = [(1, 255, 256), (257, 300, S_EMU)]


@pytest.mark.parametrize("fills", FILL_SETS, ids=["fills1-256", "fills257-S"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("t", [1, 16, 32])
def test_lane_emulation_matches_plain_jax_and_the_cuda_core_form(t, g, hd, fills,
                                                                 monkeypatch):
    """The lanes' fragments, masks, requantization and merge give K4's
    function at fills on an S-block's edges (255, 256, 257), with p8 and
    the P V partials of every block equal to the CUDA-core form's."""
    _check(t, g, hd, S_EMU, fills, seed=t * 100 + g * 10 + hd + fills[0],
           monkeypatch=monkeypatch)


@pytest.mark.parametrize("s,fills", [(384, (1, 127, 129, 384)), (320, (63, 64, 65, 320))],
                         ids=["sb128", "sb64"])
@pytest.mark.parametrize("t,g", [(1, 8), (32, 1)])
def test_lane_emulation_with_s_blocks_of_two_and_one_tile(s, fills, t, g, monkeypatch):
    """S-blocks of 128 and 64 slots: the warps share the S-block's tiles
    (two warps a tile, or four)."""
    _check(t, g, 64, s, fills, seed=s + t + g, monkeypatch=monkeypatch)


@pytest.mark.parametrize("t,g,hd", [(1, 1, 128), (16, 8, 64), (32, 1, 128)])
def test_lane_emulation_with_bf16_q_and_scale_planes(t, g, hd, monkeypatch):
    """q in bf16 (the output rounded to bf16) and bf16 scale planes, widened
    to f32 as the kernel reads them."""
    _check(t, g, hd, S_EMU, (1, 256, 257, 400), seed=7 + t + g, monkeypatch=monkeypatch,
           bf16=True)


def test_lane_emulation_reads_nothing_it_did_not_write():
    """Stale shared memory (other seeds) and NaN workspaces change no bit of
    the output: unread K rows are masked, unread V rows meet p8 = 0."""
    q, k8, v8, ks, vs, pos0 = _case(4, 2, 64, S_EMU, (3, 200, 333), seed=11)
    q5 = q.reshape(3, 4, 1, 2, 64)
    first = emulate(q5, k8, v8, ks, vs, pos0, seed=1)
    np.testing.assert_array_equal(emulate(q5, k8, v8, ks, vs, pos0, seed=2), first)


def test_division_free_quant_is_the_ieee_quotient():
    """The kernel's quant_r(x, rcp_d(s)): rcp_d's three Newton steps take
    the seed to within 2^-51 of 1 / s, so x * rcp_d(s) in f64 is within
    2^-50 of x / s, and an f32 quotient lies at least 2^-49 from an f32
    midpoint: rounded to f32 it is x / s correctly rounded, and its rint
    and clip are the CUDA-core form's. The hardware's seed bits are not
    documented, so the steps also start from seeds up to 2^-16 off. Random
    rows at many scales, and quotients placed next to half-integers, where
    a wrong rounding would show."""
    rng = np.random.default_rng(0)
    m, per = 1 << 12, 1 << 8  # scales, values a scale
    n = m * per
    a = (rng.random(m) * 10 + 1e-3).astype(np.float32) * np.exp2(
        rng.integers(-60, 60, m)).astype(np.float32)
    s_m = (a * INV127).astype(np.float32)
    seed_err = np.where(np.arange(m) % 2, rng.uniform(-1, 1, m) * 2.0 ** -16, 0.0)
    rs_m = np.array([_rcp_d(float(v), float(e)) for v, e in zip(s_m, seed_err)])
    for v, r in zip(s_m, rs_m):
        assert abs(Fraction(float(v)) * Fraction(r) - 1) < Fraction(1, 2 ** 51), (v, r)
    s, rs = np.repeat(s_m, per), np.repeat(rs_m, per)
    near_half = ((rng.integers(-127, 127, n) + 0.5) * s).astype(np.float32)
    nudged = np.nextafter(near_half, rng.choice(np.array([-np.inf, np.inf], np.float32), n))
    assert nudged.dtype == np.float32 and (nudged != near_half).all()
    for x in ((rng.uniform(-1, 1, n) * np.repeat(a, per)).astype(np.float32), near_half,
              nudged):
        fast = (x.astype(np.float64) * rs).astype(np.float32)
        np.testing.assert_array_equal(fast, x / s)
        np.testing.assert_array_equal(_quant_r(x, rs), _quant(x, s))
