"""K1's and K6's tensor-core tile with f32 x ("f32_tc"): f32 x as three exact
bf16 parts, each weight fragment decoded once for all three, against the
plain versions and the JAX kernels on the CPU.

On the card K1 above 8 rows and K6 above `_W4X8_A8_MAX_M` rows take this
form for f32 x (`ops/kernels.py:k1_form`, `w4x8_form`): `split_x3`
(`csrc/tc_common.cuh`) writes x's three bf16 planes, hi + mid + lo == x,
into the front of the workspace; `dq_tc` / `w4x8_tc` with three parts then
run three mma against every B fragment they build from the raw weight
bytes, lo, then mid, then hi, into the same zeroed quant-block or group
sum, fold the scale once per block or group and write f32; `dq_reduce` /
`w4x8_reduce` add the splits of K in a fixed order. Here, without a card,
the tests pin the split bit for bit (a numpy copy of `split3`), the routes,
plans, form codes and C signatures, the shared memory of each template
instance, the launchers on meta tensors, and a numpy emulation of a warp's
fragments and order of sums against the plain versions and the JAX kernels
in interpret mode, in f32.
"""

import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch.ops import _build, kernels, quant

from test_torch_k1_decode_tc import GID, TIG, _bf16_bits, _byte_perm, _i8_pair, _mma, _q4_pair

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).parents[1] / "csrc"
# of max|ref|: exact parts and exact products, f32 sums in another order
F32_TOL = 1e-5
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for its blocks
SMEM_RESERVED = 1024  # bytes the card reserves for each resident block
SMEM_PER_BLOCK = 232448  # the most dynamic shared memory one block may opt into
# the 7B projections (K, N) chip_smoke times
SHAPES_7B = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32768)]


def _src(name: str) -> str:
    return (CSRC / name).read_text()


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def wide_x(m: int, k: int, seed: int) -> np.ndarray:
    """f32 x whose rows span many binades and use all 24 bits of the
    significand: a bf16 x would not do."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * 2.0 ** rng.integers(-12, 12, (m, 1))
    return (x * (1 + rng.random((m, k)) * 2.0 ** -9)).astype(np.float32)


# ---------------------------------------------------------------- the split

def split3(x: np.ndarray) -> np.ndarray:
    """`split3` of csrc/tc_common.cuh in numpy: f32 x -> uint16 [3, ...], the
    bf16 bits of hi, mid and lo. hi and mid are truncations (the top 16 bits
    of x, then of x - hi), lo = bf16(x - hi - mid) rounded to nearest even;
    an inf or NaN goes whole into hi (bf16's quiet bit added where a NaN's
    payload lies only in the low 16 bits), mid = lo = 0."""
    x = np.asarray(x, np.float32)
    u = x.view(np.uint32)
    special = (u & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    with np.errstate(invalid="ignore", over="ignore"):
        r = x - (u & np.uint32(0xFFFF0000)).view(np.float32)
        ru = r.view(np.uint32)
        low = r - (ru & np.uint32(0xFFFF0000)).view(np.float32)
    quiet = np.where((u & np.uint32(0xFFFF)) != 0, np.uint32(0x40), np.uint32(0))
    hi = np.where(special, (u >> np.uint32(16)) | quiet, u >> np.uint32(16))
    mid = np.where(special, np.uint32(0), ru >> np.uint32(16))
    lo = np.where(special, np.uint32(0), _bf16_bits(np.where(special, 0, low)))
    return np.stack([hi, mid, lo]).astype(np.uint16)


def parts_value(parts: np.ndarray) -> np.ndarray:
    """The three bf16 parts as f32 values, [3, ...]."""
    return (parts.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _exact_sum(parts: np.ndarray) -> np.ndarray:
    """hi + mid + lo in f64 (no rounding: every part fits in f32's range and
    their bits do not overlap), as f32."""
    v = parts_value(parts).astype(np.float64)
    return (v[0] + v[1] + v[2]).astype(np.float32)


def test_split_is_exact_for_random_f32():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 400_000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    e = (bits >> np.uint32(23)) & np.uint32(0xFF)
    # normal x whose low part stays in bf16's range (ulp at least 2^-133)
    x = x[(e >= 127 - 110) & (e < 255)]
    parts = split3(x)
    assert np.array_equal(_exact_sum(parts).view(np.uint32), x.view(np.uint32))
    # every part is a bf16 value with at most 8 significant bits: its
    # product with an int8 or int4 weight is exact in f32
    v = parts_value(parts)
    assert np.isfinite(v).all()
    assert np.array_equal((v.view(np.uint32) & np.uint32(0xFFFF)), np.zeros_like(v, np.uint32))
    # hi and mid are truncations: |part| never rounds up past what is left
    assert (np.abs(v[0]) <= np.abs(x)).all()
    assert (np.abs(v[1]) <= np.abs(x - v[0])).all()


def test_split_near_f32s_maximum_does_not_overflow():
    big = np.float32(np.finfo(np.float32).max)
    x = np.array([big, -big, np.nextafter(big, np.float32(0)), np.float32(3.3e38),
                  np.float32(-1.7014118e38), np.float32(2.0 ** 127) * np.float32(1.99999988)],
                 np.float32)
    parts = split3(x)
    v = parts_value(parts)
    assert np.isfinite(v).all()  # rounding x's top 16 bits up would give inf
    assert np.array_equal(_exact_sum(parts).view(np.uint32), x.view(np.uint32))
    assert parts[0, 0] == 0x7F7F  # the largest finite bf16


def test_split_near_f32s_minimum_normal():
    """Exact while x's ulp is at least bf16's smallest subnormal (|x| >=
    2^-110); below that, down to the minimum normal, only lo's rounding to
    bf16's subnormal grid is lost (at most half of 2^-133)."""
    rng = np.random.default_rng(1)
    tiny = np.float32(2.0 ** -126)
    ulps = rng.integers(0, 2**23, 20_000).astype(np.float32)
    exact = (np.float32(2.0 ** -110) * (1 + ulps / np.float32(2**23))).astype(np.float32)
    assert np.array_equal(_exact_sum(split3(exact)).view(np.uint32), exact.view(np.uint32))
    assert np.array_equal(_exact_sum(split3(np.array([tiny, -tiny]))),
                          np.array([tiny, -tiny]))
    near = np.concatenate([tiny * (1 + ulps / np.float32(2**23)),
                           np.float32(2.0 ** -115) * (1 + ulps / np.float32(2**23))])
    near = near.astype(np.float32)
    parts = split3(near)
    err = np.abs(_exact_sum(parts).astype(np.float64) - near.astype(np.float64))
    assert (err <= 2.0 ** -134).all() and err.max() > 0


def test_split_of_zeros_infinities_and_nans():
    specials = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00000, 0x7F800001, 0xFF80FFFF, 0x7F812345, 0x7F8F0000],
                        np.uint32)
    x = specials.view(np.float32)
    parts = split3(x)
    hi = parts_value(parts)[0]
    assert parts[0, 0] == 0x0000 and parts[0, 1] == 0x8000  # +0 and -0 keep their sign
    assert np.array_equal(hi[2:4], x[2:4])  # +-inf
    assert np.isnan(hi[4:]).all()  # a NaN stays a NaN, payload in the low bits too
    assert not parts[1:].any()  # mid = lo = 0
    # -0 widens to a zero sum: its products are zeros of either sign
    assert _exact_sum(parts[:, :2]).tolist() == [0, 0]


def test_split_in_the_source_is_the_numpy_copy():
    """The CUDA split3 and split_x3 do what split3 above emulates."""
    src = _src("tc_common.cuh")
    body = src.split("__device__ __forceinline__ uint3 split3(float x) {")[1].split("\n}\n")[0]
    for line in ("if ((u & 0x7F800000u) == 0x7F800000u)",
                 "return make_uint3((u >> 16) | ((u & 0xFFFFu) ? 0x40u : 0u), 0u, 0u);",
                 "const float r = x - __uint_as_float(u & 0xFFFF0000u);",
                 "const float l = r - __uint_as_float(ru & 0xFFFF0000u);",
                 "__float2bfloat16_rn(l)"):
        assert line in body, line
    kernel = src.split("split_x3(const float* __restrict__ x,")[1]
    for line in ("*reinterpret_cast<uint2*>(p) = make_uint2(a.x | (b.x << 16), c.x | (d.x << 16));",
                 "*reinterpret_cast<uint2*>(p + n) = make_uint2(a.y | (b.y << 16),",
                 "*reinterpret_cast<uint2*>(p + 2 * n) = make_uint2(a.z | (b.z << 16),"):
        assert line in kernel, line


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("m", [9, 16, 17, 32, 64, 100, 256])
def test_f32_x_above_the_decode_rows_takes_the_new_form(m):
    assert kernels.k1_form(m, torch.float32) == "f32_tc"
    assert kernels.k1_form(m, torch.bfloat16) == "tensor_core"
    want = "a8" if m <= kernels._W4X8_A8_MAX_M else "f32_tc"
    assert kernels.w4x8_form(m, torch.float32) == want


def test_the_old_f32_tiles_are_gone():
    """`dq_tiled` and `w4x8_stream` and their form code went with the new
    form: code 1 is the tile on x's three parts in both entry points."""
    assert "tiled_f32" not in (*kernels.K1_FORMS, *kernels.W4X8_FORMS)
    for name, gone in (("dequant_matmul.cu", "dq_tiled"), ("w4x8_matmul.cu", "w4x8_stream<")):
        assert gone not in _src(name)
    assert re.search(r"enum Form \{ kF32Tc = (\d), kTensorCore = 2, kDecodeTc = 3,",
                     _src("dequant_matmul.cu")).group(1) == str(kernels.K1_FORMS["f32_tc"])
    assert re.search(r"enum W4x8Form \{ kA8 = 0, kF32Tc = (\d), kTensorCore = 2 \}",
                     _src("w4x8_matmul.cu")).group(1) == str(kernels.W4X8_FORMS.index("f32_tc"))


# ------------------------------------------------------------- the plans

def _covers(units: int, ksplit: int, per: int) -> None:
    spans = [(y * per, min((y + 1) * per, units)) for y in range(ksplit)]
    assert all(a < b for a, b in spans) and spans[-1][1] == units


@pytest.mark.parametrize("m", [9, 17, 64, 100, 256])
@pytest.mark.parametrize("k,n", SHAPES_7B + [(32, 16), (1376, 512), (512, 4000)])
def test_k1_plan_splits_whole_quant_blocks_into_one_wave(m, k, n):
    form, ksplit, ws = kernels.k1_plan(m, k, n, torch.float32)
    nb = k // 32
    per = -(-nb // ksplit)
    assert form == "f32_tc" and ksplit == -(-nb // per)
    _covers(nb, ksplit, per)
    tiles = -(-n // 128) * -(-m // 64)
    if ksplit > 1:
        assert tiles < 264 and per >= 8  # split only under two blocks an SM
        assert tiles * (ksplit - 1) < 3 * 132  # no split past one wave of three
    # x's three bf16 planes first, then the partials when it splits K
    assert ws == 3 * m * k // 2 + (ksplit * m * n if ksplit > 1 else 0)
    assert ws == kernels.f32_tc_workspace(m, k, n, ksplit)


@pytest.mark.parametrize("m", [17, 33, 64, 100, 256])
@pytest.mark.parametrize("k,n", [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
                                 (4096, 32000), (128, 16), (384, 4000)])
def test_w4x8_plan_splits_whole_groups_over_32_row_tiles(m, k, n):
    form, ksplit, ws = kernels.w4x8_plan(m, k, n, torch.float32)
    groups = k // 128
    per = -(-groups // ksplit)
    assert form == "f32_tc" and ksplit == -(-groups // per)
    _covers(groups, ksplit, per)
    tiles = -(-n // 128) * -(-m // 32)  # three planes of 32 rows a block
    if ksplit > 1:
        assert tiles < 264 and per >= 2
        assert tiles * (ksplit - 1) < 3 * 132
    else:
        assert tiles >= 264 or groups < 4 or -(-3 * 132 // tiles) < 2
    assert ws == kernels.f32_tc_workspace(m, k, n, ksplit)


def test_plans_at_the_7b_prefill_rows():
    # 96 column strips at m = 64: K1 five splits of 64-row tiles, K6 three
    # of 32-row tiles (two a strip); one wave of three blocks an SM
    assert kernels.k1_plan(64, 4096, 12288, torch.float32)[:2] == ("f32_tc", 5)
    assert kernels.w4x8_plan(64, 4096, 12288, torch.float32)[:2] == ("f32_tc", 3)
    assert kernels.k1_plan(256, 4096, 12288, torch.float32)[:2] == ("f32_tc", 1)
    assert kernels.w4x8_plan(256, 4096, 12288, torch.float32)[:2] == ("f32_tc", 1)


# ---------------------------------------------------------------- the C side

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}


@pytest.mark.parametrize("source,name,lib_fn", [
    ("dequant_matmul.cu", "llamago_dequant_matmul", "_lib"),
    ("w4x8_matmul.cu", "llamago_w4x8_matmul_stream", "_lib_w4x8")])
def test_entry_points_match_the_argtypes(monkeypatch, source, name, lib_fn):
    class Lib:
        pass

    for fn in ("llamago_dequant_matmul", "llamago_w4x8_quantize_x", "llamago_w4x8_matmul_a8",
               "llamago_w4x8_matmul_stream"):
        setattr(Lib, fn, type("Fn", (), {})())
    monkeypatch.setattr(_build, "library", lambda _: Lib)
    got = getattr(kernels, lib_fn).__wrapped__()
    fn = got if lib_fn == "_lib" else getattr(got, name)
    sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', _src(source))
    params = [p.split() for p in sig.group(1).split(",")]
    assert "ws" in [p[-1] for p in params]
    assert fn.argtypes == [_C_TYPES[" ".join(p[:-1])] for p in params]
    assert fn.restype is ctypes.c_int


def test_entry_points_refuse_what_the_form_cannot_take():
    """Form 1 takes f32 x only and always needs the workspace (x's planes);
    the bf16 forms take bf16 x only."""
    k1 = _src("dequant_matmul.cu").split('extern "C" int llamago_dequant_matmul(')[1]
    assert "const bool bf16_form = form == kTensorCore || form == kDecodeTc;" in k1
    assert "bf16_form != (x_bf16 != 0)" in k1
    assert "((ksplit > 1 || form == kF32Tc) && w == nullptr)" in k1
    k6 = _src("w4x8_matmul.cu").split('extern "C" int llamago_w4x8_matmul_stream(')[1]
    assert "(form == kTensorCore) != (x_bf16 != 0)" in k6
    assert "((ksplit > 1 || form == kF32Tc) && w == nullptr)" in k6
    # the planes lie at the front of the workspace, the partials after them
    for src in (_src("dequant_matmul.cu"), k6):
        assert "split_x3<<<(unsigned)((mk / 4 + 255) / 256), 256, 0, st>>>" in src
        assert "mk * 3 / 2" in src


# ------------------------------------------------------ shared memory

def _k1_stage(mt: int, bits: int, scale_bytes: int, parts: int) -> int:
    w_rows = 32 if bits == 8 else 16
    return w_rows * (128 + 16) + 128 * scale_bytes + parts * 16 * mt * (32 + 8) * 2


def _k6_stage(mt: int, parts: int) -> int:
    return 64 * (128 + 32) + 128 * 2 + parts * 16 * mt * (128 + 8) * 2


def test_the_layout_constants_are_the_sources():
    k1 = _src("tile_tc.cuh") + _src("dequant_matmul.cu")
    for line in ("constexpr int kTcWLd = kTcCols + 16;", "constexpr int kTcXLd = 32 + 8;",
                 "return PARTS == 1 ? 4 : 3;",
                 "return PARTS == 3 && MT == 2 ? 3 : 0;",
                 "__launch_bounds__(kTcThreads, tc_min_blocks<MT, PARTS>())\n    dq_tc(",
                 "return tc_w_rows<BITS>() * kTcWLd + kTcCols * (int)sizeof(ST) + PARTS * 16 * MT"
                 " * kTcXLd * 2;"):
        assert line in k1, line
    k6 = _src("w4x8_matmul.cu")
    for line in ("constexpr int kTcStages = 2;", "constexpr int kTcWLd = kTcCols + 32;",
                 "constexpr int kTcXLd = kGroup + 8;",
                 "return kTcWRows * kTcWLd + kTcCols * 2 + PARTS * 16 * MT * kTcXLd * 2;",
                 "return launch_tc_rows<2, 3>(x, qq, ss, out, ws, M, K, N, ksplit, st);"):
        assert line in k6, line


@pytest.mark.parametrize("mt", [1, 2, 4])
@pytest.mark.parametrize("bits,scale_bytes", [(8, 4), (8, 2), (4, 4), (4, 2)])
def test_k1_three_planes_leave_three_blocks_an_sm(mt, bits, scale_bytes):
    """Shared memory leaves three blocks an SM at every row tiling (at 64
    rows 168 registers with f32 scales leave three too, 224 with bf16
    scales two: ptxas's counts, not checked here; 32-row blocks ask the
    launch bounds for three)."""
    smem = 3 * _k1_stage(mt, bits, scale_bytes, 3)
    assert smem <= SMEM_PER_BLOCK
    assert 3 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    assert smem % 16 == 0 and _k1_stage(mt, bits, scale_bytes, 3) % 16 == 0
    # bf16 x keeps its four stages under the default 48 KB
    assert 4 * _k1_stage(mt, bits, scale_bytes, 1) <= 48 * 1024


@pytest.mark.parametrize("mt", [1, 2])
def test_k6_three_planes_take_32_rows_for_three_blocks_an_sm(mt):
    smem = 2 * _k6_stage(mt, 3)
    assert 3 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    # 64 rows of three planes would leave one block an SM
    assert 2 * (2 * _k6_stage(4, 3) + SMEM_RESERVED) > SMEM_PER_SM


# ---------------------------------------------------- the launchers

class _FakeK1:
    def __init__(self):
        self.calls = []

    def __call__(self, x, q, s, out, ws, m, k, n, bits, x_bf16, s_bf16, form, ksplit, stream):
        self.calls.append(dict(m=m, k=k, n=n, bits=bits, x_bf16=x_bf16, form=form,
                               ksplit=ksplit))
        return 0


class _FakeK6:
    def __init__(self):
        self.calls = []

    def llamago_w4x8_matmul_stream(self, x, q, s, out, ws, m, k, n, x_bf16, form, ksplit,
                                   stream):
        self.calls.append(dict(m=m, k=k, n=n, x_bf16=x_bf16, form=form, ksplit=ksplit))
        return 0


def _on_meta(monkeypatch, lib_attr, fake, x, w) -> list[int]:
    """Call dequant_matmul on meta tensors with the C entry point, the stream
    and the argument checks stubbed; returns the f32 workspaces allocated."""
    for wrapper in (kernels.dequant_matmul, kernels.w4x8_matmul):
        for attr in [a for a in vars(wrapper) if a.startswith("launches")]:
            monkeypatch.setattr(wrapper, attr, 0)
    monkeypatch.setattr(kernels, lib_attr, lambda: fake)
    monkeypatch.setattr(kernels, "_cuda_or_raise", lambda x, what: None)
    monkeypatch.setattr(kernels, "_check_cuda_args", lambda *a, **kw: None)
    monkeypatch.setattr(kernels, "_stream", lambda x2: 0)
    spaces = []
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        if t.dim() == 1 and t.dtype == torch.float32:
            spaces.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", spy)
    out = kernels.dequant_matmul(x, w)
    assert out.shape == (x.shape[0], w["s"].shape[1]) and out.dtype == x.dtype
    return spaces


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [9, 64, 256])
def test_k1_launcher_hands_the_form_its_plan_and_workspace(monkeypatch, m, bits):
    meta = torch.device("meta")
    k, n = 4096, 12288
    key = "q8" if bits == 8 else "q4"
    w = {key: torch.empty((k if bits == 8 else k // 2, n),
                          dtype=torch.int8 if bits == 8 else torch.uint8, device=meta),
         "s": torch.empty((k // 32, n), dtype=torch.float32, device=meta)}
    fake = _FakeK1()
    x = torch.empty((m, k), dtype=torch.float32, device=meta)
    spaces = _on_meta(monkeypatch, "_lib", fake, x, w)
    _, ksplit, ws = kernels.k1_plan(m, k, n, torch.float32)
    assert fake.calls == [dict(m=m, k=k, n=n, bits=bits, x_bf16=0, form=1, ksplit=ksplit)]
    assert spaces == [ws]
    fn = kernels.dequant_matmul
    assert (fn.launches_f32_tc, fn.launches_tc, fn.launches_decode_tc) == (1, 0, 0)
    assert (fn.launches, fn.launches_q4) == ((1, 0) if bits == 8 else (0, 1))


@pytest.mark.parametrize("m", [17, 64, 256])
def test_k6_launcher_hands_the_form_its_plan_and_workspace(monkeypatch, m):
    meta = torch.device("meta")
    k, n = 4096, 12288
    w = {"q4x": torch.empty((k // 2, n), dtype=torch.uint8, device=meta),
         "s": torch.empty((k // 64, n), dtype=torch.bfloat16, device=meta)}
    fake = _FakeK6()
    x = torch.empty((m, k), dtype=torch.float32, device=meta)
    spaces = _on_meta(monkeypatch, "_lib_w4x8", fake, x, w)
    _, ksplit, ws = kernels.w4x8_plan(m, k, n, torch.float32)
    assert fake.calls == [dict(m=m, k=k, n=n, x_bf16=0, form=1, ksplit=ksplit)]
    assert spaces == [ws]
    fn = kernels.w4x8_matmul
    assert (fn.launches_stream, fn.launches_f32_tc, fn.launches_tc, fn.launches_a8) == (1, 1,
                                                                                       0, 0)


# ------------------------------------------------------- the warps' lanes

def _word(stage: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Each lane's 32-bit shared-memory read: bytes cols .. cols+3 of its
    stage row, little-endian."""
    b = stage[rows[:, None], cols[:, None] + np.arange(4)[None]]
    return np.ascontiguousarray(b).view(np.uint32)[:, 0]


def _a_frag(plane: np.ndarray, rows: np.ndarray, k0: int) -> list:
    """ldmatrix_x4 of 16 rows of a bf16 plane at k0 .. k0+15, as each lane's
    four A registers: (row gid | gid+8, k 2*tig+{0,1} | +8)."""
    def pair(r, kk):
        return (plane[rows[r], k0 + kk].astype(np.uint32)
                | (plane[rows[r], k0 + kk + 1].astype(np.uint32) << np.uint32(16)))
    return [pair(GID, 2 * TIG), pair(GID + 8, 2 * TIG), pair(GID, 2 * TIG + 8),
            pair(GID + 8, 2 * TIG + 8)]


def _w4_pairs(w: np.ndarray) -> list:
    """`w4_pairs` of csrc/w4x8_matmul.cu: the four bytes of a packed word as
    four bf16 pairs (row 2r in the low half), exactly: (nibble ^ 8) + 128
    less 136."""
    h = w >> np.uint32(4)
    out = []
    for j in range(4):
        t = _byte_perm(w, h, j | ((4 + j) << 8))
        v = (t & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
        lo = (v << np.uint32(16)).view(np.float32) - np.float32(136)
        hi = (v & np.uint32(0xFFFF0000)).view(np.float32) - np.float32(136)
        out.append(_bf16_bits(lo) | (_bf16_bits(hi) << np.uint32(16)))
    return out


def _fold(acc, part, sc):
    """acc = fmaf(scale, part, acc) per C register: c0 / c2 of tile j are
    column 8*tig + j, c1 / c3 column 8*tig + 4 + j."""
    for j in range(4):
        for e, col in ((0, j), (1, 4 + j), (2, j), (3, 4 + j)):
            acc[:, j, e] = (sc[:, col].astype(np.float64) * part[:, j, e]
                            + acc[:, j, e]).astype(np.float32)


def _store(res, acc, i, warp):
    """A warp's m16 tile i into the block's [rows, 128] result, as the
    epilogue writes it: row i*16 + gid + 8h, columns 32*warp + 8*tig + 0..7."""
    for h in range(2):
        for j in range(4):
            res[i * 16 + GID + 8 * h, 32 * warp + 8 * TIG + j] = acc[:, j, 2 * h]
            res[i * 16 + GID + 8 * h, 32 * warp + 8 * TIG + 4 + j] = acc[:, j, 2 * h + 1]


def _b_frags(stage, cols, t, w4x8, wrows):
    """The B pairs of k16 step t of a stage for every lane: b0[j] / b1[j]
    hold rows 16t + 2*tig + {0, 1} / + {8, 9} of n8 tile j (column 4*gid +
    j of the warp's 32)."""
    if w4x8:  # packed rows 8t + tig and 8t + tig + 4: rows 2r, 2r + 1
        return (_w4_pairs(_word(stage, 8 * t + TIG, cols)),
                _w4_pairs(_word(stage, 8 * t + TIG + 4, cols)))
    if wrows == 32:  # int8 rows, each byte XORed with 0x80
        r = 16 * t + 2 * TIG
        w = [_word(stage, r + d, cols) ^ np.uint32(0x80808080) for d in (0, 1, 8, 9)]
        return ([_i8_pair(j, w[0], w[1]) for j in range(4)],
                [_i8_pair(j, w[2], w[3]) for j in range(4)])
    # packed Q4_0 row r: row r in the low nibbles (step 0), r + 16 high (1)
    w = [_word(stage, 2 * TIG + d, cols) for d in (0, 1, 8, 9)]
    sh = 4 * t
    return ([_q4_pair(j, sh, w[0], w[1]) for j in range(4)],
            [_q4_pair(j, sh, w[2], w[3]) for j in range(4)])


def emulate_f32_tc(x: np.ndarray, leaf: dict, rng) -> np.ndarray:
    """The tile with f32 x, warp by warp over every lane, in numpy: x's three
    planes (split3), the stage a block's copies fill (the weight bytes of
    its 128 columns, garbage past N; x's rows past M repeat row M-1), each
    lane's 32-bit reads and the B pairs its builders make of them (bit for
    bit), the A fragments ldmatrix gives of each plane, three mma a B
    fragment (lo, mid, hi) into the zeroed quant-block (K1) or group (K6)
    sum, the scale folded once, the epilogue's placement and the reduce's
    fixed-order sum of the splits. Returns f32 [M, N]."""
    m, k = x.shape
    w4x8 = "q4x" in leaf
    if w4x8:
        q, unit, wrows = leaf["q4x"].numpy(), 128, 64
        s = leaf["s"][0::2].float().numpy()  # group g's scale row is 2g
        mt = 1 if m <= 16 else 2
        form, ksplit, _ = kernels.w4x8_plan(m, k, q.shape[1], torch.float32)
    else:
        bits = 8 if "q8" in leaf else 4
        q = leaf["q8"].numpy().view(np.uint8) if bits == 8 else leaf["q4"].numpy()
        unit, wrows = 32, 32 if bits == 8 else 16
        s = leaf["s"].float().numpy()
        mt = 1 if m <= 16 else 2 if m <= 32 else 4
        form, ksplit, _ = kernels.k1_plan(m, k, q.shape[1], torch.float32)
    assert form == "f32_tc"
    n = q.shape[1]
    ncols = -(-n // 128) * 128
    qpad = np.concatenate([q, rng.integers(0, 256, (q.shape[0], ncols - n), np.uint8)], 1)
    spad = np.concatenate([s, rng.standard_normal((s.shape[0], ncols - n)).astype(np.float32)],
                          1)
    planes = split3(x)
    bm, units = 16 * mt, k // unit
    per = -(-units // ksplit)
    out = np.zeros((m, ncols), np.float32)
    for n0 in range(0, ncols, 128):
        for m0 in range(0, m, bm):
            rows = [np.minimum(m0 + 16 * i + np.arange(16), m - 1) for i in range(mt)]
            total = None
            for y in range(ksplit):
                res = np.zeros((bm, 128), np.float32)
                for warp in range(4):
                    cols = 32 * warp + 4 * GID  # a lane's 4 columns of the strip
                    acc = np.zeros((mt, 32, 4, 4), np.float32)
                    for u in range(y * per, min((y + 1) * per, units)):
                        stage = qpad[u * wrows:(u + 1) * wrows, n0:n0 + 128]
                        part = np.zeros((mt, 32, 4, 4), np.float32)
                        for t in range(unit // 16):
                            b0, b1 = _b_frags(stage, cols, t, w4x8, wrows)
                            for i in range(mt):
                                for p in (2, 1, 0):  # lo, mid, hi
                                    a = _a_frag(planes[p], rows[i], u * unit + 16 * t)
                                    for j in range(4):
                                        _mma(part[i][:, j], a, b0[j], b1[j])
                        sc = spad[u, n0 + 32 * warp + 8 * TIG[:, None] + np.arange(8)[None]]
                        for i in range(mt):
                            _fold(acc[i], part[i], sc)
                    for i in range(mt):
                        _store(res, acc[i], i, warp)
                # the reduce: 0 + the first partial + the next ..., in order
                total = res if total is None else total + res
            valid = min(bm, m - m0)
            out[m0:m0 + valid, n0:n0 + 128] = total[:valid]
    return out[:, :n]


def _jax(x: np.ndarray, jleaf: dict) -> np.ndarray:
    """The JAX K1 / w4x8 matmul in interpret mode with f32 x, as f32."""
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    try:
        xj = jnp.asarray(x, jnp.float32)
        assert jkernels.can_fuse(xj, jleaf)
        return np.asarray(jkernels.dequant_matmul(xj, jleaf), np.float32)
    finally:
        jkernels.FORCE_INTERPRET = old


def _leaf(fmt: str, k: int, n: int, seed: int):
    """A port leaf and the same numbers as a JAX leaf: "q8" / "q4" with f32
    or bf16 scales ("q8:bfloat16"), or "q4x" (w4x8)."""
    w = torch.from_numpy(rnd((k, n), seed, 0.1))
    if fmt == "q4x":
        leaf = quant.quantize_w4x8(w)
        return leaf, {"q4x": jnp.asarray(leaf["q4x"].numpy()),
                      "s": jnp.asarray(leaf["s"].float().numpy(), jnp.bfloat16)}
    key, sdt = fmt.split(":")
    leaf = quant.quantize(w, 8 if key == "q8" else 4)
    leaf["s"] = leaf["s"].to(getattr(torch, sdt))
    return leaf, {key: jnp.asarray(leaf[key].numpy()),
                  "s": jnp.asarray(leaf["s"].float().numpy(), sdt)}


FMTS = ["q8:float32", "q8:bfloat16", "q4:float32", "q4:bfloat16", "q4x"]


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("m", [9, 17, 64, 100])
def test_emulated_lanes_match_plain_and_jax(monkeypatch, m, fmt):
    """The three parts, the fragments and the order of sums at K = 512 (K
    split in two), N = 256 (two column strips), against the plain version
    and the JAX kernel in interpret mode, both in f32. w4x8 at m = 9 takes
    K5 by default: there the threshold is lowered, and JAX, whose launcher
    takes its decode kernel at that size, is left out."""
    k, n = 512, 256
    if fmt == "q4x" and m <= kernels._W4X8_A8_MAX_M:
        monkeypatch.setattr(kernels, "_W4X8_A8_MAX_M", 8)
    leaf, jleaf = _leaf(fmt, k, n, 100 + m)
    x = wide_x(m, k, 200 + m)
    plan = (kernels.w4x8_plan if fmt == "q4x" else kernels.k1_plan)(m, k, n, torch.float32)
    assert plan[:2] == ("f32_tc", 2)  # the splits' reduce is exercised
    got = emulate_f32_tc(x, leaf, np.random.default_rng(m))
    plain = kernels.dequant_matmul(torch.from_numpy(x), leaf).numpy()  # the CPU: plain
    scale = np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=F32_TOL * scale)
    if not (fmt == "q4x" and m <= 16):
        want = _jax(x, jleaf)
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * scale)


@pytest.mark.parametrize("bits", [8, 4])
def test_emulated_lanes_at_a_ragged_width_and_the_small_models_k(bits):
    """Columns past N (garbage in the stage, never stored) and K = 1376 (43
    quant blocks, the small model's w2) in one split, against the plain
    version."""
    k, n, m = 1376, 272, 40
    leaf, _ = _leaf(f"q{bits}:float32", k, n, 7)
    x = wide_x(m, k, 8)
    got = emulate_f32_tc(x, leaf, np.random.default_rng(9))
    want = kernels.dequant_matmul_plain(torch.from_numpy(x), leaf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


def test_three_parts_are_needed():
    """hi alone (x rounded down to bf16) misses the f32 function by far more
    than the tolerance; hi + mid + lo meets it."""
    k, n, m = 512, 128, 17
    leaf, _ = _leaf("q8:float32", k, n, 11)
    x = wide_x(m, k, 12)
    want = kernels.dequant_matmul_plain(torch.from_numpy(x), leaf).numpy()
    dq = quant.dequantize(leaf, torch.float32).numpy().astype(np.float64)
    v = parts_value(split3(x)).astype(np.float64)
    scale = np.abs(want).max()
    assert np.abs(v[0] @ dq - want).max() > 100 * F32_TOL * scale
    assert np.abs((v[0] + v[1] + v[2]) @ dq - want).max() <= F32_TOL * scale
