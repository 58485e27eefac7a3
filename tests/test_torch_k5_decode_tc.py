"""K5, the W4A8 decode matmul, on the int8 tensor-core decode form: its
route, its split of K, the C entry points it is handed, its shared memory,
and a numpy emulation of its lanes, against the plain version and the JAX
kernel in interpret mode.

On the card a w4x8 matmul of at most `_W4X8_A8_MAX_M` rows (16) takes
`w4x8_a8_tc` (`ops/kernels.py:w4x8_form`, `a8_split_for`,
`csrc/w4x8_matmul.cu`) for f32 and bf16 x alike: x is quantized to int8 per
(row, 128-group) by `w4x8_quant_x` (the plain version's rounding, sx laid
out [groups, slots] for the matmul), then the form of
`csrc/decode_i8_tc.cuh` in its int4 format multiplies: the packed weights
are the A operand of int8 mma.sync.m16n8k32, each nibble as 16 times its
value (the exact int32 sum is shifted back), the slots are B (one n8 tile
up to 8 rows, two up to 16), each 128-row group's sum is folded with
sx * s in f32, and `w4x8_reduce` adds the splits of K in order. Here,
without a card, the wrapper takes the plain version; the tests pin the
route, the plan, the C signatures and the names chip_smoke's profile reads,
the shared memory, the launcher on meta tensors, and the emulated lanes
(tests/test_torch_lab_i8tc.py `emulate_i8tc`) against the plain version
and JAX's `_w4x8_matmul_2d` in interpret mode.
"""

import contextlib
import ctypes
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch.ops import _build, kernels, quant

from test_torch_lab_i8tc import I4, X_ROWS, _it_layout, emulate_i8tc, reduce_in_order

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "llamago_tpu_torch" / "csrc"
F32_TOL = 1e-5  # of max|ref|: the same exact integer dots, f32 sums in another order
BF16_TOL = 8e-3  # of max|ref|: one bf16 rounding of the output
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for its blocks
SMEM_RESERVED = 1024  # bytes the card reserves for each resident block
# the five 7B int4 shapes of chip_smoke (K, N)
SHAPES_7B = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)]


def _src(name="w4x8_matmul.cu") -> str:
    return (CSRC / name).read_text()


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("m", range(1, 17))
def test_every_decode_row_count_takes_k5_in_both_dtypes(m):
    """x is quantized to int8 either way, so f32 and bf16 x take the one form."""
    for dt in (torch.float32, torch.bfloat16):
        assert kernels.w4x8_form(m, dt) == "a8"


def test_more_rows_take_k6():
    assert kernels.w4x8_form(17, torch.bfloat16) == "tensor_core"
    assert kernels.w4x8_form(17, torch.float32) == "f32_tc"


def test_the_old_form_is_gone():
    """`w4x8_a8` (the __dp4a GEMV) and its column rule are deleted; the one
    K5 kernel is the tensor-core decode form."""
    src = _src()
    assert "w4x8_a8<" not in src and "__dp4a" not in src and "launch_a8<" not in src
    assert not hasattr(kernels, "a8_cols_per_thread") and not hasattr(kernels, "_A8_WARPS")
    assert "decode_i8tc_body<kItI4, NT>(a)" in src
    assert "__launch_bounds__(kItThreads, it_blocks_per_sm<NT>())\n    w4x8_a8_tc(" in src


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_k5", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smokes_profile_still_counts_k5():
    """Phase 4c's `matmul_ms` counts K5's kernels by name (`w4x8_\\w*`), and
    the prefill profile leaves out its quantization and matmul kernels,
    which run the decode steps."""
    cs = _load_smoke()
    names = {"w4x8_quant_x<__nv_bfloat16>": 1.0, "w4x8_a8_tc<1>": 10.0, "w4x8_a8_tc<2>": 20.0,
             "w4x8_reduce<__nv_bfloat16>": 2.0, "w4x8_tc<1>": 100.0}
    for name in names:
        assert cs.MATMUL_KERNELS.search(name), name
    assert cs._matmul_us(names) == sum(names.values())
    assert cs._matmul_us(names, prefill=True) == 102.0


# --------------------------------------------------------------------- plan

@pytest.mark.parametrize("m", [1, 2, 4, 8, 9, 12, 16])
@pytest.mark.parametrize("k,n", SHAPES_7B + [(128, 16), (1024, 384), (384, 4000)])
def test_k5_plan_is_one_wave_of_whole_groups(m, k, n):
    """Splits cut at whole 128-row groups, none empty, as many as one wave
    of blocks holds (512 columns by one n8 tile of slots, three an SM; two
    tiles above 8 rows, two an SM); one f32 partial a split, always (the
    reduce writes the output)."""
    ksplit, gpb = kernels.a8_split_for(m, k, n)
    groups = k // 128
    assert ksplit * gpb >= groups > (ksplit - 1) * gpb
    tiles, slots = kernels.a8_slots(m)
    assert (tiles, slots) == ((1, 8) if m <= 8 else (2, 16))
    blocks = -(-n // 512)
    assert blocks * ksplit <= max((3 if tiles == 1 else 2) * 132, blocks)
    assert kernels.w4x8_plan(m, k, n, torch.bfloat16) == ("a8", ksplit, ksplit * m * n)
    assert kernels.w4x8_plan(m, k, n, torch.float32) == ("a8", ksplit, ksplit * m * n)


def test_k5_plan_at_the_7b_shapes():
    """m = 4: 16, 32, 8, 43 and 6 splits of 2, 1, 4, 2 and 6 groups (384,
    256, 344, 344 and 378 blocks); m = 16: 11, 32, 6, 29 and 4."""
    assert [kernels.a8_split_for(4, k, n) for k, n in SHAPES_7B] == [
        (16, 2), (32, 1), (8, 4), (43, 2), (6, 6)]
    assert [kernels.a8_split_for(16, k, n)[0] for k, n in SHAPES_7B] == [11, 32, 6, 29, 4]


def test_more_rows_than_a_block_go_to_grid_z():
    """With the switch raised above 16 (LLAMAGO_W4X8_A8_MAX_M) the rows go
    to blocks of 16 along grid z, sx laid out for whole blocks."""
    assert kernels.a8_slots(20) == (2, 32) and kernels.a8_slots(33) == (2, 48)
    src = _src()
    assert "(M + 8 * NT - 1) / (8 * NT)" in src
    assert "const int mp = (M + 8 * nt - 1) / (8 * nt) * (8 * nt);" in src


# ------------------------------------------------------------- the C side

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}


def test_entry_points_match_the_argtypes(monkeypatch):
    class Lib:
        pass

    for name in ("llamago_w4x8_quantize_x", "llamago_w4x8_matmul_a8",
                 "llamago_w4x8_matmul_stream"):
        setattr(Lib, name, type("Fn", (), {})())
    monkeypatch.setattr(_build, "library", lambda name: Lib)
    lib = kernels._lib_w4x8.__wrapped__()
    for name, want in (("llamago_w4x8_quantize_x", ["x", "xq", "sx", "M", "K", "x_bf16",
                                                     "stream"]),
                       ("llamago_w4x8_matmul_a8", ["x", "q", "s", "out", "xq", "sx", "ws", "M",
                                                    "K", "N", "x_bf16", "ksplit", "gpb",
                                                    "stream"])):
        sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', _src())
        params = [p.split() for p in sig.group(1).split(",")]
        assert [p[-1] for p in params] == want
        fn = getattr(lib, name)
        assert fn.argtypes == [_C_TYPES[" ".join(p[:-1])] for p in params]
        assert fn.restype is ctypes.c_int


def test_one_quantization_kernel_in_two_layouts():
    """The standalone entry (chip_smoke's bit-exact check) and the matmul
    run the same kernel: sx [M, K/128] for the former, [K/128, slots] for
    the latter, by the store's strides alone; the matmul's form reads group
    g's scale row 2g and sx row g."""
    src = _src()
    assert src.count("w4x8_quant_x<XT><<<") == 1
    assert "sx[(size_t)m * sx_m + (size_t)g * sx_g] = s;" in src
    assert "M, K, G, 1, st);" in src and "M, K, 1, mp, st);" in src
    assert "a.sg = 4, a.tile = 4, a.tile_rows = 2;" in src
    assert "a.xlayout = kItXRows, a.tm = M," in src and "a.sx_ld = mp;" in src
    entry = src.split('extern "C" int llamago_w4x8_matmul_a8(')[1]
    assert "(long long)ksplit * gpb < G || (long long)(ksplit - 1) * gpb >= G" in entry


@pytest.mark.parametrize("tiles", [1, 2])
def test_the_blocks_an_sm_is_to_hold_fit(tiles):
    """The int4 ring (six stages of 16 packed rows) holds the warps' sums at
    two n8 tiles and fits the blocks the launch bounds ask for."""
    lay = _it_layout(I4)
    per_sm = 3 if tiles == 1 else 2
    assert per_sm * (lay["smem"] + SMEM_RESERVED) <= SMEM_PER_SM
    assert lay["smem"] >= 4 * 8 * tiles * 128 * 4


class _FakeLib:
    def __init__(self):
        self.calls = []

    def llamago_w4x8_matmul_a8(self, x, q, s, out, xq, sx, ws, m, k, n, x_bf16, ksplit, gpb,
                               stream):
        self.calls.append(dict(m=m, k=k, n=n, x_bf16=x_bf16, ksplit=ksplit, gpb=gpb))
        return 0


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16])
def test_launcher_counts_and_hands_the_plan(monkeypatch, m):
    """K5 through `dequant_matmul` on meta tensors: the split it hands its
    entry point, the one scratch allocation (sx for whole blocks of slots,
    the partials, xq) and its count (`launches_a8`), for both x dtypes."""
    for attr in ("launches_a8", "launches_stream", "launches_tc"):
        monkeypatch.setattr(kernels.w4x8_matmul, attr, 0)
    fake = _FakeLib()
    monkeypatch.setattr(kernels, "_lib_w4x8", lambda: fake)
    monkeypatch.setattr(kernels, "_cuda_or_raise", lambda x, what: None)
    monkeypatch.setattr(kernels, "_check_cuda_args", lambda *a, **kw: None)
    monkeypatch.setattr(kernels, "_stream", lambda x2: 0)
    meta = torch.device("meta")
    k, n = 4096, 12288
    w = {"q4x": torch.empty((k // 2, n), dtype=torch.uint8, device=meta),
         "s": torch.empty((k // 64, n), dtype=torch.bfloat16, device=meta)}
    scratch = []
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        if t.dtype == torch.uint8:
            scratch.append(t.numel())
        return t

    xs = [empty((m, k), dtype=dt, device=meta) for dt in (torch.bfloat16, torch.float32)]
    monkeypatch.setattr(torch, "empty", spy)
    for x in xs:
        out = kernels.dequant_matmul(x, w)
        assert out.shape == (m, n) and out.dtype == x.dtype
    ksplit, gpb = kernels.a8_split_for(m, k, n)
    assert fake.calls == [dict(m=m, k=k, n=n, x_bf16=b, ksplit=ksplit, gpb=gpb) for b in (1, 0)]
    slots = kernels.a8_slots(m)[1]
    assert scratch == [4 * slots * (k // 128) + 4 * ksplit * m * n + m * k] * 2
    assert (kernels.w4x8_matmul.launches_a8, kernels.w4x8_matmul.launches_stream) == (2, 0)


# ------------------------------------------------------------ the lanes

def emulate_k5(x: torch.Tensor, leaf: dict, seed: int = 0) -> np.ndarray:
    """llamago_w4x8_matmul_a8 on the card, emulated: the plain quantization
    (bit for bit the kernel's), sx laid out [groups, slots] with NaN in the
    slots past M (never written), the form's lanes (`emulate_i8tc`, int4
    format, scale row 2g, xq rows past M never copied) over the split of
    `a8_split_for`, then w4x8_reduce's fixed-order sum. f32 [M, N]."""
    m, k = x.shape
    xq, sx = kernels.quantize_activations_a8(x)
    q = leaf["q4x"].numpy()
    n = q.shape[1]
    tiles, slots = kernels.a8_slots(m)
    sx_mem = np.full((k // 128, slots), np.nan, np.float32)
    sx_mem[:, :m] = sx.numpy().T
    ksplit, gpb = kernels.a8_split_for(m, k, n)
    parts = emulate_i8tc(I4, tiles, q=q, s16=leaf["s"].view(torch.int16).numpy().view(np.uint16),
                         xq=xq.numpy().view(np.uint8).reshape(-1), xlayout=X_ROWS, tm=m,
                         sx=sx_mem.reshape(-1), sx_ld=slots, k=k, n=n, ksplit=ksplit,
                         per=4 * gpb, sg=4, tile=4, tile_rows=2, seed=seed)
    return reduce_in_order(parts)


@contextlib.contextmanager
def jax_interpret():
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    try:
        yield
    finally:
        jkernels.FORCE_INTERPRET = old


def jax_k5(x: np.ndarray, leaf: dict, a8_max: int = 16) -> np.ndarray:
    """JAX's `_w4x8_matmul_2d` in interpret mode, f32 x: its W4A8 decode
    kernel for at most `a8_max` rows."""
    with jax_interpret():
        out = jkernels._w4x8_matmul_2d(jnp.asarray(x), jnp.asarray(leaf["q4x"].numpy()),
                                       jnp.asarray(leaf["s"].float().numpy(), jnp.bfloat16),
                                       a8_max)
        return np.asarray(jax.block_until_ready(out), np.float32)


@pytest.mark.parametrize("m", [1, 3, 8, 9, 13, 16])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_emulated_lanes_match_plain_and_jax(m, xdt):
    """The form's lanes at K = 1024 (8 groups, 8 splits of one group), N =
    384 (the block's last 128 columns garbage), one and two n8 tiles, x
    rows and sx past M garbage, against the plain version and the JAX kernel
    in interpret mode, in f32 (bf16 x: its values widened to f32, which is
    what both quantize)."""
    k, n = 1024, 384
    leaf = quant.quantize_w4x8(torch.from_numpy(rnd((k, n), 40 + m, 0.1)))
    x = torch.from_numpy(rnd((m, k), 50 + m, 2.0)).to(getattr(torch, xdt)).float()
    x[0, 128:256] = 0  # a zero group: sx = 1
    assert kernels.a8_split_for(m, k, n)[0] == 8
    got = emulate_k5(x, leaf)
    assert np.isfinite(got).all()
    plain = kernels.w4x8_matmul_a8_plain(x, leaf).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=F32_TOL * np.abs(plain).max())
    want = jax_k5(x.numpy(), leaf)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


def test_rows_past_a_block_go_to_the_next_block_along_z():
    """m = 20 with the switch raised: two blocks of 16 slots along grid z
    (the second with 4), against the plain version and JAX with its own
    switch at 32."""
    k, n, m = 512, 256, 20
    leaf = quant.quantize_w4x8(torch.from_numpy(rnd((k, n), 61, 0.1)))
    x = torch.from_numpy(rnd((m, k), 62))
    got = emulate_k5(x, leaf, seed=3)
    plain = kernels.w4x8_matmul_a8_plain(x, leaf).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=F32_TOL * np.abs(plain).max())
    want = jax_k5(x.numpy(), leaf, a8_max=32)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


@pytest.mark.parametrize("m", [4, 16])
def test_bf16_output_is_one_rounding_of_the_sum(m):
    """For bf16 x the reduce rounds the f32 sum once: the wrapper's CPU
    route (the plain version) against JAX in interpret mode with bf16 x, to
    one bf16 rounding."""
    k, n = 1024, 256
    leaf = quant.quantize_w4x8(torch.from_numpy(rnd((k, n), 70 + m, 0.1)))
    x = torch.from_numpy(rnd((m, k), 80 + m)).to(torch.bfloat16)
    got = kernels.w4x8_matmul(x, leaf)
    assert got.dtype == torch.bfloat16
    with jax_interpret():
        want = np.asarray(jkernels._w4x8_matmul_2d(
            jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(leaf["q4x"].numpy()),
            jnp.asarray(leaf["s"].float().numpy(), jnp.bfloat16), 16), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())
