"""K1's and K9's tensor-core decode form with f32 x ("f32_decode_tc"): f32 x
at m <= 8 as three exact bf16 parts, split in the kernel's registers,
against the plain versions and the JAX kernels on the CPU.

On the card a Q8_0 / Q4_0 matmul of at most 8 rows with f32 x takes
`dq_decode_f32tc` (K1) or `so_decode_f32tc` (K9; `ops/kernels.py:k1_form`,
`k9_form`), two instances of `decode_tc_body` (`csrc/decode_tc.cuh`) with
x of type float: the TMA bulk copies bring each slot's 32 values of a
quant block whole (128 bytes, rows 160 bytes apart in the stage), each lane
cuts the 8 values of its B fragment into hi + mid + lo (`split3`,
`csrc/tc_common.cuh`), and each A fragment of weights, decoded once, feeds
three mma (lo, mid, hi) into the zeroed block sum; K9's Q4_0 takes 8 *
sum(x_b) of the f32 values off it; the scale folds it into the f32 sum and
the output is f32 (the reduce adds the splits of K in a fixed order).
Here, without a card, the tests pin the routes, the plans and workspaces,
the form code in both C entry points and their refusals, the argtypes,
the shared memory of each template instance, the launchers on meta
tensors, the stage's constants in the source, and a numpy emulation of
each lane (its stage, its reads, its split, its fragments and its three
mma) against the plain versions and the JAX kernels in interpret mode, in
f32, with inf and NaN in x too.
"""

import ctypes
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu_torch.ops import _build, kernels, quant

from test_torch_f32_tc import split3, wide_x
from test_torch_k1_decode_tc import GID, LANE, TIG, _i8_pair, _mma, _q4_pair, jax_k1
from test_torch_k9_decode_tc import _q4_raw_pair, jax_so

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).parents[1] / "csrc"
ROOT = pathlib.Path(kernels.__file__).parents[2]
# of max|ref|: exact parts and exact products, f32 sums in another order
F32_TOL = 1e-5
SMEM_PER_SM = 233472  # bytes of shared memory an H100 SM holds for its blocks
SMEM_RESERVED = 1024  # bytes the card reserves for each resident block
# the 7B projections (K, N) chip_smoke times, the head padded to 32768
SHAPES_7B = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32768)]
# the stage of csrc/decode_tc.cuh: weight rows 528 bytes apart, f32 x rows
# 160 (40 floats), 512 columns a block, three stages
ROW_LD, X_LD_F32, BLOCK_COLS, STAGES = 528, 160, 512, 3
FORM = 4  # "f32_decode_tc" in both C entry points


def _src(name: str) -> str:
    return (CSRC / name).read_text()


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _leaf(fmt: str, k: int, n: int, seed: int):
    """A port leaf ("q8:float32", "q4:bfloat16", ...) and the same numbers
    as a JAX leaf."""
    key, sdt = fmt.split(":")
    leaf = quant.quantize(torch.from_numpy(rnd((k, n), seed, 0.1)), 8 if key == "q8" else 4)
    leaf["s"] = leaf["s"].to(getattr(torch, sdt))
    return leaf, {key: jnp.asarray(leaf[key].numpy()),
                  "s": jnp.asarray(leaf["s"].float().numpy(), sdt)}


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("m", range(1, 9))
def test_f32_decode_rows_take_the_form_in_k1_and_k9(m):
    assert kernels.k1_form(m, torch.float32) == "f32_decode_tc"
    assert kernels.k9_form(m, torch.float32) == "f32_decode_tc"
    assert kernels.k1_form(m, torch.bfloat16) == kernels.k9_form(m, torch.bfloat16) == "decode_tc"


@pytest.mark.parametrize("m", [9, 16, 17, 64, 256])
def test_more_rows_keep_their_forms(m):
    """Above 8 rows K1 takes its tile on x's three parts, and so does K9
    (its GEMV is gone)."""
    assert kernels.k1_form(m, torch.float32) == "f32_tc"
    assert kernels.k9_form(m, torch.float32) == "f32_tc"


# ---------------------------------------------------------------- the plans

@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("k,n", SHAPES_7B + [(32, 16), (256, 272), (1376, 512), (4096, 32000)])
def test_plans_split_as_the_decode_form_with_no_planes(m, k, n):
    """K1 and K9 split K as the bf16 decode form does (`decode_tc_split_for`)
    and take a workspace of ksplit * m * n f32 partials only where K is
    split: x is split in registers, so no planes."""
    ksplit = kernels.decode_tc_split_for(k, n)[0]
    want = ("f32_decode_tc", ksplit, ksplit * m * n if ksplit > 1 else 0)
    assert kernels.k1_plan(m, k, n, torch.float32) == want
    assert kernels.k9_plan(m, k, n, torch.float32) == want
    assert kernels.k1_plan(m, k, n, torch.bfloat16)[1:] == want[1:]


# ---------------------------------------------------------------- the C side

def test_form_code_in_both_entry_points():
    """Code 4 in both enums; codes 1-3 keep their meaning (code 0, K9's
    GEMV, is gone)."""
    assert kernels.K1_FORMS == {"f32_tc": 1, "tensor_core": 2, "decode_tc": 3,
                                "f32_decode_tc": 4}
    assert kernels.K1_FORMS["f32_decode_tc"] == FORM
    for name in ("dequant_matmul.cu", "dequant_matmul_so.cu"):
        enum = re.search(r"enum Form \{[^}]*kDecodeTc = 3, kF32DecodeTc = (\d) \};", _src(name))
        assert enum is not None and int(enum.group(1)) == FORM, name


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}


@pytest.mark.parametrize("source,name,lib_fn", [
    ("dequant_matmul.cu", "llamago_dequant_matmul", "_lib"),
    ("dequant_matmul_so.cu", "llamago_dequant_matmul_so", "_lib_so")])
def test_entry_points_match_the_argtypes(monkeypatch, source, name, lib_fn):
    class Lib:
        pass

    setattr(Lib, name, type("Fn", (), {})())
    monkeypatch.setattr(_build, "library", lambda _: Lib)
    fn = getattr(kernels, lib_fn).__wrapped__()
    sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', _src(source))
    params = [p.split() for p in sig.group(1).split(",")]
    assert [p[-1] for p in params] == ["x", "q", "s", "out", "ws", "M", "K", "N", "bits",
                                       "x_bf16", "s_bf16", "form", "ksplit", "stream"]
    assert fn.argtypes == [_C_TYPES[" ".join(p[:-1])] for p in params]
    assert fn.restype is ctypes.c_int


def _c_to_py(expr: str) -> str:
    """A C condition of the entry points as Python."""
    expr = expr.replace("&&", " and ").replace("||", " or ").replace("nullptr", "None")
    return re.sub(r"!(?!=)", " not ", expr)


def _refuses(source: str, name: str):
    """The entry point's refusal, read from the source: f(bits, x_bf16,
    form, M, ksplit, w) is True where it returns cudaErrorInvalidValue."""
    body = _src(source).split(f'extern "C" int {name}(')[1]
    cond = re.search(r"\n  if \((.*?)\)\n    return \(int\)cudaErrorInvalidValue;", body,
                     re.S).group(1)
    pre = re.search(r"const bool bf16_form = (.*?);", body)
    enum = dict(re.findall(r"(k\w+) = (\d)", re.search(r"enum Form \{([^}]*)\}",
                                                        _src(source)).group(1)))
    env = {k: int(v) for k, v in enum.items()}

    def refuses(bits, x_bf16, form, M, ksplit, w):
        scope = dict(env, bits=bits, x_bf16=x_bf16, form=form, M=M, ksplit=ksplit, w=w)
        if pre:
            scope["bf16_form"] = eval(_c_to_py(pre.group(1)), {}, scope)
        return bool(eval(_c_to_py(" ".join(cond.split())), {}, scope))
    return refuses


@pytest.mark.parametrize("source,name", [("dequant_matmul.cu", "llamago_dequant_matmul"),
                                         ("dequant_matmul_so.cu", "llamago_dequant_matmul_so")])
def test_entry_points_refuse_what_the_form_cannot_take(source, name):
    """f32 x at 1 to 8 rows, with a workspace where K is split; bf16 x, 9
    rows and a split with no workspace are refused; bf16 x keeps its own
    decode form (code 3) and f32 x cannot take it."""
    refuses = _refuses(source, name)
    ws = object()
    for bits in (8, 4):
        for m in range(1, 9):
            assert not refuses(bits, 0, FORM, m, 1, None)
            assert not refuses(bits, 0, FORM, m, 16, ws)
            assert refuses(bits, 1, FORM, m, 16, ws)  # bf16 x
            assert refuses(bits, 0, FORM, m, 16, None)  # split, no workspace
            assert not refuses(bits, 1, 3, m, 16, ws) and refuses(bits, 0, 3, m, 16, ws)
        assert refuses(bits, 0, FORM, 9, 1, ws)
        # code 0 was K9's GEMV (K1's went first): both refuse it
        assert all(refuses(bits, xb, 0, m, 4, ws) for xb in (0, 1) for m in (1, 8, 16))
    assert refuses(5, 0, FORM, 4, 1, ws) and refuses(8, 0, 5, 4, 1, ws)


def test_k1s_gemv_is_gone_and_k9s_stays_above_8_rows():
    """The new form won every cell of the mirrored pair against K1's GEMV
    (m = 1, 2, 4, 8; Q8_0 and Q4_0; f32 and bf16 scales), so `dq_gemv` and
    its launcher are gone; K9's `so_gemv`, which took more than 8 rows,
    went the same way once K1's tile on the raw integers won its pair: above
    8 rows K9 plans as K1's tile, with x's block sums in the f32 workspace."""
    k1 = _src("dequant_matmul.cu")
    assert "dq_gemv" not in k1 and "launch_gemv" not in k1
    assert "so_gemv" not in _src("dequant_matmul_so.cu")
    for m in range(1, 9):
        assert "gemv" not in (kernels.k1_plan(m, 4096, 4096, torch.float32)[0],
                              kernels.k9_plan(m, 4096, 4096, torch.float32)[0])
    ks = kernels.k1_plan(9, 4096, 4096, torch.float32)[1]
    assert kernels.k9_plan(9, 4096, 4096, torch.float32) == (
        "f32_tc", ks, kernels.k9_workspace(9, 4096, 4096, ks))


# ---------------------------------------------------- the stage and its launch

def test_the_layout_constants_are_the_sources():
    h = _src("decode_tc.cuh")
    for line in ("constexpr int kDtRowLd = kDtBlockCols + 16, kDtXLd = 80;",
                 "constexpr int kDtXLdF32 = 160;",
                 "return sizeof(XT) == 4 ? kDtXLdF32 : kDtXLd;",
                 "return dt_rows<BITS>() * kDtRowLd + 8 * dt_x_ld<XT>() + kDtBlockCols * (int)"
                 "sizeof(ST);",
                 "constexpr int kDtStages = 3;",
                 # the mbarrier counts each slot row of x: 32 values of XT
                 "ROWS * width + M * 32 * (int)sizeof(XT) + width * (int)sizeof(ST);",
                 "bulk_copy(st + X_OFF + (tid - 32) * XLD, x + (size_t)(tid - 32) * K + kb * 32,\n"
                 "                32 * (int)sizeof(XT), bars + slot);",
                 "constexpr int X_OFF = ROWS * kDtRowLd, S_OFF = X_OFF + 8 * XLD;",
                 # each lane's B values, split into three parts, lo first
                 "const float2 v = *reinterpret_cast<const float2*>(xrow + 8 * tig + 32 * j);",
                 "const uint3 a = split3(v.x), b = split3(v.y);",
                 "xb[0][j] = a.x | (b.x << 16);", "xb[1][j] = a.y | (b.y << 16);",
                 "xb[2][j] = a.z | (b.z << 16);",
                 "for (int p = P - 1; p >= 0; --p) mma_bf16(part, a, xb[p][0], xb[p][1]);",
                 "for (int p = P - 1; p >= 0; --p) mma_bf16(part, a, xb[p][2], xb[p][3]);",
                 # K9's x sums of the f32 values, and the f32 output
                 "const float4* v = reinterpret_cast<const float4*>(xrow + 32 * tig);",
                 "*reinterpret_cast<float4*>(out + (size_t)m * N + c) = v;"):
        assert line in h, line
    for source, kernel, raw in (("dequant_matmul.cu", "dq_decode_f32tc", "false"),
                                ("dequant_matmul_so.cu", "so_decode_f32tc", "true")):
        src = _src(source)
        assert f"__launch_bounds__(kDtThreads, 3) {kernel}(const float* __restrict__ x," in src
        assert f"decode_tc_body<ST, BITS, {raw}, float>(x, q, s, out, ws, M, K, N, per);" in src
        assert f"return {kernel}<ST, BITS>;" in src
        assert "constexpr int smem = dt_smem_bytes<ST, BITS, XT>();" in src


def _stage(bits: int, s_bytes: int) -> tuple[int, int, int, int]:
    """(weight rows, x offset, scale offset, bytes) of one stage with f32 x."""
    rows = 32 if bits == 8 else 16
    x_off = rows * ROW_LD
    s_off = x_off + 8 * X_LD_F32
    return rows, x_off, s_off, s_off + BLOCK_COLS * s_bytes


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("s_bytes", [4, 2])
def test_three_blocks_an_sm_with_f32_x(bits, s_bytes):
    """Both new kernels ask the launch bounds for three blocks an SM: the
    ring of three stages and its barriers leave them room, every copy lands
    16-byte aligned, and the ring holds the warps' sums."""
    rows, x_off, s_off, stage = _stage(bits, s_bytes)
    smem = STAGES * (stage + 8)
    assert 3 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    assert stage % 16 == 0 and x_off % 16 == 0 and s_off % 16 == 0 and X_LD_F32 % 16 == 0
    assert smem >= 4 * 8 * 128 * 4
    if (bits, s_bytes) == (8, 4):
        assert stage == 20224 and smem == 60696  # the largest instance
    assert "static_assert(3 * (dt_smem_bytes<float, 8, float>() + 1024) <= 233472," in \
        _src("decode_tc.cuh")


def test_f32_x_reads_fall_on_distinct_banks():
    """A lane's 8-byte reads of x (slot gid, k = 2*tig + {0, 1} + 8j) at the
    160-byte stride: each half-warp's 16 lanes touch 32 distinct banks."""
    for j in range(4):
        words = (GID * X_LD_F32 + 8 * TIG + 32 * j) // 4
        for half in (LANE < 16, LANE >= 16):
            banks = np.concatenate([words[half], words[half] + 1]) % 32
            assert len(set(banks.tolist())) == 32


class _FakeEntry:
    def __init__(self):
        self.calls = []

    def __call__(self, x, q, s, out, ws, m, k, n, bits, x_bf16, s_bf16, form, ksplit, stream):
        self.calls.append(dict(m=m, k=k, n=n, bits=bits, x_bf16=x_bf16, s_bf16=s_bf16,
                               form=form, ksplit=ksplit))
        return 0


@pytest.mark.parametrize("kernel", ["k1", "k9"])
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_launchers_hand_the_form_its_plan(monkeypatch, m, bits, sdt, kernel):
    """`dequant_matmul` on meta tensors (K9 with the switch at 8): form 4,
    the decode split, one f32 workspace where K is split, and one count on
    `launches_f32_decode_tc` of the wrapper that launched."""
    for wrapper in (kernels.dequant_matmul, kernels.dequant_matmul_so):
        for attr in [a for a in vars(wrapper) if a.startswith("launches")]:
            monkeypatch.setattr(wrapper, attr, 0)
    monkeypatch.setattr(kernels, "SCALE_ON_OUTPUT_MAX_M", 8 if kernel == "k9" else 0)
    entry = _FakeEntry()
    monkeypatch.setattr(kernels, "_lib" if kernel == "k1" else "_lib_so", lambda: entry)
    monkeypatch.setattr(kernels, "_cuda_or_raise", lambda x, what: None)
    monkeypatch.setattr(kernels, "_check_cuda_args", lambda *a, **kw: None)
    monkeypatch.setattr(kernels, "_stream", lambda x2: 0)
    meta = torch.device("meta")
    k, n = 4096, 12288
    key = "q8" if bits == 8 else "q4"
    w = {key: torch.empty((k if bits == 8 else k // 2, n), device=meta,
                          dtype=torch.int8 if bits == 8 else torch.uint8),
         "s": torch.empty((k // 32, n), dtype=sdt, device=meta)}
    x = torch.empty((m, k), dtype=torch.float32, device=meta)
    spaces = []
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        if t.dim() == 1 and t.dtype == torch.float32:
            spaces.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", spy)
    out = kernels.dequant_matmul(x, w)
    assert out.shape == (m, n) and out.dtype == torch.float32
    ksplit = kernels.decode_tc_split_for(k, n)[0]
    assert ksplit > 1
    assert entry.calls == [dict(m=m, k=k, n=n, bits=bits, x_bf16=0,
                                s_bf16=int(sdt == torch.bfloat16), form=FORM, ksplit=ksplit)]
    assert spaces == [ksplit * m * n]
    k1, k9 = kernels.dequant_matmul, kernels.dequant_matmul_so
    counts = {"k1": (k1.launches + k1.launches_q4, k1.launches_f32_decode_tc, k1.launches_tc,
                     k1.launches_decode_tc, k1.launches_f32_tc),
              "k9": (k9.launches, k9.launches_f32_decode_tc, 0, k9.launches_decode_tc, 0)}
    assert counts[kernel] == (1, 1, 0, 0, 0)
    assert counts["k9" if kernel == "k1" else "k1"][:2] == (0, 0)


def test_chip_smoke_gates_counts_and_profiles_the_new_forms():
    """chip_smoke's spill gate holds both decode forms of K1 and K9, its
    counters read the new counts, and a decode step's `matmul_ms` counts
    the new kernels and their reduces by name."""
    spec = importlib.util.spec_from_file_location("chip_smoke_f32dec", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for form, source in (("dq_decode_tc", "dequant_matmul"), ("dq_decode_f32tc", "dequant_matmul"),
                         ("so_decode_tc", "dequant_matmul_so"),
                         ("so_decode_f32tc", "dequant_matmul_so")):
        assert cs.TC_FORMS[form] == source
    counters = cs._launch_counters()
    assert counters["dequant_matmul_f32_decode_tc"] == (kernels.dequant_matmul,
                                                        "launches_f32_decode_tc")
    assert counters["dequant_matmul_so_f32_decode_tc"] == (kernels.dequant_matmul_so,
                                                           "launches_f32_decode_tc")
    names = {"dq_decode_f32tc<__nv_bfloat16, 8>": 3.0, "dq_reduce<float>": 0.3,
             "so_decode_f32tc<float, 4>": 2.0, "so_reduce<float>": 0.2}
    for name in names:
        assert cs.MATMUL_KERNELS.search(name), name
    assert cs._matmul_us(names) == sum(names.values())


# ------------------------------------------------------- the lanes, emulated

def _a_frag(w, bits, raw, t, step):
    """dt_a_frag: the A fragment of m16 tile t at k16 step `step` from a
    lane's weight reads (int8 XORed with 0x80; Q4_0 centred, or raw)."""
    i, j = t >> 2, t & 3
    if bits == 8:
        r = 4 * step
        return [_i8_pair(j, w[r][:, i], w[r + 1][:, i]),
                _i8_pair(j, w[r][:, i + 2], w[r + 1][:, i + 2]),
                _i8_pair(j, w[r + 2][:, i], w[r + 3][:, i]),
                _i8_pair(j, w[r + 2][:, i + 2], w[r + 3][:, i + 2])]
    sh = 4 * step
    pair = _q4_raw_pair if raw else _q4_pair
    return [pair(j, sh, w[0][:, i], w[1][:, i]), pair(j, sh, w[0][:, i + 2], w[1][:, i + 2]),
            pair(j, sh, w[2][:, i], w[3][:, i]), pair(j, sh, w[2][:, i + 2], w[3][:, i + 2])]


def _scales(raw_bytes: np.ndarray, s_bytes: int) -> np.ndarray:
    """Scale bytes read from the stage as f32 (bf16 widened exactly)."""
    if s_bytes == 4:
        return raw_bytes.view(np.float32)
    return (raw_bytes.view(np.uint16).astype(np.uint32) << np.uint32(16)).view(np.float32)


def emulate_f32_decode_tc(x: np.ndarray, leaf: dict, rng, raw: bool) -> np.ndarray:
    """dq_decode_f32tc (raw False) or so_decode_f32tc (raw True) lane by
    lane, in numpy. Each stage is a byte array filled with garbage where no
    copy lands: the block's weight rows 528 bytes apart (the columns past
    N garbage), the M slot rows of x (128 bytes of f32 each) 160 bytes
    apart (rows past M never copied), the scales. Each lane reads its
    16-byte weight words, its four 8-byte pairs of x (k = 2*tig + {0, 1} +
    8j), splits each value into hi, mid, lo (`split3`) and packs each part
    into bf16 pairs (0 past M); each A fragment, built bit for bit, goes
    into three mma by the PTX layout, lo, mid, hi, into the zeroed block
    sum; raw Q4_0 takes off 8 * the slot's sum of its f32 values (each
    lane's 8 in order, two xor shuffles); the scale folds by an f32 FMA;
    the warps' columns are placed and the splits added in order (the
    reduce). Returns f32 [M, N]."""
    m, k = x.shape
    bits = 8 if "q8" in leaf else 4
    q = leaf["q8"].numpy().view(np.uint8) if bits == 8 else leaf["q4"].numpy()
    n = q.shape[1]
    s_bytes = leaf["s"].element_size()
    sbytes = leaf["s"].contiguous().view(torch.uint8).numpy()
    xbytes = np.ascontiguousarray(x, np.float32).view(np.uint8)
    rows, x_off, s_off, stage_bytes = _stage(bits, s_bytes)
    wr = 8 if bits == 8 else 4
    nb = k // 32
    ksplit, per = kernels.decode_tc_split_for(k, n)
    row_ok = GID < m
    out = np.zeros((m, n), np.float32)
    for nb0 in range(0, n, BLOCK_COLS):
        width = min(BLOCK_COLS, n - nb0)
        total = None
        for y in range(ksplit):
            acc = np.zeros((4, 32, 8, 4), np.float32)  # warp, lane, tile, C register
            for kb in range(y * per, min((y + 1) * per, nb)):
                st = rng.integers(0, 256, stage_bytes, dtype=np.uint8)
                for r in range(rows):
                    st[r * ROW_LD:r * ROW_LD + width] = q[kb * rows + r, nb0:nb0 + width]
                for r in range(m):
                    st[x_off + r * X_LD_F32:x_off + r * X_LD_F32 + 128] = \
                        xbytes[r, kb * 128:(kb + 1) * 128]
                st[s_off:s_off + width * s_bytes] = \
                    sbytes[kb, nb0 * s_bytes:(nb0 + width) * s_bytes]

                def read(off, nbytes):
                    return st[off[:, None] + np.arange(nbytes)[None]]

                for warp in range(4):
                    cw = warp * 128 + 16 * GID  # a lane's 16 columns in the block
                    w = []
                    for r in range(wr):
                        row = 16 * (r >> 2) + 8 * ((r >> 1) & 1) + 2 * TIG + (r & 1)
                        word = np.ascontiguousarray(read(row * ROW_LD + cw, 16)).view(np.uint32)
                        w.append(word ^ np.uint32(0x80808080) if bits == 8 else word)
                    xb = np.zeros((3, 32, 4), np.uint32)  # part, lane, k pair
                    for j in range(4):
                        v = np.ascontiguousarray(read(x_off + GID * X_LD_F32 + 8 * TIG + 32 * j,
                                                      8)).view(np.float32)
                        parts = split3(v).astype(np.uint32)  # [3, lanes, 2]
                        xb[:, :, j] = parts[..., 0] | (parts[..., 1] << np.uint32(16))
                    xb[:, ~row_ok] = 0
                    xs8 = np.zeros((32, 2), np.float32)
                    if raw and bits == 4:
                        vals = np.ascontiguousarray(read(x_off + GID * X_LD_F32 + 32 * TIG,
                                                         32)).view(np.float32)
                        total_x = np.zeros(32, np.float32)
                        for i in range(8):
                            total_x = (total_x + vals[:, i]).astype(np.float32)
                        total_x = np.where(row_ok, total_x, np.float32(0))
                        total_x = (total_x + total_x[LANE ^ 1]).astype(np.float32)
                        total_x = (total_x + total_x[LANE ^ 2]).astype(np.float32)
                        xs8 = np.stack([8 * total_x[8 * TIG], 8 * total_x[8 * TIG + 4]],
                                       1).astype(np.float32)
                    sc = _scales(np.ascontiguousarray(read(s_off + cw * s_bytes, 16 * s_bytes)),
                                 s_bytes)
                    for t in range(8):
                        part = np.zeros((32, 4), np.float32)
                        for step in range(2):
                            a = _a_frag(w, bits, raw, t, step)
                            for p in (2, 1, 0):  # lo, mid, hi
                                _mma(part, a, xb[p][:, 2 * step], xb[p][:, 2 * step + 1])
                        if raw and bits == 4:
                            part = (part - xs8[:, [0, 1, 0, 1]]).astype(np.float32)
                        for e, half in ((0, 0), (1, 0), (2, 1), (3, 1)):
                            acc[warp, :, t, e] = (np.float64(sc[:, 8 * half + t]) * part[:, e]
                                                  + acc[warp, :, t, e]).astype(np.float32)
            red = np.zeros((8, BLOCK_COLS), np.float32)
            for warp in range(4):
                for h in range(2):
                    for t in range(8):
                        red[2 * TIG + h, 128 * warp + 16 * GID + t] = acc[warp, :, t, h]
                        red[2 * TIG + h, 128 * warp + 16 * GID + 8 + t] = acc[warp, :, t, 2 + h]
            # the reduce: the splits' partials added in order
            total = red[:m] if total is None else (total + red[:m]).astype(np.float32)
        out[:, nb0:nb0 + width] = total[:, :width]
    return out


def _run(x, leaf, raw, seed=3):
    with np.errstate(invalid="ignore", over="ignore"):
        return emulate_f32_decode_tc(x, leaf, np.random.default_rng(seed), raw)


def _plain(x, leaf, raw):
    fn = kernels.dequant_matmul_so_plain if raw else kernels.dequant_matmul_plain
    return fn(torch.from_numpy(x), leaf).numpy()


FMTS = ["q8:float32", "q8:bfloat16", "q4:float32", "q4:bfloat16"]


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8])
def test_k1_lanes_match_plain_and_jax(m, fmt):
    """K1 at K = 256 (K split in two) and N = 384 (a ragged 512-column
    block; the JAX launcher takes N in multiples of 128), against the plain version and the JAX kernel in interpret
    mode, both in f32. The wrapper's CPU route is the plain version and
    counts nothing."""
    k, n = 256, 384
    assert kernels.decode_tc_split_for(k, n) == (2, 4)
    leaf, jleaf = _leaf(fmt, k, n, 10 + m)
    x = wide_x(m, k, 20 + m)
    got = _run(x, leaf, raw=False)
    before = (kernels.dequant_matmul.launches, kernels.dequant_matmul.launches_q4,
              kernels.dequant_matmul.launches_f32_decode_tc)
    plain = kernels.dequant_matmul(torch.from_numpy(x), leaf).numpy()
    assert (kernels.dequant_matmul.launches, kernels.dequant_matmul.launches_q4,
            kernels.dequant_matmul.launches_f32_decode_tc) == before
    scale = np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=F32_TOL * scale)
    np.testing.assert_allclose(got, jax_k1(x, jleaf, jnp.float32), rtol=0, atol=F32_TOL * scale)


@pytest.mark.parametrize("fmt,m", [("q8:float32", 1), ("q8:bfloat16", 4), ("q4:float32", 2),
                                   ("q4:float32", 8), ("q4:bfloat16", 3), ("q4:bfloat16", 5)])
def test_k9_lanes_match_plain_and_jax(m, fmt):
    """K9 (the raw integers; Q4_0's x sums of the f32 values) at the same
    shape, against its plain version and the JAX scale-on-output kernel in
    interpret mode, both in f32."""
    k, n = 256, 384
    leaf, jleaf = _leaf(fmt, k, n, 30 + m)
    x = wide_x(m, k, 40 + m)
    got = _run(x, leaf, raw=True)
    plain = _plain(x, leaf, raw=True)
    scale = np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=F32_TOL * scale)
    np.testing.assert_allclose(got, jax_so(x, jleaf, jnp.float32), rtol=0, atol=F32_TOL * scale)


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("fmt", ["q8:float32", "q4:bfloat16"])
def test_lanes_at_the_small_models_k(fmt, raw):
    """K = 1376 (43 quant blocks in 9 splits of 5, the last of 3: the small
    model's w2) and N = 144, one ragged block, against the plain version."""
    k, n, m = 1376, 144, 5
    assert kernels.decode_tc_split_for(k, n) == (9, 5)
    leaf, _ = _leaf(fmt, k, n, 50)
    x = wide_x(m, k, 51)
    got = _run(x, leaf, raw)
    want = _plain(x, leaf, raw)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


@pytest.mark.parametrize("raw", [False, True])
def test_inf_and_nan_in_x_stay_non_finite_where_plain_is(raw):
    """`split3` puts an inf or NaN whole into hi (mid = lo = 0), so the
    output is non-finite exactly where the plain version's is, and the
    finite rows keep their tolerance."""
    k, n, m = 256, 144, 4
    leaf, _ = _leaf("q4:float32", k, n, 60)
    x = wide_x(m, k, 61)
    x[0, 5], x[1, 40], x[2, 200] = np.inf, np.nan, -np.inf
    got = _run(x, leaf, raw)
    with np.errstate(invalid="ignore", over="ignore"):
        want = _plain(x, leaf, raw)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert not np.isfinite(got[:3]).any() and np.isfinite(got[3]).all()
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=F32_TOL * np.abs(want[3]).max())


def test_one_part_is_not_enough():
    """hi alone (x truncated to bf16) misses the f32 function by far more
    than the tolerance at the decode rows; hi + mid + lo meets it."""
    k, n, m = 256, 128, 4
    leaf, _ = _leaf("q8:float32", k, n, 70)
    x = wide_x(m, k, 71)
    want = _plain(x, leaf, raw=False)
    hi = (split3(x)[0].astype(np.uint32) << np.uint32(16)).view(np.float32)
    dq = quant.dequantize(leaf, torch.float32).numpy().astype(np.float64)
    scale = np.abs(want).max()
    assert np.abs(hi.astype(np.float64) @ dq - want).max() > 100 * F32_TOL * scale
    np.testing.assert_allclose(_run(x, leaf, raw=False), want, rtol=0, atol=F32_TOL * scale)
