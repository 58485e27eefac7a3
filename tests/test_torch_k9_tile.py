"""K9 above 8 rows: K1's bf16 tensor-core tile on the raw integers
(`so_tc`), bf16 x and f32 x as three exact bf16 parts, against the plain
version and the JAX kernel on the CPU.

On the card a scale-on-output matmul of more than 8 rows (only a switch
above 8, `LLAMAGO_KERNEL_SO_MAX_M`, sends them to K9) takes `so_tc`
(`ops/kernels.py:k9_form`, `csrc/dequant_matmul_so.cu`), the body of K1's
tile (`csrc/tile_tc.cuh`) with RAW set: the B fragments are the raw
nibbles 0..15 (or the int8 values) as exact bf16, and each 32-row quant
block takes 8 * sum(x_b) of its row off the block sum before the column's
scale folds it. bf16 x sums its rows by one more mma against a B of ones;
f32 x sums its own f32 values in the split pass (`split_x3_sums`), which
writes them as [K/32, m rounded up to 4] between the three planes and the
split-K partials, and the tile stages them in its ring. Here, without a
card, the tests pin the route, the plan and its workspace, the entry
point's codes and refusals, the shared header's RAW instance, the
launchers on meta tensors, a numpy emulation of every lane of the RAW tile
against the plain version (m = 9, 16, 17, 64; bf16 and f32 x), the plain
version against the JAX kernel in interpret mode with the switch at 64,
and a tiny model's prefill and decode steps with the switch at 64 in both
packages.
"""

import contextlib
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.models import llama as jllama
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu_torch.models import llama
from llamago_tpu_torch.ops import _build, kernels, quant
from llamago_tpu_torch.runtime.kv_cache import KVCache

from test_torch_f32_decode_tc import _refuses
from test_torch_f32_tc import _a_frag, _b_frags, _fold, _store, _word, split3, wide_x
from test_torch_int4 import _int4_model, interpret_kernels
from test_torch_k1_decode_tc import GID, TIG, _launch_on_meta, _mma
from test_torch_k9_decode_tc import _q4_raw_pair

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).parents[1] / "csrc"
# of max|ref|: exact products (parts times integers), f32 sums in another order
F32_TOL = 1e-5
ONES = np.full(32, 0x3F803F80, np.uint32)  # a bf16 pair of ones in every lane
MS = (9, 16, 17, 32, 64, 100, 256)


def _src(name="dequant_matmul_so.cu") -> str:
    return (CSRC / name).read_text()


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _leaf(fmt: str, k: int, n: int, seed: int) -> dict:
    """A Q8_0 / Q4_0 leaf ("q8:float32", "q4:bfloat16", ...) of random
    weights, its scales in the named dtype."""
    key, sdt = fmt.split(":")
    leaf = quant.quantize(torch.from_numpy(rnd((k, n), seed, 0.1)), 8 if key == "q8" else 4)
    leaf["s"] = leaf["s"].to(getattr(torch, sdt))
    return leaf


def _jleaf(leaf: dict) -> dict:
    key = "q8" if "q8" in leaf else "q4"
    return {key: jnp.asarray(leaf[key].numpy()), "s": jnp.asarray(leaf["s"].float().numpy())}


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("m", MS)
def test_more_rows_take_the_raw_tile(m):
    """Above 8 rows K9 takes K1's tile: bf16 x as it is, f32 x on its three
    exact bf16 parts."""
    assert kernels.k9_form(m, torch.bfloat16) == "tensor_core"
    assert kernels.k9_form(m, torch.float32) == "f32_tc"


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
                                 (4096, 32768), (512, 256), (1376, 272)])
def test_tile_plan_is_k1s_with_the_block_sums(m, k, n):
    """K splits as K1's tile splits it; with f32 x the workspace holds the
    three planes, x's block sums [K/32, m rounded up to 4] and then the
    partials, each part starting 16-byte aligned."""
    assert kernels.k9_plan(m, k, n, torch.bfloat16) == kernels.k1_plan(m, k, n, torch.bfloat16)
    form, ksplit, ws = kernels.k9_plan(m, k, n, torch.float32)
    k1form, k1split, k1ws = kernels.k1_plan(m, k, n, torch.float32)
    assert (form, ksplit) == (k1form, k1split) == ("f32_tc", k1split)
    sums = (k // 32) * (-(-m // 4) * 4)
    assert ws == k1ws + sums == kernels.k9_workspace(m, k, n, ksplit)
    assert (3 * m * k // 2) % 4 == 0 and (3 * m * k // 2 + sums) % 4 == 0


# ---------------------------------------------------------------- the C side

def test_so_tc_is_the_shared_tile_with_raw_set():
    """One body (tile_tc.cuh), instantiated raw in K9 (`so_tc`) and centred
    in K1 (`dq_tc`), each under its own name; both sources ship the header;
    the GEMV and its 4-rows-a-launch walk are gone."""
    so, k1, h = _src(), _src("dequant_matmul.cu"), _src("tile_tc.cuh")
    assert "tile_tc_body<ST, MT, BITS, PARTS, true>(x, q, s, out, ws, xsum" in so
    assert "tile_tc_body<ST, MT, BITS, PARTS, false>(x, q, s, out, ws, xsum" in k1
    assert "__launch_bounds__(kTcThreads, tc_min_blocks<MT, PARTS>())\n    so_tc(" in so
    body = re.compile(r"void tile_tc_body\(")
    assert body.search(h) and not any(body.search(p.read_text()) for p in CSRC.glob("*.cu"))
    for j in range(4):
        for sh in (0, 4):
            assert f"q4_pair<{j}, {sh}, RAW>(p0, p1)" in h
    assert "mma_bf16(xsc[i], a, kOnes, kOnes)" in h and "kOnes = 0x3F803F80u" in h
    for name in ("dequant_matmul", "dequant_matmul_so"):
        assert "tile_tc.cuh" in _build.source_files(name)
    assert "so_gemv" not in so and "kRows" not in so and "kGemv" not in so
    for gone in ("gemv_plan", "ksplit_for", "_GEMV_COLS"):
        assert not hasattr(kernels, gone)


def test_entry_point_takes_the_tile_codes_and_refuses_the_rest():
    """Codes 1 (f32 x, always a workspace) and 2 (bf16 x, a workspace when
    K is split) at any rows; each refuses the other x dtype; the decode
    codes refuse more than 8 rows; code 0 (the GEMV's) and 5 are refused."""
    refuses = _refuses("dequant_matmul_so.cu", "llamago_dequant_matmul_so")
    ws = object()
    for bits in (8, 4):
        for m in (9, 16, 64, 256):
            assert not refuses(bits, 1, 2, m, 1, None) and not refuses(bits, 1, 2, m, 4, ws)
            assert refuses(bits, 1, 2, m, 4, None) and refuses(bits, 0, 2, m, 1, ws)
            assert not refuses(bits, 0, 1, m, 1, ws) and not refuses(bits, 0, 1, m, 4, ws)
            assert refuses(bits, 0, 1, m, 1, None) and refuses(bits, 1, 1, m, 1, ws)
            assert refuses(bits, 1, 3, m, 1, ws) and refuses(bits, 0, 4, m, 1, ws)
            assert all(refuses(bits, xb, code, m, 1, ws) for xb in (0, 1) for code in (0, 5))
    assert refuses(5, 1, 2, 16, 1, ws)


def test_the_split_pass_writes_the_sums_the_tile_stages():
    """`split_x3_sums` writes sums[kb * mp + m], mp = m rounded up to 4, and
    the tile copies a stage's rows from there, 4 rows a 16-byte copy; the
    partials start after the sums."""
    so, h = _src(), _src("tile_tc.cuh")
    assert "sums[(i % K) / 32 * mp + i / K] = t;" in so
    assert "return (size_t)(K / 32) * tc_sums_ld(M);" in so
    assert "sums + sums_elems(M, K), sums, M, K, N" in so
    assert "__host__ __device__ constexpr int tc_sums_ld(int M) { return (M + 3) / 4 * 4; }" in h
    assert "cp_async16(st + SUMS_OFF + tid * 16, xsum + (size_t)kb * mp + m0 + 4 * tid);" in h
    # Q8_0 needs no sums: its f32 x takes the plain split
    assert "split_x3<<<blocks, 256, 0, st>>>(static_cast<const float*>(x), planes, mk);" in so


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [9, 16, 17, 64, 256])
def test_launcher_hands_the_tile_its_code_and_split(monkeypatch, m, bits, dtype):
    """`dequant_matmul_so` on meta tensors above 8 rows: K1's tile codes (2
    for bf16 x, 1 for f32 x), `k9_plan`'s split, and one count in
    `launches_tc` or `launches_f32_tc`."""
    before = {a: getattr(kernels.dequant_matmul_so, a) for a in
              ("launches", "launches_tc", "launches_f32_tc", "launches_decode_tc")}
    calls = _launch_on_meta(monkeypatch, kernels.dequant_matmul_so, "_lib_so", m, bits, dtype)
    bf16 = dtype == torch.bfloat16
    assert calls == [dict(m=m, k=4096, n=4096, bits=bits, x_bf16=int(bf16),
                          form=2 if bf16 else 1,
                          ksplit=kernels.k9_plan(m, 4096, 4096, dtype)[1])]
    so = kernels.dequant_matmul_so
    assert (so.launches - before["launches"], so.launches_tc - before["launches_tc"],
            so.launches_f32_tc - before["launches_f32_tc"],
            so.launches_decode_tc - before["launches_decode_tc"]) == (1, int(bf16),
                                                                      int(not bf16), 0)


# ------------------------------------------------------- the warps' lanes

def _raw_b_frags(stage, cols, t, bits):
    """The B pairs of k16 step t for every lane, the raw integers: int8 as
    K1 builds them, a Q4_0 nibble 0..15 (packed row r: row r in the low
    nibbles, step 0; r + 16 in the high, step 1)."""
    if bits == 8:
        return _b_frags(stage, cols, t, False, 32)
    w = [_word(stage, 2 * TIG + d, cols) for d in (0, 1, 8, 9)]
    return ([_q4_raw_pair(j, 4 * t, w[0], w[1]) for j in range(4)],
            [_q4_raw_pair(j, 4 * t, w[2], w[3]) for j in range(4)])


def split_sums(x: np.ndarray) -> np.ndarray:
    """`split_x3_sums`'s block sums of f32 x [m, K] as [K/32, m]: each lane's
    four values added in order, then the eight lanes of a block by xor
    shuffles (1, 2, 4), all in f32."""
    m, k = x.shape
    v = x.reshape(m, k // 32, 8, 4)
    t = ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]
    for d in (1, 2, 4):
        t = t + t[..., np.arange(8) ^ d]
    return np.ascontiguousarray(t[..., 0].T)


def emulate_so_tc(x: np.ndarray, leaf: dict, rng, f32: bool) -> np.ndarray:
    """so_tc warp by warp over every lane, in numpy: the stage a block's
    copies fill (the weight bytes of its 128 columns, garbage past N; x's
    rows past M repeat row M-1), the raw B pairs (bit for bit), the A
    fragments of bf16 x or of f32 x's three planes, the mma by the PTX
    fragment layout, Q4_0's row sums (bf16 x: the x fragments against a B
    of ones, into their own zeroed sum; f32 x: the split pass's sums), 8
    times them off the block sum, the scale folded once a quant block, the
    epilogue's placement and so_reduce's fixed-order sum of the splits.
    Returns the f32 sums [M, N] before any rounding to bf16."""
    m, k = x.shape
    bits = 8 if "q8" in leaf else 4
    q = leaf["q8"].numpy().view(np.uint8) if bits == 8 else leaf["q4"].numpy()
    wrows = 32 if bits == 8 else 16
    s = leaf["s"].float().numpy()
    n = q.shape[1]
    form, ksplit, _ = kernels.k9_plan(m, k, n, torch.float32 if f32 else torch.bfloat16)
    assert form == ("f32_tc" if f32 else "tensor_core")
    mt = 1 if m <= 16 else 2 if m <= 32 else 4
    ncols = -(-n // 128) * 128
    qpad = np.concatenate([q, rng.integers(0, 256, (q.shape[0], ncols - n), np.uint8)], 1)
    spad = np.concatenate([s, rng.standard_normal((s.shape[0], ncols - n)).astype(np.float32)],
                          1)
    planes = split3(x) if f32 else (x.view(np.uint32) >> np.uint32(16)).astype(np.uint16)[None]
    sums = split_sums(x) if f32 and bits == 4 else None
    bm, units = 16 * mt, k // 32
    per = -(-units // ksplit)
    out = np.zeros((m, ncols), np.float32)
    for n0 in range(0, ncols, 128):
        for m0 in range(0, m, bm):
            rows = [np.minimum(m0 + 16 * i + np.arange(16), m - 1) for i in range(mt)]
            total = None
            for y in range(ksplit):
                res = np.zeros((bm, 128), np.float32)
                for warp in range(4):
                    cols = 32 * warp + 4 * GID
                    acc = np.zeros((mt, 32, 4, 4), np.float32)
                    for u in range(y * per, min((y + 1) * per, units)):
                        stage = qpad[u * wrows:(u + 1) * wrows, n0:n0 + 128]
                        part = np.zeros((mt, 32, 4, 4), np.float32)
                        xsc = np.zeros((mt, 32, 4), np.float32)
                        for t in range(2):
                            b0, b1 = _raw_b_frags(stage, cols, t, bits)
                            for i in range(mt):
                                for p in range(len(planes) - 1, -1, -1):  # lo, mid, hi
                                    a = _a_frag(planes[p], rows[i], u * 32 + 16 * t)
                                    for j in range(4):
                                        _mma(part[i][:, j], a, b0[j], b1[j])
                                    if bits == 4 and not f32:
                                        _mma(xsc[i], a, ONES, ONES)
                        if bits == 4:
                            for i in range(mt):
                                if f32:
                                    xs = (sums[u, rows[i][GID]], sums[u, rows[i][GID + 8]])
                                else:
                                    xs = (xsc[i][:, 0], xsc[i][:, 2])
                                for e in range(4):
                                    off = np.float32(8) * xs[e >> 1]
                                    part[i][:, :, e] = (part[i][:, :, e]
                                                        - off[:, None]).astype(np.float32)
                        sc = spad[u, n0 + 32 * warp + 8 * TIG[:, None] + np.arange(8)[None]]
                        for i in range(mt):
                            _fold(acc[i], part[i], sc)
                    for i in range(mt):
                        _store(res, acc[i], i, warp)
                total = res if total is None else total + res
            valid = min(bm, m - m0)
            out[m0:m0 + valid, n0:n0 + 128] = total[:valid]
    return out[:, :n]


@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("fmt", ["q4:float32", "q4:bfloat16", "q8:float32"])
@pytest.mark.parametrize("m", [9, 16, 17, 64])
def test_emulated_raw_tile_matches_plain(m, fmt, xdt):
    """Every lane of the RAW tile at K = 512 (K split in two), N = 256 (two
    column strips), against the plain version in f32: the raw B pairs, the
    row sums (bf16 x: the ones mma; f32 x: the split pass's), the fold of 8
    times them, three parts for f32 x."""
    k, n = 512, 256
    leaf = _leaf(fmt, k, n, 300 + m)
    f32 = xdt == "float32"
    x = wide_x(m, k, 400 + m)
    if not f32:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert kernels.k9_plan(m, k, n, getattr(torch, xdt))[1] == 2  # the reduce is exercised
    got = emulate_so_tc(x, leaf, np.random.default_rng(m), f32)
    want = kernels.dequant_matmul_so_plain(torch.from_numpy(x), leaf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


def test_emulated_raw_tile_at_a_ragged_width_and_k():
    """Columns past N (garbage in the stage, never stored), 40 rows (rows
    past M repeat row M-1 in two 32-row tiles) and K = 1376 (43 quant
    blocks) in one split, f32 x, Q4_0."""
    k, n, m = 1376, 272, 40
    leaf = _leaf("q4:float32", k, n, 7)
    x = wide_x(m, k, 8)
    got = emulate_so_tc(x, leaf, np.random.default_rng(9), True)
    want = kernels.dequant_matmul_so_plain(torch.from_numpy(x), leaf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


def test_the_offset_is_needed_and_the_sums_are_x_own():
    """Without 8 * sum(x_b) the raw nibbles miss the function by far; the
    split pass's sums differ from f64 sums of x by f32 rounding only."""
    k, n, m = 512, 128, 17
    leaf = _leaf("q4:float32", k, n, 11)
    x = wide_x(m, k, 12)
    want = kernels.dequant_matmul_so_plain(torch.from_numpy(x), leaf).numpy()
    raw = (quant.unpack_q4(leaf["q4"]).float() + 8).numpy().reshape(k // 32, 32, n)
    s = leaf["s"].float().numpy()
    no_offset = np.einsum("mbk,bkn,bn->mn", x.reshape(m, k // 32, 32).astype(np.float64), raw, s)
    assert np.abs(no_offset - want).max() > 100 * F32_TOL * np.abs(want).max()
    exact = x.reshape(m, k // 32, 32).astype(np.float64).sum(-1).T
    got = split_sums(x)
    assert np.abs(got - exact).max() <= 1e-6 * np.abs(x).sum(-1).max()


# ------------------------------------------------------------- against JAX

@contextlib.contextmanager
def jax_k9_at_64():
    """The JAX package's scale-on-output kernel in interpret mode for any
    m <= 64 (the switch at 64), its jit cache cleared around the change."""
    old = jkernels.FORCE_INTERPRET, jkernels.SCALE_ON_OUTPUT_MAX_M
    jkernels.FORCE_INTERPRET, jkernels.SCALE_ON_OUTPUT_MAX_M = True, 64
    jkernels._dequant_matmul_2d.clear_cache()
    try:
        yield
    finally:
        jkernels.FORCE_INTERPRET, jkernels.SCALE_ON_OUTPUT_MAX_M = old
        jkernels._dequant_matmul_2d.clear_cache()


@pytest.mark.parametrize("fmt", ["q8:float32", "q4:float32", "q4:bfloat16"])
@pytest.mark.parametrize("m", [16, 64])
def test_plain_matches_jax_with_the_switch_at_64(m, fmt):
    """K9's plain version (what the CPU takes, and what the card's tile is
    held to) against JAX's `_dequant_matmul_2d` taking its scale-on-output
    kernel in interpret mode, f32 x, within 1e-5 of max|ref|."""
    k, n = 1024, 256
    leaf = _leaf(fmt, k, n, 500 + m)
    x = wide_x(m, k, 600 + m)
    with jax_k9_at_64():
        xj = jnp.asarray(x)
        assert jkernels.can_fuse(xj, _jleaf(leaf))
        want = np.asarray(jax.block_until_ready(jkernels.dequant_matmul(xj, _jleaf(leaf))),
                          np.float32)
    got = kernels.dequant_matmul_so_plain(torch.from_numpy(x), leaf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


def test_tiny_model_prefill_and_decode_with_the_switch_at_64(monkeypatch):
    """The mixed int4 model in the Q4_0 format with the switch at 64 in
    both packages: a prefill of 20 tokens in 2 rows (m = 40, K9 on both
    sides: the port's tile route) and 3 greedy decode steps, logits within
    1e-4 of max|logit|, the greedy tokens equal."""
    jcfg, jp, cfg, tp = _int4_model(monkeypatch, "q4_0", seed=39)
    rows = []
    so = kernels.dequant_matmul_so
    monkeypatch.setattr(kernels, "dequant_matmul_so",
                        lambda x, w: rows.append(x.numel() // x.shape[-1]) or so(x, w))
    toks = np.random.default_rng(40).integers(1, 500, (2, 20)).astype(np.int32)
    with interpret_kernels(so_max_m=64):
        jl, jcache = jllama.forward(jp, jnp.asarray(toks),
                                    JKVCache.create(jcfg, batch=2, layered=True),
                                    jnp.zeros(2, jnp.int32), jcfg, return_all_logits=True)
        tl, cache = llama.forward_impl(tp, torch.from_numpy(toks),
                                       KVCache.create(cfg, batch=2, device="cpu"),
                                       torch.zeros(2, dtype=torch.long), cfg,
                                       return_all_logits=True)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())
        assert torch.argmax(tl, -1).tolist() == np.argmax(jl, -1).tolist()
        assert 40 in rows  # the prefill's projections went through K9
        tt = torch.argmax(tl[:, -1], -1)
        jt = jnp.asarray(tt.numpy(), jnp.int32)
        for pos in range(20, 23):
            jl, jcache = jllama.forward(jp, jt[:, None], jcache,
                                        jnp.full((2,), pos, jnp.int32), jcfg)
            tl, cache = llama.forward_impl(tp, tt[:, None], cache, torch.full((2,), pos), cfg)
            jl = np.asarray(jl)
            np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())
            jt, tt = jnp.argmax(jnp.asarray(jl), -1).astype(jnp.int32), torch.argmax(tl, -1)
            assert tt.tolist() == np.asarray(jt).tolist()
