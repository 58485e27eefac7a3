"""K1's tensor-core form (bf16 x, more than 8 rows): its route, its split of
K and its order of sums, against the JAX package on the CPU.

On the card K1 takes one of four kernels (`ops/kernels.py:k1_form`); the
tensor-core tile computes sum_b s_b * (x_b . q_b) over the 32-row quant
blocks b, the TPU kernel's f32 function with its sums in another order.
Here, without a card, the wrapper takes the plain version; the tests pin
the routing rule, the split plan the launcher hands the kernel, the
function at the prefill row counts against the JAX kernel in interpret
mode, and a torch emulation of the kernel's order of sums against the same
JAX function in f32.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch.ops import kernels, quant

torch.set_num_threads(1)

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


def leaves(bits: int, scale_dtype: str, k: int = 4096, n: int = 128):
    """A Q8_0 or Q4_0 leaf of the port and the same numbers as a JAX leaf."""
    leaf = quant.quantize(torch.from_numpy(rnd((k, n), 30 + bits, 0.1)), bits)
    leaf["s"] = leaf["s"].to(getattr(torch, scale_dtype))  # a file brings f32 scales
    key = "q8" if bits == 8 else "q4"
    jleaf = {key: jnp.asarray(leaf[key].numpy()),
             "s": jnp.asarray(leaf["s"].float().numpy(), scale_dtype)}
    return leaf, jleaf


def jax_k1(x: np.ndarray, jleaf: dict, dtype) -> np.ndarray:
    """The JAX K1 (`_dequant_mm_kernel`) in interpret mode, as f32."""
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    try:
        xj = jnp.asarray(x, dtype)
        assert jkernels.can_fuse(xj, jleaf)
        return np.asarray(jkernels.dequant_matmul(xj, jleaf), np.float32)
    finally:
        jkernels.FORCE_INTERPRET = old


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 9, 16, 17, 64, 100, 256])
def test_k1_form_routes_by_rows_and_dtype(m, dtype):
    bf16 = dtype == torch.bfloat16
    want = (("decode_tc" if bf16 else "f32_decode_tc") if m <= 8 else
            "tensor_core" if bf16 else "f32_tc")
    assert kernels.k1_form(m, dtype) == want


def test_k1_form_codes_match_the_c_entry_point():
    src = (pathlib.Path(kernels.__file__).parents[1] / "csrc" / "dequant_matmul.cu").read_text()
    enum = re.search(r"enum Form \{ kF32Tc = (\d), kTensorCore = (\d), "
                     r"kDecodeTc = (\d), kF32DecodeTc = (\d) \}", src)
    assert enum is not None
    assert [int(v) for v in enum.groups()] == [kernels.K1_FORMS[f] for f in
                                               ("f32_tc", "tensor_core",
                                                "decode_tc", "f32_decode_tc")]


# ------------------------------------------------------------- split plan

def _check_split(m, k, n):
    nb = k // 32
    ksplit, per = kernels.tc_split_for(m, k, n)
    assert ksplit >= 1 and per >= 1
    assert per == -(-nb // ksplit)  # the C side cuts at ceil(nb / ksplit)
    # whole quant blocks, every split non-empty, all of K covered
    spans = [(y * per, min((y + 1) * per, nb)) for y in range(ksplit)]
    assert all(a < b for a, b in spans) and spans[-1][1] == nb
    return ksplit, per


@pytest.mark.parametrize("name,k,n", SHAPES_7B)
def test_tc_split_fills_the_card_at_7b_shapes(name, k, n):
    m = 64
    ksplit, per = _check_split(m, k, n)
    blocks = -(-n // 128) * ksplit
    assert blocks >= 132, (name, ksplit, blocks)
    # a split holds at least 8 quant blocks
    assert per >= 8
    form, ks, ws = kernels.k1_plan(m, k, n, torch.bfloat16)
    assert (form, ks) == ("tensor_core", ksplit)
    assert ws == (ksplit * m * n if ksplit > 1 else 0)


@pytest.mark.parametrize("m", [9, 17, 64, 100, 256])
@pytest.mark.parametrize("k,n", [(32, 16), (96, 4000), (1376, 512), (4096, 4096),
                                 (11008, 4096), (512, 32000)])
def test_tc_split_never_leaves_an_empty_split(m, k, n):
    ksplit, _ = _check_split(m, k, n)
    tiles = -(-n // 128) * -(-m // 64)
    # two output tiles per SM need no split; under that K splits unless
    # fewer than two splits of 8 quant blocks fit
    assert (ksplit == 1) == (tiles >= 264 or k // 32 < 16)


def test_k1_plan_workspace_by_form():
    k, n = 4096, 12288
    # f32 x at decode: the decode form on x's three parts, split as with
    # bf16 x, partials when it splits K and no planes
    ks = kernels.decode_tc_split_for(k, n)[0]
    assert kernels.k1_plan(4, k, n, torch.float32) == ("f32_decode_tc", ks, ks * 4 * n)
    # bf16 x at decode: the tensor-core decode form, partials when it splits K
    assert kernels.k1_plan(4, k, n, torch.bfloat16) == ("decode_tc", ks, ks * 4 * n)
    # K9 above 8 rows takes K1's tile and its split, for either x; with f32
    # x its workspace holds x's block sums [m, K/32] between the planes and
    # the partials
    assert kernels.k9_plan(64, k, n, torch.bfloat16) == ("tensor_core", 6, 6 * 64 * n)
    assert kernels.k9_plan(64, k, n, torch.float32) == (
        "f32_tc", 5, 3 * 64 * k // 2 + 64 * (k // 32) + 5 * 64 * n)
    # the tile with f32 x: x's three bf16 planes, then the partials when it
    # splits K; 96 column strips at m = 64: five splits (480 blocks, a wave
    # of the three an SM holds)
    assert kernels.k1_plan(64, k, n, torch.float32) == ("f32_tc", 5,
                                                         3 * 64 * k // 2 + 5 * 64 * n)
    # the tensor-core tile: partials only when it splits K
    # 96 column strips at m = 64: six splits (576 blocks, 4 per SM)
    assert kernels.k1_plan(64, k, n, torch.bfloat16) == ("tensor_core", 6, 6 * 64 * n)
    assert kernels.k1_plan(256, k, n, torch.bfloat16) == ("tensor_core", 1, 0)


# ---------------------------------------------------------------- function

CASES = [(m, bits, sdt) for m in (16, 17, 64) for bits in (8, 4)
         for sdt in ("float32", "bfloat16")]


@pytest.mark.parametrize("m,bits,scale_dtype", CASES)
def test_k1_bf16_prefill_matches_jax_interpret(m, bits, scale_dtype):
    """The wrapper's CPU route (the plain version) at the prefill rows with
    bf16 x: the function the tensor-core form computes on the card."""
    leaf, jleaf = leaves(bits, scale_dtype)
    x = bf16_values(rnd((m, 4096), 40 + m))
    want = jax_k1(x, jleaf, jnp.bfloat16)
    before = (kernels.dequant_matmul.launches, kernels.dequant_matmul.launches_q4,
              kernels.dequant_matmul.launches_tc)
    got = kernels.dequant_matmul(torch.from_numpy(x).to(torch.bfloat16), leaf)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 128)
    # the CPU takes the plain version: no launch is counted
    assert (kernels.dequant_matmul.launches, kernels.dequant_matmul.launches_q4,
            kernels.dequant_matmul.launches_tc) == before
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())


def tc_order(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """The tensor-core tile's order of sums, in f32: per 32-row quant block
    the exact dot of bf16 x with the integer weights, times the block's
    scale, added up block by block inside each split of `tc_split_for`; the
    splits' partials then added in order (dq_reduce)."""
    m, k = x.shape
    nb = k // 32
    q = (leaf["q8"] if "q8" in leaf else quant.unpack_q4(leaf["q4"])).to(torch.float32)
    n = q.shape[-1]
    # integers of at most 8 bits and bf16 x: every product exact in f32
    part = torch.einsum("mbk,bkn->bmn", x.to(torch.float32).reshape(m, nb, 32),
                        q.reshape(nb, 32, n))
    s = leaf["s"].to(torch.float32)
    ksplit, per = kernels.tc_split_for(m, k, n)
    out = torch.zeros((m, n), dtype=torch.float32)
    for y in range(ksplit):
        acc = torch.zeros((m, n), dtype=torch.float32)
        for b in range(y * per, min((y + 1) * per, nb)):
            acc = acc + s[b] * part[b]
        out = out + acc
    return out


@pytest.mark.parametrize("m,bits,scale_dtype", CASES)
def test_tc_order_stays_within_the_tpu_function(m, bits, scale_dtype):
    """The reordering (scale on each block's f32 dot, K split) against the
    JAX kernel's f32 x * f32(q * s) with f32 sums, before any bf16 output
    rounding: JAX gets the bf16 x values widened to f32, exactly."""
    leaf, jleaf = leaves(bits, scale_dtype)
    x = bf16_values(rnd((m, 4096), 50 + m))
    want = jax_k1(x, jleaf, jnp.float32)
    got = tc_order(torch.from_numpy(x).to(torch.bfloat16), leaf).numpy()
    assert kernels.tc_split_for(m, 4096, 128)[0] > 1  # the splits are exercised
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())
