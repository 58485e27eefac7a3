"""K6's tensor-core form (bf16 x above `_W4X8_A8_MAX_M` rows): its route, its
split of K and its order of sums, against the JAX package on the CPU; and
the build's hash over the headers a CUDA source includes.

On the card a w4x8 matmul takes one of three kernels
(`ops/kernels.py:w4x8_form`); the tensor-core tile computes sum_g s_g *
(x_g . q_g) over the 128-row groups g, the TPU kernel's f32 function with
its sums in another order. Here, without a card, the wrapper takes the plain
version; the tests pin the routing rule, the split plan the launcher hands
the kernel, the function at the prefill row counts against the JAX kernel in
interpret mode, and a torch emulation of the kernel's order of sums against
the same JAX function in f32.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch.ops import _build, kernels, quant

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).parents[1] / "csrc"
# the 7B int4 projections (name, K, N) chip_smoke times; the head unpadded
SHAPES_7B = (("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w13", 4096, 22016),
             ("w2", 11008, 4096), ("lm_head", 4096, 32000))
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


def leaves(k: int, n: int, seed: int = 60):
    """A w4x8 leaf of the port and the same numbers as a JAX leaf."""
    leaf = quant.quantize_w4x8(torch.from_numpy(rnd((k, n), seed, 0.1)))
    jleaf = {"q4x": jnp.asarray(leaf["q4x"].numpy()),
             "s": jnp.asarray(leaf["s"].float().numpy(), jnp.bfloat16)}
    return leaf, jleaf


def jax_k6(x: np.ndarray, jleaf: dict, dtype) -> np.ndarray:
    """The JAX w4x8 matmul in interpret mode (`_w4x8_stream_kernel` above
    16 rows), as f32."""
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
@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 32, 64, 100, 256])
def test_w4x8_form_routes_by_rows_and_dtype(m, dtype):
    want = ("a8" if m <= 16 else
            "tensor_core" if dtype == torch.bfloat16 else "f32_tc")
    assert kernels.w4x8_form(m, dtype) == want


@pytest.mark.parametrize("a8_max,m,want", [
    (4, 1, "tensor_core"),  # the TPU launcher pads m up to 8: above 4 always
    (8, 8, "a8"), (8, 9, "tensor_core"),
    (32, 32, "a8"), (32, 33, "tensor_core"),
])
def test_w4x8_form_follows_the_a8_threshold(monkeypatch, a8_max, m, want):
    monkeypatch.setattr(kernels, "_W4X8_A8_MAX_M", a8_max)
    assert kernels.w4x8_form(m, torch.bfloat16) == want
    assert kernels.w4x8_form(m, torch.float32) == ("a8" if want == "a8" else "f32_tc")


def test_w4x8_form_codes_match_the_c_entry_point():
    src = (CSRC / "w4x8_matmul.cu").read_text()
    enum = re.search(r"enum W4x8Form \{ kA8 = (\d), kF32Tc = (\d), kTensorCore = (\d) \}",
                     src)
    assert enum is not None
    assert [int(v) for v in enum.groups()] == [kernels.W4X8_FORMS.index(f) for f in
                                               ("a8", "f32_tc", "tensor_core")]


# ------------------------------------------------------------- split plan

def _check_split(m, k, n):
    """K6's split as the launcher plans it: whole 128-groups, every split
    non-empty, all of K covered, the C side's cut at ceil(G / ksplit)."""
    groups = k // 128
    form, ksplit, ws = kernels.w4x8_plan(m, k, n, torch.bfloat16)
    per = -(-groups // ksplit)
    spans = [(y * per, min((y + 1) * per, groups)) for y in range(ksplit)]
    assert all(a < b for a, b in spans) and spans[-1][1] == groups
    assert ws == (ksplit * m * n if ksplit > 1 else 0)
    return form, ksplit, per


@pytest.mark.parametrize("name,k,n", SHAPES_7B)
def test_w4x8_tc_split_fills_the_card_at_7b_shapes(name, k, n):
    m = 64
    form, ksplit, per = _check_split(m, k, n)
    assert form == "tensor_core"
    blocks = -(-n // 128) * ksplit
    # at least two blocks per SM, none past one wave of three
    assert 2 * 132 <= blocks, (name, ksplit, blocks)
    assert -(-n // 128) * (ksplit - 1) < 3 * 132
    assert per >= 2  # a split holds at least 256 rows of K


@pytest.mark.parametrize("m", [1, 17, 64, 100, 256])
@pytest.mark.parametrize("k,n", [(128, 16), (384, 4000), (1408, 512), (4096, 4096),
                                 (11008, 4096), (512, 32000)])
def test_w4x8_tc_split_never_leaves_an_empty_split(monkeypatch, m, k, n):
    monkeypatch.setattr(kernels, "_W4X8_A8_MAX_M", 0)  # every m takes K6 here
    _, ksplit, _ = _check_split(m, k, n)
    tiles = -(-n // 128) * -(-m // 64)
    # two output tiles per SM need no split; under that K splits unless
    # fewer than two splits of 2 groups fit
    assert (ksplit == 1) == (tiles >= 264 or k // 128 < 4)


def test_w4x8_plan_workspace_by_form():
    k, n = 4096, 12288
    # K5: one f32 partial per split, always (its reduce writes the output)
    ks = kernels.a8_split_for(4, k, n)[0]
    assert kernels.w4x8_plan(4, k, n, torch.bfloat16) == ("a8", ks, ks * 4 * n)
    # the tile with f32 x: x's three bf16 planes, then the partials; 32-row
    # tiles, two a column strip at m = 64: three splits (576 blocks)
    assert kernels.w4x8_plan(64, k, n, torch.float32) == ("f32_tc", 3,
                                                          3 * 64 * k // 2 + 3 * 64 * n)
    # the tensor-core tile: partials only when it splits K; 96 column
    # strips at m = 64: five splits (480 blocks), none at m = 256 (384)
    assert kernels.w4x8_plan(64, k, n, torch.bfloat16) == ("tensor_core", 5, 5 * 64 * n)
    assert kernels.w4x8_plan(256, k, n, torch.bfloat16) == ("tensor_core", 1, 0)
    # K1's plan is its own: 32-row units, four blocks per SM
    assert kernels.tc_split_for(64, k, n) == (6, 22)


# ---------------------------------------------------------------- function

@pytest.mark.parametrize("m", [17, 32, 64, 100])
def test_w4x8_bf16_prefill_matches_jax_interpret(m):
    """The wrapper's CPU route (the plain version) at the prefill rows with
    bf16 x: the function the tensor-core form computes on the card."""
    leaf, jleaf = leaves(1024, 256)
    x = bf16_values(rnd((m, 1024), 70 + m))
    want = jax_k6(x, jleaf, jnp.bfloat16)
    counts = (kernels.w4x8_matmul.launches_a8, kernels.w4x8_matmul.launches_stream,
              kernels.w4x8_matmul.launches_tc)
    got = kernels.dequant_matmul(torch.from_numpy(x).to(torch.bfloat16), leaf)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 256)
    # the CPU takes the plain version: no launch is counted
    assert (kernels.w4x8_matmul.launches_a8, kernels.w4x8_matmul.launches_stream,
            kernels.w4x8_matmul.launches_tc) == counts
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())


def tc_order(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """The tensor-core tile's order of sums, in f32: per 128-row group the
    dot of bf16 x with the int4 weights, times the group's scale (row 2g of
    the duplicated rows), added up group by group inside each split of the
    launcher's plan (cut at ceil(G / ksplit), as the C side cuts it); the
    splits' partials then added in order (w4x8_reduce)."""
    m, k = x.shape
    groups = k // 128
    q = quant.unpack_w4x8(leaf["q4x"]).to(torch.float32)
    n = q.shape[-1]
    # int4 weights and bf16 x: every product exact in f32
    part = torch.einsum("mgk,gkn->gmn", x.to(torch.float32).reshape(m, groups, 128),
                        q.reshape(groups, 128, n))
    s = leaf["s"][0::2].to(torch.float32)
    _, ksplit, _ = kernels.w4x8_plan(m, k, n, x.dtype)
    per = -(-groups // ksplit)
    out = torch.zeros((m, n), dtype=torch.float32)
    for y in range(ksplit):
        acc = torch.zeros((m, n), dtype=torch.float32)
        for g in range(y * per, min((y + 1) * per, groups)):
            acc = acc + s[g] * part[g]
        out = out + acc
    return out


@pytest.mark.parametrize("m,k,n", [(17, 1024, 256), (32, 1024, 256), (64, 1024, 256),
                                   (100, 1024, 256), (17, 11008, 1664)])
def test_w4x8_tc_order_stays_within_the_tpu_function(m, k, n):
    """The reordering (scale on each group's f32 dot, K split) against the
    JAX kernel's f32 x * f32(q * s) with f32 sums, before any bf16 output
    rounding: JAX gets the bf16 x values widened to f32, exactly. K = 11008
    (86 groups) ends in a shorter split."""
    leaf, jleaf = leaves(k, n, 61)
    x = bf16_values(rnd((m, k), 80 + m))
    want = jax_k6(x, jleaf, jnp.float32)
    groups = k // 128
    _, ksplit, _ = kernels.w4x8_plan(m, k, n, torch.bfloat16)
    per = -(-groups // ksplit)
    assert ksplit > 1  # the splits are exercised
    if k == 11008:
        assert groups % per != 0  # a ragged last split
    got = tc_order(torch.from_numpy(x).to(torch.bfloat16), leaf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


# ------------------------------------------------------------------ build

def test_library_path_follows_every_included_header(monkeypatch, tmp_path):
    """A header's bytes, through a header it includes too, change the
    library's path, so a changed `.cuh` never loads a library built before;
    a file no source includes does not."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b, first\n")
    (tmp_path / "c.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert _build.source_files("k") == ["k.cu", "a.cuh", "b.cuh"]
    first = _build.lib_path("k")
    (tmp_path / "c.cuh").write_text("// not included, changed\n")
    assert _build.lib_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, changed\n")
    changed = _build.lib_path("k")
    assert changed != first and changed.endswith(".so")
    (tmp_path / "b.cuh").write_text("// b, first\n")
    assert _build.lib_path("k") == first


def test_tensor_core_tiles_share_one_copy_of_the_ptx_wrappers():
    """K1's and K6's tiles (and K7 and the lab, which use some of them)
    include tc_common.cuh, and no source defines one of its wrappers again."""
    assert {"dequant_matmul", "w4x8_matmul", "attn_prefill", "lab_matmul"} <= {
        n for n in _build.SOURCES if "tc_common.cuh" in _build.source_files(n)}
    header = (CSRC / "tc_common.cuh").read_text()
    for fn in ("cp_async16", "cp_async_commit", "cp_async_wait", "mma_bf16", "ldmatrix_x4",
               "pack_bf16", "smem_scales8"):
        pattern = re.compile(rf"__device__ __forceinline__ \w+ {fn}\(")
        assert pattern.search(header), fn
        assert not any(pattern.search(p.read_text()) for p in CSRC.glob("*.cu")), fn
