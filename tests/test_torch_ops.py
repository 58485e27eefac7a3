"""Port parity: ops/basic.py, ops/quant.py and K1 (ops/kernels.py) against
the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the JAX
dequant-matmul runs its Pallas kernel in interpret mode, the port its
plain PyTorch version (the wrapper's CPU route). Comparisons are in f32.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import basic as jbasic
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu.ops import quant as jquant
from llamago_tpu_torch.ops import basic, kernels, quant

torch.set_num_threads(1)


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def to_np(x):
    return x.to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x, w = rnd((2, 5, 64), 0), 1 + rnd((64,), 1, 0.1)
    want = jbasic.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-5)
    got = basic.rms_norm(t(x).to(getattr(torch, dtype)), t(w), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=1e-5)


def test_apply_rope_adjacent_pairs_matches_jax():
    x = rnd((2, 3, 4, 16), 2)
    pos = np.array([[0, 1, 2], [7, 8, 40]], np.int32)
    want = jbasic.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = basic.apply_rope(t(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)
    # adjacent pairs: rotating (x0, x1) only mixes those two lanes
    x1 = x.copy()
    x1[..., 2:] = 0
    got1 = to_np(basic.apply_rope(t(x1), torch.from_numpy(pos)))
    assert np.all(got1[..., 2:] == 0)


def test_linear_and_swiglu_match_jax():
    x = rnd((3, 64), 3)
    w1, w2, w3 = rnd((64, 96), 4, 0.1), rnd((96, 64), 5, 0.1), rnd((64, 96), 6, 0.1)
    np.testing.assert_allclose(to_np(basic.linear(t(x), t(w1))),
                               np.asarray(jbasic.linear(jnp.asarray(x), jnp.asarray(w1))),
                               atol=1e-5)
    want = jbasic.swiglu(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(w3))
    got = basic.swiglu(t(x), t(w1), t(w2), t(w3))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", [(256, 64), (3, 64, 32)])
def test_quantize_q8_bit_exact(shape):
    w = rnd(shape, 7)
    w[..., :32, 0] = 0.0  # an all-zero block: scale 0, q 0
    want = jquant.quantize(jnp.asarray(w), bits=8)
    got = quant.quantize(t(w), bits=8)
    assert got["q8"].dtype == torch.int8 and got["s"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_equal(to_np(got["s"]), np.asarray(want["s"], np.float32))
    np.testing.assert_array_equal(to_np(quant.dequantize(got)),
                                  np.asarray(jquant.dequantize(want)))


def test_dequantize_keeps_f32_file_scales():
    q = np.random.default_rng(8).integers(-127, 128, (64, 32)).astype(np.int8)
    s = rnd((2, 32), 9, 0.01)
    want = jquant.dequantize({"q8": jnp.asarray(q), "s": jnp.asarray(s)})
    got = quant.dequantize({"q8": torch.from_numpy(q), "s": t(s)})
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_lm_head_pad_and_slice():
    assert quant.lm_head_pad_cols(32000) == jquant.lm_head_pad_cols(32000) == 768
    assert quant.lm_head_padded_cols(32000) == 32768
    assert quant.lm_head_pad_cols(512) == 0
    w = rnd((64, 4000), 10)
    got = quant.pad_lm_head(quant.quantize(t(w)), vocab_size=4000)
    want = jquant.pad_lm_head(jquant.quantize(jnp.asarray(w)), vocab_size=4000)
    assert tuple(got["q8"].shape) == want["q8"].shape == (64, 4096)
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    # pad columns dequantize to exactly zero
    assert not to_np(quant.dequantize(got))[:, 4000:].any()
    # a head wider than the vocab is left alone
    assert quant.pad_lm_head(quant.quantize(t(w)), vocab_size=3999)["q8"].shape[1] == 4000


@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 4, 16, 64])
def test_k1_plain_matches_jax_interpret(m, scale_dtype):
    k, n = 256, 128
    w = rnd((k, n), 11, 0.1)
    x = rnd((m, k), 12)
    leaf = jquant.quantize(jnp.asarray(w), bits=8)
    s = np.asarray(leaf["s"], np.float32)
    q8 = np.asarray(leaf["q8"])
    jleaf = {"q8": jnp.asarray(q8), "s": jnp.asarray(s, scale_dtype)}
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    try:
        assert jkernels.can_fuse(jnp.asarray(x), jleaf)
        want = np.asarray(jkernels.dequant_matmul(jnp.asarray(x), jleaf))
    finally:
        jkernels.FORCE_INTERPRET = old
    tleaf = {"q8": torch.from_numpy(q8.copy()), "s": t(s).to(getattr(torch, scale_dtype))}
    launches = kernels.dequant_matmul.launches
    got = to_np(kernels.dequant_matmul(t(x), tleaf))
    assert kernels.dequant_matmul.launches == launches  # the CPU takes the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_k1_quant_matmul_leading_dims_and_dtype():
    w, x = rnd((64, 96), 13, 0.1), rnd((2, 3, 64), 14)
    leaf = quant.quantize(t(w))
    got = quant.quant_matmul(t(x).to(torch.bfloat16), leaf)
    assert got.shape == (2, 3, 96) and got.dtype == torch.bfloat16
    ref = t(x).to(torch.bfloat16).float() @ quant.dequantize(leaf)
    np.testing.assert_allclose(to_np(got), ref.numpy(), rtol=1e-2, atol=1e-2)


def test_k1_wrapper_rejects_other_devices():
    leaf = quant.quantize(t(rnd((64, 32), 15)))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.dequant_matmul(torch.zeros((1, 64), device="meta"), leaf)


@pytest.mark.parametrize("case", ["k_mismatch", "n_not_16", "x_dtype", "noncontig"])
def test_k1_cuda_arg_checks_reject_bad_inputs(case):
    """The checks the wrapper runs before a launch (pure Python on shapes,
    dtypes and layout, so they run here on CPU tensors)."""
    x = torch.zeros((4, 64))
    q = torch.zeros((64, 32), dtype=torch.int8)
    s = torch.zeros((2, 32), dtype=torch.bfloat16)
    kernels._check_cuda_args(x, q, s)  # well-formed
    if case == "k_mismatch":
        x = torch.zeros((4, 96))
    elif case == "n_not_16":
        q, s = torch.zeros((64, 40), dtype=torch.int8), torch.zeros((2, 40))
    elif case == "x_dtype":
        x = x.half()
    else:
        q = torch.zeros((32, 64), dtype=torch.int8).T
    with pytest.raises(ValueError):
        kernels._check_cuda_args(x, q, s)


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    from llamago_tpu_torch.ops import _build

    path = _build.lib_path("dequant_matmul")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert pathlib.Path(_build.BUILD_DIR).name == "build"
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    (tmp_path / "dequant_matmul.cu").write_text("// another source\n")
    assert _build.lib_path("dequant_matmul") != path  # a changed source builds anew
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
