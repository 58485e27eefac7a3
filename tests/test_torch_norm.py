"""Port parity: K10 (ops/kernels.py fused_rms_norm) and its switch against
the JAX package on the CPU.

The JAX kernel runs in interpret mode; the port takes K10's plain PyTorch
version (the wrapper's CPU route). Inputs are made from numpy seeds.
Tolerances: f32 rtol 1e-6 (the f32 mean of squares is summed in another
order, and rsqrt is rounded differently), bf16 within one bf16 step (2^-7
of the value), since both round the same f32 product once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import basic as jbasic
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch.ops import basic, kernels

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    yield
    jkernels.FORCE_INTERPRET = old


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setattr(jkernels, "USE_FUSED_NORM", True)
    monkeypatch.setattr(kernels, "USE_FUSED_NORM", True)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("lead", [(1,), (2, 5), (3, 1, 8)], ids=["1", "2x5", "3x1x8"])
def test_k10_plain_matches_jax_kernel_f32(d, lead):
    x, w = _inputs((*lead, d), seed=d + len(lead))
    want = np.asarray(jkernels.fused_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    launches = kernels.fused_rms_norm.launches
    got = kernels.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    assert kernels.fused_rms_norm.launches == launches  # plain version on the CPU
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_k10_plain_matches_jax_kernel_bf16_within_one_step(d, w_dtype):
    x, w = _inputs((4, 7, d), seed=d)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w).astype(w_dtype)
    want = np.asarray(jkernels.fused_rms_norm(jx, jw, 1e-5), np.float32)
    got = kernels.fused_rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                                 torch.from_numpy(w).to(getattr(torch, w_dtype)), 1e-5)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7).all()
    assert (got == want).mean() > 0.98  # and nearly all of them to the bit


def test_k10_rounds_once_where_rms_norm_rounds_twice():
    """In bf16 K10 is another function than the unfused rms_norm: the plain
    version follows the kernel (f32 throughout, one rounding)."""
    x, w = _inputs((16, 128), seed=3)
    tx, tw = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w)
    f32 = kernels.fused_rms_norm_plain(tx.float(), tw)  # exact input, f32 result
    once = kernels.fused_rms_norm_plain(tx, tw)
    twice = basic.rms_norm(tx, tw)
    assert torch.equal(once, f32.to(torch.bfloat16))
    assert not torch.equal(once, twice)
    assert (once.float() - f32).abs().mean() < (twice.float() - f32).abs().mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_takes_k10_when_switched_on_as_jax_does(fused, dtype):
    x, w = _inputs((2, 3, 64), seed=5)
    jx = jnp.asarray(x).astype(dtype)
    assert jkernels.can_fuse_norm(jx)
    want = np.asarray(jbasic.rms_norm(jx, jnp.asarray(w), 1e-5), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert kernels.can_fuse_norm(tx)
    launches = kernels.fused_rms_norm.launches
    got = basic.rms_norm(tx, torch.from_numpy(w), 1e-5)
    assert kernels.fused_rms_norm.launches == launches
    assert torch.equal(got, kernels.fused_rms_norm_plain(tx, torch.from_numpy(w), 1e-5))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    else:
        assert (np.abs(got.float().numpy() - want) <= np.abs(want) * 2.0 ** -7).all()


def test_switch_is_off_by_default_in_both_packages():
    assert kernels.USE_FUSED_NORM is False and jkernels.USE_FUSED_NORM is False
    x, w = _inputs((2, 64), seed=6)
    assert not jkernels.can_fuse_norm(jnp.asarray(x))
    assert not kernels.can_fuse_norm(torch.from_numpy(x))
    want = np.asarray(jbasic.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = basic.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype,want", [("bfloat16", True), ("float32", True),
                                        ("float16", False), ("float64", False)])
def test_gate_off_the_cpu_takes_what_the_kernel_takes(fused, dtype, want):
    """"meta" stands for the card: the gate reads device type and dtype only.
    Any d and any row count pass (the TPU's d % 128 rule is not carried over)."""
    x = torch.empty((3, 100), dtype=getattr(torch, dtype), device="meta")
    assert kernels.can_fuse_norm(x) == want
    assert kernels.can_fuse_norm(torch.empty((3, 100), dtype=getattr(torch, dtype)))
    assert not kernels.can_fuse_norm(torch.empty((0, 100), dtype=torch.float32))


def test_wrapper_raises_off_the_cpu_and_the_card():
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_rms_norm(torch.empty((2, 64), device="meta"),
                               torch.empty((64,), device="meta"))
