"""Port parity: K2 (ops/attention.py flash_attention) and attention_math
against the JAX package on the CPU.

The JAX kernel runs in interpret mode; the port takes its plain PyTorch
version (the wrapper's CPU route). The cache spans several 256-row
S-blocks and the per-batch start positions include 0 and S-1. Tolerance
2e-5 absolute, as the JAX package's own kernel test uses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import attention as jattention
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch.ops import attention

torch.set_num_threads(1)

S = 768  # three 256-row S-blocks


@pytest.fixture(autouse=True)
def _interpret_kernels():
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    yield
    jkernels.FORCE_INTERPRET = old


def _inputs(b, t, h, kv, hd, s, pos0, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    pos = (np.asarray(pos0, np.int32)[:, None] + np.arange(t, dtype=np.int32)[None, :])
    return q, k, v, pos


@pytest.mark.parametrize("t", [1, 16, 32])
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_k2_plain_matches_jax_kernel(t, h, kv):
    q, k, v, pos = _inputs(3, t, h, kv, 16, S, [0, 300, S - 1], seed=t + h)
    jq, jk, jv, jp = map(jnp.asarray, (q, k, v, pos))
    assert jattention.can_fuse_attention(jq, jk)
    want = np.asarray(jattention.flash_attention(jq, jk, jv, jp))
    launches = attention.flash_attention.launches
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v, pos)))
    assert attention.flash_attention.launches == launches  # plain version on the CPU
    assert got.shape == (3, t, h * 16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_k2_plain_bf16_rounds_p_like_jax():
    q, k, v, pos = _inputs(2, 1, 4, 4, 16, 512, [5, 400], seed=21)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jattention.flash_attention(jq, jk, jv, jnp.asarray(pos)), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention.flash_attention(tq, tk, tv, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    # outputs are bf16: one rounding step apart at most
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("t,pos0", [(1, [3, 60]), (40, [0, 8])])
def test_attention_math_matches_jax(t, pos0):
    q, k, v, pos = _inputs(2, t, 4, 2, 16, 64, pos0, seed=t)
    want = np.asarray(jattention.attention_math(*map(jnp.asarray, (q, k, v, pos))))
    got = attention.attention_math(*map(torch.from_numpy, (q, k, v, pos)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_k2_plain_equals_attention_math():
    """Online softmax over S-blocks == one masked softmax."""
    q, k, v, pos = _inputs(2, 8, 4, 1, 16, 512, [0, 333], seed=3)
    args = tuple(map(torch.from_numpy, (q, k, v, pos)))
    np.testing.assert_allclose(attention.flash_attention(*args).numpy(),
                               attention.attention_math(*args).numpy(), atol=2e-5)


@pytest.mark.parametrize("case", ["t", "hd", "dtype", "pos0", "cache"])
def test_k2_cuda_arg_checks_reject_unsupported_shapes(case):
    b, t, kv, g, hd, s = 2, 1, 2, 2, 64, 256
    q5 = torch.zeros((b, t, kv, g, hd), dtype=torch.bfloat16)
    kc = torch.zeros((b, kv, s, hd), dtype=torch.bfloat16)
    pos0 = torch.zeros(b, dtype=torch.int32)
    attention._check_cuda_args(q5, kc, kc, pos0)  # well-formed
    if case == "t":
        q5 = torch.zeros((b, 33, kv, g, hd), dtype=torch.bfloat16)
    elif case == "hd":
        q5, kc = q5[..., :48].contiguous(), kc[..., :48].contiguous()
    elif case == "dtype":
        q5, kc = q5.half(), kc.half()
    elif case == "pos0":
        pos0 = pos0.long()
    else:
        kc = torch.zeros((b, kv + 1, s, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention._check_cuda_args(q5, kc, kc, pos0)
