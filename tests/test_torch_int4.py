"""Port parity: int4 weights (Q4_0, Q4_1, w4x8) against the JAX package on
the CPU.

Inputs are made with numpy from a seed and fed to both packages. The
quantizers, packers and `dequantize` agree bit for bit. The JAX matmul
kernels (K1 bits=4, K5, K6, K9) run in interpret mode
(`llamago_tpu.ops.kernels.FORCE_INTERPRET`): without it JAX off the TPU
dequantizes and multiplies in x.dtype, which has no activation
quantization and is another function than K5. The port's wrappers take
their plain PyTorch versions on CPU tensors. Sums are f32 in both, taken
in another order, so outputs agree to 1e-5 of the largest reference value
(f32 x) or to one bf16 rounding (bf16 x).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.checkpoint.ggjt import read_ggjt as jread_ggjt
from llamago_tpu.checkpoint.quant_file import dequantize_rows as jdequantize_rows
from llamago_tpu.config import GenerateConfig as JGen
from llamago_tpu.config import ModelConfig as JModelConfig
from llamago_tpu.models import llama as jllama
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu.ops import quant as jquant
from llamago_tpu.runtime.engine import Engine as JEngine
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu_torch.checkpoint import params
from llamago_tpu_torch.checkpoint.ggjt import read_ggjt, write_ggjt
from llamago_tpu_torch.checkpoint.quant_file import dequantize_rows, quantize_ggjt
from llamago_tpu_torch.config import MODEL_PRESETS, GenerateConfig, ModelConfig
from llamago_tpu_torch.models import llama
from llamago_tpu_torch.ops import basic, kernels, quant
from llamago_tpu_torch.runtime.engine import Engine
from llamago_tpu_torch.runtime.kv_cache import KVCache
from llamago_tpu_torch.tokenizer import Vocab

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)

F32_TOL = 1e-5  # of max|ref|: f32 sums in another order
BF16_TOL = 8e-3  # of max|ref|: one bf16 rounding of the output


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def to_np(x):
    return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()


def jnp_leaf(leaf):
    """A port leaf (torch) as JAX arrays, dtypes kept."""
    def conv(a):
        if a.dtype == torch.bfloat16:
            return jnp.asarray(a.float().numpy(), jnp.bfloat16)
        return jnp.asarray(a.numpy())
    return {k: conv(v) for k, v in leaf.items()}


def assert_leaf_equal(got, want):
    """A port leaf (torch) against a JAX leaf: keys, shapes, dtypes, bits."""
    assert sorted(got) == sorted(want)
    for k in got:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k], np.float32)
                                      if want[k].dtype == jnp.bfloat16 else np.asarray(want[k]))


def assert_tree_equal(got, want):
    is_leaf = quant.is_quantized
    flat_g = jax.tree.leaves(got, is_leaf=is_leaf)
    flat_w = jax.tree.leaves(want, is_leaf=jquant.is_quantized)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        if isinstance(g, dict):
            assert_leaf_equal(g, w)
        else:
            assert_leaf_equal({"x": g}, {"x": w})


@contextlib.contextmanager
def interpret_kernels(so_max_m=None):
    """Run the JAX Pallas kernels in interpret mode; with `so_max_m`, switch
    the scale-on-output kernel on in both packages. JAX reads that switch
    while it traces `_dequant_matmul_2d`, so its jit cache is cleared."""
    old = jkernels.FORCE_INTERPRET, jkernels.SCALE_ON_OUTPUT_MAX_M, kernels.SCALE_ON_OUTPUT_MAX_M
    jkernels.FORCE_INTERPRET = True
    if so_max_m is not None:
        jkernels.SCALE_ON_OUTPUT_MAX_M = kernels.SCALE_ON_OUTPUT_MAX_M = so_max_m
        jkernels._dequant_matmul_2d.clear_cache()
    try:
        yield
    finally:
        (jkernels.FORCE_INTERPRET, jkernels.SCALE_ON_OUTPUT_MAX_M,
         kernels.SCALE_ON_OUTPUT_MAX_M) = old
        if so_max_m is not None:
            jkernels._dequant_matmul_2d.clear_cache()


# ------------------------------------------------- quantizers and packers


def _weight(shape, seed):
    w = rnd(shape, seed)
    w[..., :32, 0] = 0.0  # an all-zero block: scale 0
    w[..., 32:64, 1] = np.abs(w[..., 32:64, 1])  # a positive extreme: negative scale
    return w


@pytest.mark.parametrize("shape", [(256, 64), (3, 128, 32)])
def test_quantize_q4_bit_exact(shape):
    w = _weight(shape, 1)
    got, want = quant.quantize(t(w), bits=4), jquant.quantize(jnp.asarray(w), bits=4)
    assert got["q4"].shape == (*shape[:-2], shape[-2] // 2, shape[-1])
    assert_leaf_equal(got, want)
    np.testing.assert_array_equal(to_np(quant.unpack_q4(got["q4"])),
                                  np.asarray(jquant.unpack_q4(want["q4"])))
    np.testing.assert_array_equal(to_np(quant.dequantize(got)),
                                  np.asarray(jquant.dequantize(want)))


@pytest.mark.parametrize("shape", [(256, 64), (3, 128, 32)])
def test_quantize_w4x8_bit_exact(shape):
    w = _weight(shape, 2)
    got, want = quant.quantize_w4x8(t(w)), jquant.quantize_w4x8(jnp.asarray(w))
    assert got["s"].shape == (*shape[:-2], shape[-2] // 64, shape[-1])  # duplicated rows
    assert torch.equal(got["s"][..., 0::2, :], got["s"][..., 1::2, :])
    assert_leaf_equal(got, want)
    unpacked = quant.unpack_w4x8(got["q4x"])
    assert unpacked.dtype == torch.int8 and -8 <= int(unpacked.min()) and int(unpacked.max()) <= 7
    np.testing.assert_array_equal(to_np(unpacked), np.asarray(jquant.unpack_w4x8(want["q4x"])))
    np.testing.assert_array_equal(to_np(quant.dequantize(got)),
                                  np.asarray(jquant.dequantize(want)))


def test_quantize_bf16_input_and_dtype_bit_exact():
    w = rnd((128, 32), 3)
    wb = jnp.asarray(w, jnp.bfloat16)
    tb = t(w).to(torch.bfloat16)
    assert_leaf_equal(quant.quantize(tb, 4), jquant.quantize(wb, 4))
    assert_leaf_equal(quant.quantize_w4x8(tb), jquant.quantize_w4x8(wb))
    leaf = quant.quantize_w4x8(tb)
    got = quant.dequantize(leaf, torch.bfloat16)
    want = jquant.dequantize(jquant.quantize_w4x8(wb), jnp.bfloat16)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("fmt", ["q4", "q4x"])
def test_sign_trick_takes_the_first_of_equal_extremes(fmt):
    """A block holding +a and -a as its extremes: both frameworks' argmax
    takes the first, which decides the scale's sign."""
    w = rnd((128, 4), 4, 0.1)
    w[3, 0], w[9, 0] = 2.0, -2.0  # +a first: d = -0.25
    w[3, 1], w[9, 1] = -2.0, 2.0  # -a first: d = +0.25
    if fmt == "q4":
        got, want = quant.quantize(t(w), 4), jquant.quantize(jnp.asarray(w), 4)
    else:
        got, want = quant.quantize_w4x8(t(w)), jquant.quantize_w4x8(jnp.asarray(w))
    assert got["s"][0, 0].item() == -0.25 and got["s"][0, 1].item() == 0.25
    assert_leaf_equal(got, want)


def test_dequantize_q4_1_and_f32_file_scales_bit_exact():
    rng = np.random.default_rng(5)
    q4 = rng.integers(0, 256, (64, 48)).astype(np.uint8)
    s, m = rnd((4, 48), 6, 0.01), rnd((4, 48), 7, 0.1)
    for leaf in ({"q4": q4, "s": s}, {"q4": q4, "s": s, "m": m}):
        want = jquant.dequantize({k: jnp.asarray(v) for k, v in leaf.items()})
        got = quant.dequantize({k: t(v) for k, v in leaf.items()})
        np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_w4x8_from_leaf_bit_exact_and_passthrough():
    w = rnd((256, 64), 8)
    q4 = quant.quantize(t(w), 4)
    got = quant.w4x8_from_leaf(q4)
    want = jquant.w4x8_from_leaf(jquant.quantize(jnp.asarray(w), 4))
    assert "q4x" in got and got["s"].shape == (4, 64)
    assert_leaf_equal(got, want)
    q41 = dict(q4, m=torch.zeros_like(q4["s"]))
    assert quant.w4x8_from_leaf(q41) is q41  # Q4_1 stays
    odd = quant.quantize(t(rnd((96, 16), 9)), 4)
    assert quant.w4x8_from_leaf(odd) is odd  # K % 128 != 0 stays Q4_0
    q8 = quant.quantize(t(w), 8)
    assert quant.w4x8_from_leaf(q8) is q8


def test_pad_lm_head_leaves_int4_heads_alone():
    w = t(rnd((128, 4000), 10))
    for leaf in (quant.quantize(w, 4), quant.quantize_w4x8(w)):
        assert quant.pad_lm_head(leaf, vocab_size=4000) is leaf


@pytest.mark.parametrize("env,device,want", [
    (None, "cpu", "q4_0"), (None, "cuda", "w4x8"), (None, "cuda:0", "w4x8"),
    ("w4x8", "cpu", "w4x8"), ("q4_0", "cuda", "q4_0"), ("other", "cpu", "q4_0"),
])
def test_int4_exec_format_by_device_and_env(monkeypatch, env, device, want):
    if env is None:
        monkeypatch.delenv("LLAMAGO_INT4_EXEC", raising=False)
    else:
        monkeypatch.setenv("LLAMAGO_INT4_EXEC", env)
    assert quant.int4_exec_format(device) == want
    if device == "cpu":  # the JAX rule off the accelerator
        assert jquant.int4_exec_format() == want


# ------------------------------------------------------------ the kernels


def test_k5_activation_quantization_bit_exact():
    """xq and sx against the JAX launcher's expressions
    (llamago_tpu/ops/kernels.py:436-443), compiled as the launcher compiles
    them: amax / 127.0 becomes a product, x / sx stays a division, round is
    half to even."""
    m, k = 16, 512
    x = rnd((m, k), 11, 3.0)
    x[2, 128:256] = 0.0  # a zero group: sx = 1
    x[3, :4] = [0.5, 1.5, 2.5, -0.5]  # ties once the group's amax is 127
    x[3, 4] = 127.0
    x[3, 5:128] *= 0.01

    @jax.jit
    def launcher(x):
        groups = k // 128
        x3 = x.astype(jnp.float32).reshape(m, groups, 128).transpose(1, 0, 2)
        amax = jnp.max(jnp.abs(x3), axis=2)
        sx = jnp.where(amax > 0, amax / 127.0, 1.0).astype(jnp.float32)
        xq = jnp.clip(jnp.round(x3 / sx[:, :, None]), -127, 127).astype(jnp.int8)
        return xq.transpose(1, 0, 2).reshape(m, k), sx.T

    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jxq, jsx = launcher(jnp.asarray(x, jdt))
        xq, sx = kernels.quantize_activations_a8(t(x).to(dt))
        assert xq.dtype == torch.int8 and sx.shape == (m, k // 128)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
        np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    assert sx[2, 1].item() == 1.0 and not xq[2, 128:256].any()
    assert xq[3, :5].tolist() == [0, 2, 2, 0, 127]  # half to even


def _jax_matmul(x, jleaf):
    assert jkernels.can_fuse(jnp.asarray(x), jleaf)
    return np.asarray(jkernels.dequant_matmul(jnp.asarray(x), jleaf), np.float32)


def _check_matmul(fn, x, leaf, jleaf, xdt="float32"):
    xt = t(x).to(getattr(torch, xdt))
    want = _jax_matmul(jnp.asarray(x, xdt), jleaf)
    got = fn(xt, leaf)
    assert got.dtype == xt.dtype and got.shape == want.shape
    tol = F32_TOL if xdt == "float32" else BF16_TOL
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=tol * np.abs(want).max())
    return got


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 8, 16])
def test_k5_plain_matches_jax_interpret(m, xdt):
    k, n = 512, 256
    leaf = quant.quantize_w4x8(t(rnd((k, n), 12, 0.1)))
    x = rnd((m, k), 13 + m)
    before = kernels.w4x8_matmul.launches_a8
    with interpret_kernels():
        got = _check_matmul(kernels.dequant_matmul, x, leaf, jnp_leaf(leaf), xdt)
    assert kernels.w4x8_matmul.launches_a8 == before  # the CPU takes the plain version
    np.testing.assert_array_equal(
        to_np(got), to_np(kernels.w4x8_matmul_a8_plain(t(x).to(got.dtype), leaf)))
    if xdt == "float32":  # the activation rounding is there: not the exact product
        exact = to_np(kernels.w4x8_matmul_stream_plain(t(x), leaf))
        assert np.abs(to_np(got) - exact).max() > 10 * F32_TOL * np.abs(exact).max()


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [17, 64])
def test_k6_plain_matches_jax_interpret(m, xdt):
    k, n = 256, 256
    leaf = quant.quantize_w4x8(t(rnd((k, n), 14, 0.1)))
    x = rnd((m, k), 15 + m)
    with interpret_kernels():
        got = _check_matmul(kernels.dequant_matmul, x, leaf, jnp_leaf(leaf), xdt)
    np.testing.assert_array_equal(
        to_np(got), to_np(kernels.w4x8_matmul_stream_plain(t(x).to(got.dtype), leaf)))


def test_w4x8_a8_threshold_follows_the_padded_row_count(monkeypatch):
    """The TPU launcher pads m up to 8 before it compares with the
    threshold: at a threshold of 4 no row count takes the W4A8 kernel."""
    leaf = quant.quantize_w4x8(t(rnd((256, 32), 16, 0.1)))
    x = t(rnd((2, 256), 17))
    monkeypatch.setattr(kernels, "_W4X8_A8_MAX_M", 4)
    assert torch.equal(kernels.dequant_matmul(x, leaf),
                       kernels.w4x8_matmul_stream_plain(x, leaf))
    monkeypatch.setattr(kernels, "_W4X8_A8_MAX_M", 8)
    assert torch.equal(kernels.dequant_matmul(x, leaf), kernels.w4x8_matmul_a8_plain(x, leaf))


@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_k1_q4_plain_matches_jax_interpret(m, scale_dtype):
    k, n = 256, 128
    leaf = quant.quantize(t(rnd((k, n), 18, 0.1)), 4)
    leaf["s"] = leaf["s"].to(getattr(torch, scale_dtype))  # a Q4_0 file brings f32 scales
    x = rnd((m, k), 19 + m)
    before = kernels.dequant_matmul.launches_q4
    with interpret_kernels():
        _check_matmul(kernels.dequant_matmul, x, leaf, jnp_leaf(leaf))
    assert kernels.dequant_matmul.launches_q4 == before


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8])
def test_k9_plain_matches_jax_interpret(m, bits, xdt):
    k, n = 256, 128
    leaf = quant.quantize(t(rnd((k, n), 20, 0.1)), bits)
    x = rnd((m, k), 21 + m)
    with interpret_kernels(so_max_m=8):
        got = _check_matmul(kernels.dequant_matmul, x, leaf, jnp_leaf(leaf), xdt)
    np.testing.assert_array_equal(
        to_np(got), to_np(kernels.dequant_matmul_so_plain(t(x).to(got.dtype), leaf)))
    # the same function as K1 up to the order of the f32 sums
    ref = to_np(kernels.dequant_matmul_plain(t(x).to(got.dtype), leaf))
    tol = F32_TOL if xdt == "float32" else BF16_TOL
    np.testing.assert_allclose(to_np(got), ref, rtol=0, atol=tol * np.abs(ref).max())


def test_k9_switch_is_off_by_default_and_bounded_by_rows(monkeypatch):
    assert kernels.SCALE_ON_OUTPUT_MAX_M == jkernels.SCALE_ON_OUTPUT_MAX_M == 0
    leaf = quant.quantize(t(rnd((64, 32), 22, 0.1)), 4)
    calls = []
    monkeypatch.setattr(kernels, "dequant_matmul_so",
                        lambda x, w: calls.append(x.shape[0]) or x.new_zeros(x.shape[0], 32))
    kernels.dequant_matmul(t(rnd((3, 64), 23)), leaf)
    assert calls == []
    monkeypatch.setattr(kernels, "SCALE_ON_OUTPUT_MAX_M", 8)
    kernels.dequant_matmul(t(rnd((3, 64), 23)), leaf)
    kernels.dequant_matmul(t(rnd((9, 64), 23)), leaf)  # above the switch: K1
    assert calls == [3]


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_q4_1_quant_matmul_matches_jax_fallback(xdt):
    rng = np.random.default_rng(24)
    leaf = {"q4": rng.integers(0, 256, (64, 48)).astype(np.uint8),
            "s": np.abs(rnd((4, 48), 25, 0.01)), "m": rnd((4, 48), 26, 0.1)}
    x = rnd((2, 5, 128), 27)
    jleaf = {k: jnp.asarray(v) for k, v in leaf.items()}
    with interpret_kernels():  # even then JAX has no kernel for Q4_1
        assert not jkernels.can_fuse(jnp.asarray(x), jleaf)
        want = jquant.quant_matmul(jnp.asarray(x, xdt), jleaf)
    got = quant.quant_matmul(t(x).to(getattr(torch, xdt)), {k: t(v) for k, v in leaf.items()})
    assert got.shape == (2, 5, 48) and str(got.dtype).split(".")[-1] == xdt
    tol = F32_TOL if xdt == "float32" else 2 * BF16_TOL  # bf16 products summed in bf16
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), rtol=0,
                               atol=tol * np.abs(np.asarray(want, np.float32)).max())


def test_linear_routes_every_quantized_leaf():
    w = t(rnd((128, 32), 28, 0.1))
    x = t(rnd((2, 3, 128), 29))
    ref = x @ w
    for leaf in (quant.quantize(w, 8), quant.quantize(w, 4), quant.quantize_w4x8(w)):
        got = basic.linear(x, leaf)
        assert got.shape == (2, 3, 32)
        assert (got - ref).abs().max() < 0.25 * ref.abs().max()  # int4 rounding


@pytest.mark.parametrize("case", ["q4", "q4x", "q4x_f32_scales", "q4x_k", "q4_rows", "q4_dtype"])
def test_cuda_arg_checks_for_int4_leaves(case):
    """The checks the wrappers run before a launch (pure Python on shapes,
    dtypes and layout, so they run here on CPU tensors)."""
    x = torch.zeros((4, 256))
    if case == "q4":
        kernels._check_cuda_args(x, torch.zeros((128, 32), dtype=torch.uint8),
                                 torch.zeros((8, 32)), "q4")
        return
    if case == "q4x":
        kernels._check_cuda_args(x, torch.zeros((128, 32), dtype=torch.uint8),
                                 torch.zeros((4, 32), dtype=torch.bfloat16), "q4x")
        return
    q = torch.zeros((128, 32), dtype=torch.uint8)
    s = torch.zeros((4, 32), dtype=torch.bfloat16)
    key = "q4x"
    if case == "q4x_f32_scales":
        s = s.float()
    elif case == "q4x_k":  # K not a multiple of 128
        x, q, s = torch.zeros((4, 192)), q[:96], s[:3]
    elif case == "q4_rows":  # a Q4_0 leaf wants K/32 scale rows
        key = "q4"
    else:
        key, q, s = "q4", q.to(torch.int8), torch.zeros((8, 32))
    with pytest.raises(ValueError):
        kernels._check_cuda_args(x, q, s, key)


@pytest.mark.parametrize("m,k,n", [(4, 4096, 12288), (4, 4096, 4096), (4, 11008, 4096),
                                   (16, 4096, 32000), (1, 128, 64), (8, 11008, 22016)])
def test_k5_split_cuts_at_whole_groups(m, k, n):
    ksplit, per = kernels.a8_split_for(m, k, n)
    groups = k // 128
    assert ksplit >= 1 and per >= 1
    assert ksplit * per >= groups > (ksplit - 1) * per  # covers K, no split is empty
    # one wave of blocks of 512 columns (three an SM with one n8 tile of
    # slots, two with two)
    blocks = -(-n // 512) * -(-m // (8 if m <= 8 else 16))
    assert blocks * ksplit <= max((3 if m <= 8 else 2) * 132, blocks)


# ------------------------------------------------------ files and params


@pytest.fixture(scope="module")
def q4_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("q4")
    cfg = MODEL_PRESETS["tiny-gqa"]
    f32 = str(d / "tiny-f32.bin")
    write_ggjt(f32, cfg, Vocab(make_test_vocab().tokens), random_ggjt_tensors(cfg, seed=30))
    return {kind: quantize_ggjt(f32, str(d / f"tiny-{kind}.bin"), kind)
            for kind in ("q4_0", "q4_1")} | {"f32": f32}


@pytest.mark.parametrize("kind,ftype", [("q4_0", 2), ("q4_1", 3)])
def test_read_q4_ggjt_and_host_parameters_match_jax(q4_files, kind, ftype):
    ck, jck = read_ggjt(q4_files[kind]), jread_ggjt(q4_files[kind])
    assert ck.ftype == jck.ftype == ftype
    assert ck.config.weight_dtype == jck.config.weight_dtype == "int4"
    qt, jqt = ck.tensors["layers.0.attention.wq.weight"], jck.tensors[
        "layers.0.attention.wq.weight"]
    assert qt.kind == jqt.kind == kind and qt.shape == jqt.shape
    np.testing.assert_array_equal(dequantize_rows(qt), jdequantize_rows(jqt))
    host = params.host_parameters(ck.config, ck.tensors)
    jhost = jparams.host_parameters(jck.config, jck.tensors)
    assert ("m" in host["layers"]["wq"]) == (kind == "q4_1")
    flat, jflat = jax.tree.leaves(host), jax.tree.leaves(jhost)
    assert len(flat) == len(jflat)
    for a, b in zip(flat, jflat):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _mixed_config(cls):
    """dim 128: the attention projections and w1/w3 (K = 128) can take the
    w4x8 format, w2 (K = 320) keeps Q4_0. Every output width is a multiple
    of 128: the JAX launcher's tile planner refuses other widths of a w4x8
    leaf and then dequantizes, without K5's activation rounding, where the
    port's kernels take any width."""
    return cls(vocab_size=512, dim=128, n_layers=2, n_heads=4, ffn_dim=320,
               max_seq_len=96, dtype="float32", weight_dtype="int4")


@pytest.mark.parametrize("exec_format", ["w4x8", "q4_0"])
def test_load_parameters_int4_matches_quantize_params(monkeypatch, exec_format):
    monkeypatch.setenv("LLAMAGO_INT4_EXEC", exec_format)
    jcfg, cfg = _mixed_config(JModelConfig), _mixed_config(ModelConfig)
    assert cfg.ffn_hidden == jcfg.ffn_hidden == 320
    tensors = random_ggjt_tensors(jcfg, seed=31)
    want = jparams.load_parameters(jcfg, tensors)
    got = params.load_parameters(cfg, tensors, device="cpu")
    assert_tree_equal(got, want)
    assert ("q4x" in got["layers"]["wq"]) == (exec_format == "w4x8")
    assert "q4" in got["layers"]["w2"]  # the mixed tree
    assert ("q4x" in got["output"]) == (exec_format == "w4x8")
    assert got["output"]["s"].shape[-1] == 512  # no int4 head padding


@pytest.mark.parametrize("exec_format", ["w4x8", "q4_0"])
@pytest.mark.parametrize("kind", ["q4_0", "q4_1"])
def test_load_parameters_from_q4_file_matches_jax(monkeypatch, q4_files, kind, exec_format):
    """dim 64: no leaf can take w4x8, so file leaves stay as they are under
    both exec formats (Q4_1 always does)."""
    monkeypatch.setenv("LLAMAGO_INT4_EXEC", exec_format)
    ck, jck = read_ggjt(q4_files[kind]), jread_ggjt(q4_files[kind])
    cfg, jcfg = ck.config.replace(dtype="float32"), jck.config.replace(dtype="float32")
    got = params.load_parameters(cfg, ck.tensors, device="cpu")
    assert_tree_equal(got, jparams.load_parameters(jcfg, jck.tensors))
    assert got["layers"]["wq"]["s"].dtype == torch.float32  # file scales stay f32


def test_load_parameters_relays_q4_0_file_leaves_under_w4x8(monkeypatch):
    """Q4_0 file tensors (the matmul leaves and the head) through
    load_parameters under w4x8: re-laid where K is a multiple of 128, kept
    as Q4_0 with their f32 file scales elsewhere, as the JAX loader does
    with the same bytes."""
    from llamago_tpu.checkpoint.quant_file import QuantTensor as JQuantTensor
    from llamago_tpu_torch.checkpoint.quant_file import QuantTensor, quantize_rows_q4_0

    monkeypatch.setenv("LLAMAGO_INT4_EXEC", "w4x8")
    jcfg, cfg = _mixed_config(JModelConfig), _mixed_config(ModelConfig)
    dense = random_ggjt_tensors(jcfg, seed=32)
    quantized = {name: quantize_rows_q4_0(m) for name, m in dense.items()
                 if m.ndim == 2 and name != "tok_embeddings.weight"}
    tensors = {**dense, **{name: QuantTensor("q4_0", raw, dense[name].shape)
                           for name, raw in quantized.items()}}
    jtensors = {**dense, **{name: JQuantTensor("q4_0", raw, dense[name].shape)
                            for name, raw in quantized.items()}}
    got = params.load_parameters(cfg, tensors, device="cpu")
    assert_tree_equal(got, jparams.load_parameters(jcfg, jtensors))
    assert "q4x" in got["layers"]["wq"] and got["layers"]["w2"]["s"].dtype == torch.float32


@pytest.mark.parametrize("exec_format", ["w4x8", "q4_0"])
def test_random_quantized_parameters_int4_layout_matches_jax(monkeypatch, exec_format):
    monkeypatch.setenv("LLAMAGO_INT4_EXEC", exec_format)
    jcfg, cfg = _mixed_config(JModelConfig), _mixed_config(ModelConfig)
    jp = jparams.random_quantized_parameters(jcfg, seed=0, layered=True)
    tp = params.random_quantized_parameters(cfg, seed=0, device="cpu")
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    tshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tp)
    assert jax.tree.structure(jshapes) == jax.tree.structure(tshapes)
    assert jax.tree.leaves(jshapes) == jax.tree.leaves(tshapes)
    assert ("q4x" in tp["layers"][0]["wq"]) == (exec_format == "w4x8")
    assert "q4" in tp["layers"][0]["w2"]
    stacked = params.random_quantized_parameters(cfg, seed=0, layered=False, device="cpu")
    assert stacked["layers"]["w2"]["q4"].shape == (2, 160, 128)


def test_fuse_layer_weights_on_int4_leaves_matches_jax(monkeypatch):
    monkeypatch.setenv("LLAMAGO_INT4_EXEC", "w4x8")
    jcfg, cfg = _mixed_config(JModelConfig), _mixed_config(ModelConfig)
    tensors = random_ggjt_tensors(jcfg, seed=33)
    jp = jparams.fuse_layer_weights(jparams.unstack_layer_params(
        jparams.load_parameters(jcfg, tensors), jcfg.n_layers))
    tp = params.fuse_layer_weights(params.unstack_layer_params(
        params.load_parameters(cfg, tensors, device="cpu"), cfg.n_layers))
    assert_tree_equal(tp, jp)
    assert tp["layers"][0]["wqkv"]["q4x"].shape == (64, 384)
    assert tp["layers"][1]["w13"]["s"].shape == (2, 640)


def test_fuse_layer_weights_keeps_q4_1_mins_and_refuses_unlike_leaves():
    def leaf(n, with_m):
        out = {"q4": torch.zeros((32, n), dtype=torch.uint8), "s": torch.ones((2, n))}
        if with_m:
            out["m"] = torch.full((2, n), 0.5)
        return out

    fused = params._concat_weights([leaf(8, True), leaf(4, True)])
    assert sorted(fused) == ["m", "q4", "s"] and fused["m"].shape == (2, 12)
    with pytest.raises(ValueError, match="unlike formats"):
        params._concat_weights([leaf(8, True), leaf(4, False)])
    with pytest.raises(ValueError, match="unlike formats"):
        params._concat_weights([leaf(8, False), torch.zeros((64, 4))])
    w4x8 = quant.quantize_w4x8(t(rnd((128, 8), 34)))
    with pytest.raises(ValueError, match="unlike formats"):
        params._concat_weights([w4x8, leaf(8, False)])


def test_params_from_numpy_carries_int4_leaves():
    w = rnd((128, 16), 35)
    tree = {"a": jax.tree.map(np.asarray, jquant.quantize_w4x8(jnp.asarray(w))),
            "b": {"q4": np.zeros((64, 16), np.uint8), "s": np.ones((4, 16), np.float32),
                  "m": np.ones((4, 16), np.float32)}}
    tp = params.params_from_numpy(tree, device="cpu")
    assert tp["a"]["q4x"].dtype == torch.uint8 and tp["a"]["s"].dtype == torch.bfloat16
    assert tp["b"]["m"].dtype == torch.float32
    np.testing.assert_array_equal(tp["a"]["q4x"].numpy(), tree["a"]["q4x"])


# ------------------------------------------------------ the slice as a whole


def _int4_model(monkeypatch, exec_format, seed=36):
    """The mixed tiny model quantized by the JAX package, layered and fused,
    and carried across."""
    monkeypatch.setenv("LLAMAGO_INT4_EXEC", exec_format)
    jcfg, cfg = _mixed_config(JModelConfig), _mixed_config(ModelConfig)
    jp = jparams.load_parameters(jcfg, random_ggjt_tensors(jcfg, seed=seed))
    jp = jparams.fuse_layer_weights(jparams.unstack_layer_params(jp, jcfg.n_layers))
    tp = params.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # as tests/test_torch_model.py: sums in another order


@pytest.mark.parametrize("exec_format", ["w4x8", "q4_0"])
def test_forward_int4_prefill_matches_jax(monkeypatch, exec_format):
    """A prefill of 20 tokens in 2 rows (m = 40: K6, or K1 bits=4) against
    the JAX forward pass with interpret-mode kernels; the mixed tree sends
    w2 through K1 bits=4 in both formats."""
    jcfg, jp, cfg, tp = _int4_model(monkeypatch, exec_format)
    toks = np.random.default_rng(37).integers(1, 500, (2, 20)).astype(np.int32)
    with interpret_kernels():
        jl, _ = jllama.forward(jp, jnp.asarray(toks),
                               JKVCache.create(jcfg, batch=2, layered=True),
                               jnp.zeros(2, jnp.int32), jcfg, return_all_logits=True)
        tl, _ = llama.forward_impl(tp, torch.from_numpy(toks),
                                   KVCache.create(cfg, batch=2, device="cpu"),
                                   torch.zeros(2, dtype=torch.long), cfg,
                                   return_all_logits=True)
    assert tl.shape == (2, 20, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("exec_format", ["w4x8", "q4_0"])
def test_forward_int4_decode_steps_match_jax(monkeypatch, exec_format):
    """Greedy decode steps of 2 rows from an empty cache (m = 2: K5 with its
    activation rounding, or K1 bits=4), each step's logits and token
    against the JAX forward pass with interpret-mode kernels."""
    jcfg, jp, cfg, tp = _int4_model(monkeypatch, exec_format)
    jcache = JKVCache.create(jcfg, batch=2, layered=True)
    cache = KVCache.create(cfg, batch=2, device="cpu")
    tt = torch.tensor([1, 7])
    jt = jnp.asarray(tt.numpy(), jnp.int32)
    with interpret_kernels():
        for pos in range(4):
            jl, jcache = jllama.forward(jp, jt[:, None], jcache,
                                        jnp.full((2,), pos, jnp.int32), jcfg)
            tl, cache = llama.forward_impl(tp, tt[:, None], cache, torch.full((2,), pos), cfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
            jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), torch.argmax(tl, -1)
            assert tt.tolist() == np.asarray(jt).tolist()


@pytest.mark.slow
@pytest.mark.parametrize("exec_format", ["w4x8", "q4_0"])
def test_engine_int4_greedy_tokens_match_jax(monkeypatch, exec_format):
    jcfg, jp, cfg, tp = _int4_model(monkeypatch, exec_format, seed=38)
    vocab = make_test_vocab()
    buckets = (16, 32, 64)
    with interpret_kernels():
        jeng = JEngine(jcfg, jp, vocab, slots=2, buckets=buckets, decode_chunk_size=4)
        eng = Engine(cfg, tp, Vocab(list(vocab.tokens)), slots=2, buckets=buckets,
                     decode_chunk_size=4, device="cpu")
        for prompt, n in (("hello world", 10), ("world hello world hello world hello", 8)):
            want = jeng.generate(prompt, JGen(max_tokens=n, ctx_size=96, temp=0.0))
            got = eng.generate(prompt, GenerateConfig(max_tokens=n, ctx_size=96, temp=0.0))
            assert got.status.value == want.status.value == "finished"
            assert got.output_tokens == want.output_tokens and len(got.output_tokens) == n
