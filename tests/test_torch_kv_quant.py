"""Port parity: the int8 KV cache against the JAX package on the CPU.

Covers the row quantization and the cache's scale planes
(runtime/kv_cache.py), K3 (ops/cache_write.py cache_append_quant), K4 and
K8 (ops/attention.py flash_attention_quant) and the scale-folded
attention_math, the int8 forward pass and slot prefill (models/llama.py),
and the Engine with `kv_dtype="int8"`. Inputs are made from numpy seeds.

The JAX kernels run in interpret mode (`FORCE_INTERPRET`): without it the
JAX package takes `attention_math` for the int8 cache off the TPU, another
function than its kernels. The port's wrappers take their plain PyTorch
versions on CPU tensors. Tolerances: quantized values and scales exactly
(bf16 scale planes, LLAMAGO_KV_SCALE_DTYPE=bfloat16, exactly too where the
f32 scales agree exactly); attention 2e-5 absolute in f32, as the JAX package's kernel tests use;
logits 1e-4 (other summation orders through two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint.params import host_parameters, unstack_layer_params
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.models import llama as jllama
from llamago_tpu.ops import attention as jattention
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu.ops.cache_write import cache_append_quant as jcache_append_quant
from llamago_tpu.ops.cache_write import can_fuse_cache_append
from llamago_tpu.runtime import kv_cache as jkv_cache
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu.runtime.kv_cache import quantize_kv_rows as jquantize_kv_rows
from llamago_tpu_torch.checkpoint.params import params_from_numpy
from llamago_tpu_torch.config import MODEL_PRESETS, GenerateConfig
from llamago_tpu_torch.models import llama
from llamago_tpu_torch.ops import attention, cache_write
from llamago_tpu_torch.runtime import kv_cache
from llamago_tpu_torch.runtime.engine import Engine, JobStatus
from llamago_tpu_torch.runtime.kv_cache import (
    KVCache,
    quantize_kv_rows,
    write_scale_rows,
)
from llamago_tpu_torch.tokenizer import Vocab

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)

S = 768  # three 256-row S-blocks
# JAX compiles quantize_kv_rows into every step it runs; compiled, its
# absmax / 127.0 is a multiplication by fl(1/127), which the port follows
jquantize = jax.jit(jquantize_kv_rows)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    yield
    jkernels.FORCE_INTERPRET = old


@pytest.fixture
def i8dot(request, monkeypatch):
    """Both packages on the same int8-cache attention variant. JAX reads
    _I8DOT when it traces, so its compiled kernel is dropped around the
    test."""
    monkeypatch.setattr(jattention, "_I8DOT", request.param)
    monkeypatch.setattr(attention, "_I8DOT", request.param)
    jattention._flash_attention_lenaware_quant.clear_cache()
    yield request.param
    jattention._flash_attention_lenaware_quant.clear_cache()


def _rng(seed):
    return np.random.default_rng(seed)


def _quant_cache(rng, b, kv, s, hd):
    """int8 rows and f32 scales of a normal cache, quantized by JAX."""
    q, sc = jquantize(jnp.asarray(rng.standard_normal((b, kv, s, hd)), jnp.float32))
    return np.asarray(q), np.asarray(sc)


# ---------------------------------------------------------- quantization


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_matches_jax_exactly(dtype):
    x = (_rng(0).standard_normal((5, 3, 4, 32)) * 3).astype(np.float32)
    x[1, 2, 3] = 0.0  # an all-zero row: s = 1, q = 0
    x[2, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # ties against a row max of 127 * s
    x[2, 0, 0, 4] = 127.0
    jx = jnp.asarray(x).astype(dtype)
    want_q, want_s = map(np.asarray, jquantize(jx))
    got_q, got_s = quantize_kv_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert got_s[1, 2, 3] == 1.0 and not got_q[1, 2, 3].any()
    assert got_q[2, 0, 0, :4].tolist() == [0, 0, 2, 2]  # half to even


def test_kv_cache_int8_layout_and_slot_views():
    cfg = MODEL_PRESETS["tiny-gqa"].replace(kv_dtype="int8")
    cache = KVCache.create(cfg, batch=3, device="cpu")
    assert cache.quantized and len(cache.ks) == cfg.n_layers
    assert cache.k[0].dtype == torch.int8 and cache.k[0].shape == (3, 2, 128, 16)
    assert cache.ks[1].dtype == torch.float32 and cache.ks[1].shape == (3, 2, 128)
    assert not cache.ks[0].any()  # unwritten rows dequantize to 0
    view = cache.slot(1)
    write_scale_rows(view.vs[0], torch.full((1, 2, 2), 0.5), torch.tensor([4]))
    assert cache.vs[0][1, :, 4:6].eq(0.5).all() and cache.vs[0].sum() == 4 * 0.5
    dense = KVCache.create(cfg.replace(kv_dtype="auto"), batch=1, device="cpu")
    assert not dense.quantized and dense.slot(0).ks is None


def test_kv_cache_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCache.create(MODEL_PRESETS["tiny"])


@pytest.fixture
def bf16_scales(monkeypatch):
    """Both packages under LLAMAGO_KV_SCALE_DTYPE=bfloat16. JAX reads the
    planes' dtype when it traces, so its compiled functions are dropped
    around the test."""
    monkeypatch.setattr(kv_cache, "_SCALE_DTYPE_NAME", "bfloat16")
    monkeypatch.setattr(jkv_cache, "_SCALE_DTYPE_NAME", "bfloat16")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_kv_cache_bf16_scale_planes(bf16_scales, monkeypatch):
    cfg = MODEL_PRESETS["tiny"].replace(kv_dtype="int8")
    jcache = JKVCache.create(JPRESETS["tiny"].replace(kv_dtype="int8"), batch=2, layered=True)
    cache = KVCache.create(cfg, batch=2, device="cpu")
    assert jcache.ks[0].dtype == jnp.bfloat16
    for planes in (cache.ks, cache.vs):
        assert all(a.dtype == torch.bfloat16 and a.shape == jcache.ks[0].shape
                   and not a.any() for a in planes)
    assert cache.k[0].dtype == torch.int8 and cache.slot(1).vs[0].dtype == torch.bfloat16
    dense = KVCache.create(cfg.replace(kv_dtype="auto"), device="cpu")  # dense: unaffected
    assert not dense.quantized
    monkeypatch.setattr(kv_cache, "_SCALE_DTYPE_NAME", "float16")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        KVCache.create(cfg, device="cpu")


def test_write_scale_rows_rounds_to_a_bf16_plane_like_jax():
    layer = _rng(3).standard_normal((2, 2, 64)).astype(np.float32)
    new = _rng(4).standard_normal((2, 4, 2)).astype(np.float32)
    want = jllama._update_scale(jnp.asarray(layer, jnp.bfloat16), jnp.asarray(new),
                                jnp.asarray([3, 62], jnp.int32))
    got = torch.from_numpy(layer).to(torch.bfloat16)
    write_scale_rows(got, torch.from_numpy(new), torch.tensor([3, 62]))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("starts", [[60, 2], [64, -3], [63, 0]])
def test_write_scale_rows_clamps_like_dynamic_update_slice(starts):
    layer = _rng(1).standard_normal((2, 2, 64)).astype(np.float32)
    new = _rng(2).standard_normal((2, 4, 2)).astype(np.float32)
    want = np.asarray(jllama._update_scale(jnp.asarray(layer), jnp.asarray(new),
                                           jnp.asarray(starts, jnp.int32)))
    got = torch.from_numpy(layer.copy())
    write_scale_rows(got, torch.from_numpy(new), torch.tensor(starts))
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------------- K3


def _k3_inputs(seed, b, kv, s, hd, dtype):
    rng = _rng(seed)
    ck = rng.integers(-127, 128, (b, kv, s, hd)).astype(np.int8)
    cv = rng.integers(-127, 128, (b, kv, s, hd)).astype(np.int8)
    cks = rng.random((b, kv, s)).astype(np.float32)
    cvs = rng.random((b, kv, s)).astype(np.float32)
    kn = rng.standard_normal((b, 1, kv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, 1, kv, hd)).astype(np.float32)
    vn[0, 0, 1] = 0.0  # a zero row
    jn = [jnp.asarray(a).astype(dtype) for a in (kn, vn)]
    tn = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (kn, vn)]
    return (ck, cv, cks, cvs), jn, tn


def _port_k3(caches, tn, pos):
    got = [torch.from_numpy(a.copy()) for a in caches]
    launches = cache_write.cache_append_quant.launches
    cache_write.cache_append_quant(*got, *tn, torch.tensor(pos))
    assert cache_write.cache_append_quant.launches == launches  # plain on the CPU
    return [a.numpy() for a in got]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k3_plain_matches_jax_kernel_bit_for_bit(dtype):
    b, kv, s, hd = 4, 2, 128, 32
    caches, jn, tn = _k3_inputs(7, b, kv, s, hd, dtype)
    # 0, S-1, a negative start, and an overrunning start: the JAX kernel
    # clamps its 8-row and 128-slot block indices and keeps the offset
    # within the block, which lands 2S-1 on S-1 as write_rows does
    pos = [0, s - 1, -3, 2 * s - 1]
    assert can_fuse_cache_append(jn[0], jnp.asarray(caches[0]))
    want = jcache_append_quant(*map(jnp.asarray, caches), *jn,
                               jnp.asarray(pos, jnp.int32))
    got = _port_k3(caches, tn, pos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, c in zip(got, caches):  # every other row untouched
        for bi, row in enumerate([0, s - 1, s - 3, s - 1]):
            keep = np.ones(s, bool)
            keep[row] = False
            np.testing.assert_array_equal(g[bi][:, keep], c[bi][:, keep])


@pytest.mark.parametrize("pos", [[130, 5], [-1, 128], [200, -128]])
def test_k3_plain_places_like_write_rows(pos):
    """Any start, as the JAX package's dynamic_update_slice path places it
    (a negative one counted from the end, an overrun clamped to S-1)."""
    b, kv, s, hd = 2, 2, 128, 32
    caches, jn, tn = _k3_inputs(8, b, kv, s, hd, "bfloat16")
    jp = jnp.asarray(pos, jnp.int32)
    kq, ks = jquantize(jn[0])
    vq, vs = jquantize(jn[1])
    want = [jllama._update_cache(jnp.asarray(caches[0]), kq, jp),
            jllama._update_cache(jnp.asarray(caches[1]), vq, jp),
            jllama._update_scale(jnp.asarray(caches[2]), ks, jp),
            jllama._update_scale(jnp.asarray(caches[3]), vs, jp)]
    for g, w in zip(_port_k3(caches, tn, pos), want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k3_plain_matches_jax_kernel_bit_for_bit_with_bf16_scale_planes(dtype):
    """The row is quantized against its f32 scale; the plane takes the scale
    rounded to bf16, in both."""
    b, kv, s, hd = 4, 2, 128, 32
    caches, jn, tn = _k3_inputs(9, b, kv, s, hd, dtype)
    pos = [0, s - 1, -3, 2 * s - 1]
    jcaches = [jnp.asarray(caches[0]), jnp.asarray(caches[1]),
               jnp.asarray(caches[2], jnp.bfloat16), jnp.asarray(caches[3], jnp.bfloat16)]
    want = jcache_append_quant(*jcaches, *jn, jnp.asarray(pos, jnp.int32))
    got = [torch.from_numpy(a.copy()) for a in caches]
    got[2], got[3] = got[2].to(torch.bfloat16), got[3].to(torch.bfloat16)
    cache_write.cache_append_quant(*got, *tn, torch.tensor(pos))
    assert got[2].dtype == torch.bfloat16 and want[2].dtype == jnp.bfloat16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    # against the f32 planes: the same int8 rows, the scale one rounding away
    f32 = _port_k3(caches, tn, pos)
    np.testing.assert_array_equal(got[0].numpy(), f32[0])
    np.testing.assert_array_equal(got[2].float().numpy(),
                                  torch.from_numpy(f32[2]).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("case", ["t", "hd", "dtype", "scales", "pos", "contiguous"])
def test_k3_cuda_arg_checks_reject_unsupported_inputs(case):
    b, kv, s, hd = 2, 2, 64, 64
    k_l = torch.zeros((b, kv, s, hd), dtype=torch.int8)
    ks_l = torch.zeros((b, kv, s))
    new = torch.zeros((b, 1, kv, hd), dtype=torch.bfloat16)
    pos = torch.zeros(b, dtype=torch.int32)
    cache_write._check_cuda_args(k_l, k_l, ks_l, ks_l, new, new, pos)  # well-formed
    if case == "t":
        new = torch.zeros((b, 2, kv, hd), dtype=torch.bfloat16)
    elif case == "hd":
        new, k_l = new[..., :48].contiguous(), k_l[..., :48].contiguous()
    elif case == "dtype":
        k_l = k_l.to(torch.bfloat16)
    elif case == "scales":
        ks_l = torch.zeros((b, kv, s + 1))
    elif case == "pos":
        pos = pos.to(torch.int16)  # int64 and int32 are taken
    else:
        k_l = torch.zeros((b, s, kv, hd), dtype=torch.int8).transpose(1, 2)
    with pytest.raises(ValueError):
        cache_write._check_cuda_args(k_l, k_l, ks_l, ks_l, new, new, pos)


# --------------------------------------------------------------- K4 / K8


def _attn_inputs(b, t, h, kv, hd, s, pos0, seed):
    rng = _rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k8, ks = _quant_cache(rng, b, kv, s, hd)
    v8, vs = _quant_cache(rng, b, kv, s, hd)
    pos = np.asarray(pos0, np.int32)[:, None] + np.arange(t, dtype=np.int32)[None, :]
    return q, k8, v8, pos, ks, vs


@pytest.mark.parametrize("i8dot", [True, False], ids=["k4", "k8"], indirect=True)
@pytest.mark.parametrize("t", [1, 16, 32])
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_k4_k8_plain_match_jax_kernels(i8dot, t, h, kv):
    args = _attn_inputs(3, t, h, kv, 16, S, [0, 300, S - 1], seed=t + h + i8dot)
    jargs = tuple(map(jnp.asarray, args))
    assert jattention.can_fuse_attention_quant(jargs[0], jargs[1])
    want = np.asarray(jattention.flash_attention_quant(*jargs))
    launches = (attention.flash_attention_quant.launches_i8dot,
                attention.flash_attention_quant.launches_widening)
    got = attention.flash_attention_quant(*map(torch.from_numpy, args))
    assert launches == (attention.flash_attention_quant.launches_i8dot,
                        attention.flash_attention_quant.launches_widening)
    assert got.shape == (3, t, h * 16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("i8dot", [True, False], ids=["k4", "k8"], indirect=True)
def test_k4_k8_plain_small_cache_block(i8dot):
    """S = 40: the S-block is 8 (256 halved until it divides S)."""
    args = _attn_inputs(2, 4, 4, 2, 16, 40, [3, 36], seed=5)
    want = np.asarray(jattention.flash_attention_quant(*map(jnp.asarray, args)))
    got = attention.flash_attention_quant(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def _bf16_scales(args):
    """(numpy args with the scales rounded to bf16, JAX args, port args)."""
    q, k8, v8, pos, ks, vs = args
    jargs = (jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(pos),
             jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16))
    targs = (*map(torch.from_numpy, (q, k8, v8, pos)),
             torch.from_numpy(ks).to(torch.bfloat16), torch.from_numpy(vs).to(torch.bfloat16))
    return jargs, targs


@pytest.mark.parametrize("i8dot", [True, False], ids=["k4", "k8"], indirect=True)
@pytest.mark.parametrize("t", [1, 32])
def test_k4_k8_plain_match_jax_kernels_with_bf16_scale_planes(i8dot, t):
    """Both widen the bf16 scales to f32 as they read them."""
    jargs, targs = _bf16_scales(_attn_inputs(3, t, 4, 2, 16, S, [0, 300, S - 1],
                                             seed=40 + t + i8dot))
    assert jattention.can_fuse_attention_quant(jargs[0], jargs[1])
    want = np.asarray(jattention.flash_attention_quant(*jargs))
    got = attention.flash_attention_quant(*targs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_attention_math_with_bf16_scales_matches_jax():
    jargs, targs = _bf16_scales(_attn_inputs(2, 40, 4, 2, 16, 64, [0, 8], seed=41))
    want = np.asarray(jattention.attention_math(*jargs))
    np.testing.assert_allclose(attention.attention_math(*targs).numpy(), want, atol=2e-5)


@pytest.mark.parametrize("t,pos0", [(1, [3, 60]), (40, [0, 8])])
def test_attention_math_with_scales_matches_jax(t, pos0):
    args = _attn_inputs(2, t, 4, 2, 16, 64, pos0, seed=t)
    want = np.asarray(jattention.attention_math(*map(jnp.asarray, args)))
    got = attention.attention_math(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def _split_s(q5, k8, v8, pos0, ks, vs, i8dot):
    """The CUDA kernel's order of work (csrc/attn_decode_quant.cu), in
    PyTorch: each S-block's softmax statistics and PV taken against its own
    maximum, then merged. Returns (out, merge weights [B, KV, rows, n_sb])."""
    b, t, kv, g, hd = q5.shape
    sb = attention._tpu_sb(k8.shape[2])
    n_sb, rows = k8.shape[2] // sb, t * g
    q = q5.permute(0, 2, 1, 3, 4).reshape(b, kv, rows, hd).float()
    if i8dot:
        q8, sq = quantize_kv_rows(q)
        q, qscale = q8.float(), (hd ** -0.5 * sq)[..., None]
    qpos = pos0.long()[:, None] + torch.arange(rows)[None, :] // g
    ms, ls, pvs = [], [], []
    for si in range(n_sb):
        blk = slice(si * sb, (si + 1) * sb)
        sc = torch.einsum("bkrd,bksd->bkrs", q, k8[:, :, blk].float())
        sc = (sc * qscale if i8dot else sc * hd ** -0.5) * ks[:, :, None, blk]
        vis = (si * sb + torch.arange(sb))[None, None, None, :] <= qpos[:, None, :, None]
        sc = torch.where(vis, sc, torch.full_like(sc, attention._MASK))
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        psv = p * vs[:, :, None, blk]
        if i8dot:
            p8, sp = quantize_kv_rows(psv)
            pv = torch.einsum("bkrs,bksd->bkrd", p8.float(), v8[:, :, blk].float())
            pv = pv * sp[..., None]
        else:
            pv = torch.einsum("bkrs,bksd->bkrd", psv.bfloat16().float(),
                              v8[:, :, blk].float())
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        pvs.append(pv)
    m = torch.cat(ms, -1)
    w = torch.exp(m - m.amax(-1, keepdim=True))
    num = sum(w[..., i:i + 1] * pvs[i] for i in range(n_sb))
    den = sum(w[..., i:i + 1] * ls[i] for i in range(n_sb))
    out = (num / den).reshape(b, kv, t, g, hd).permute(0, 2, 1, 3, 4)
    return out, w


@pytest.mark.parametrize("i8dot", [True, False], ids=["k4", "k8"])
def test_split_s_merge_equals_sequential_plain(i8dot):
    """Splitting S into independent blocks and merging them (the CUDA
    kernel's structure) gives the sequential plain version's result, and a
    block in which a row sees nothing (finite -1e9 mask, p = 1 over the
    block) gets merge weight exactly 0. K4's per-block requantization
    divides out the block's own maximum, so the split changes only f32
    rounding (1e-6); K8 rounds p*sv to bf16 at the block's scale instead of
    the running one, which moves each term by up to 2**-9 relative (1e-3)."""
    q, k8, v8, pos, ks, vs = map(torch.from_numpy,
                                 _attn_inputs(2, 32, 2, 2, 16, 512, [250, 480], seed=9))
    q5 = q.reshape(2, 32, 2, 1, 16)
    pos0 = pos[:, 0]
    out, w = _split_s(q5, k8, v8, pos0, ks, vs, i8dot)
    plain = (attention.flash_attention_quant_i8dot_plain if i8dot
             else attention.flash_attention_quant_plain)
    np.testing.assert_allclose(out.numpy(), plain(q5, k8, v8, pos0, ks, vs).numpy(),
                               atol=1e-6 if i8dot else 1e-3)
    # batch 0: rows 0..5 (positions 250..255) see nothing of block 1
    assert (w[0, :, :6, 1] == 0).all() and (w[0, :, 6:, 1] > 0).all()


@pytest.mark.parametrize("case", ["t", "hd", "dtype", "scales", "sblock", "contiguous"])
def test_k4_k8_cuda_arg_checks_reject_unsupported_inputs(case):
    b, t, kv, g, hd, s = 2, 1, 2, 2, 64, 256
    q5 = torch.zeros((b, t, kv, g, hd), dtype=torch.bfloat16)
    k8 = torch.zeros((b, kv, s, hd), dtype=torch.int8)
    ks = torch.zeros((b, kv, s))
    pos0 = torch.zeros(b, dtype=torch.int32)
    attention._check_quant_cuda_args(q5, k8, k8, pos0, ks, ks)  # well-formed
    if case == "t":
        q5 = torch.zeros((b, 33, kv, g, hd), dtype=torch.bfloat16)
    elif case == "hd":
        q5, k8 = q5[..., :48].contiguous(), k8[..., :48].contiguous()
    elif case == "dtype":
        k8 = k8.to(torch.bfloat16)
    elif case == "scales":
        ks = torch.zeros((b, kv, s // 2))
    elif case == "sblock":
        k8, ks = torch.zeros((b, kv, 36, hd), dtype=torch.int8), torch.zeros((b, kv, 36))
    else:
        k8 = torch.zeros((b, s, kv, hd), dtype=torch.int8).transpose(1, 2)
    with pytest.raises(ValueError):
        attention._check_quant_cuda_args(q5, k8, k8, pos0, ks, ks)


# ------------------------------------------------------ model and engine


def _dense(name, seed=3, **over):
    jcfg = JPRESETS[name].replace(dtype="float32", weight_dtype="float32", **over)
    host = host_parameters(jcfg, random_ggjt_tensors(jcfg, seed=seed))
    jp = unstack_layer_params(jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), host),
                              jcfg.n_layers)
    cfg = MODEL_PRESETS[name].replace(dtype="float32", weight_dtype="float32", **over)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_forward_int8_prefill_then_decode_matches_jax(name):
    jcfg, jp, cfg, tp = _dense(name, kv_dtype="int8")
    toks = _rng(0).integers(1, 500, (2, 9)).astype(np.int32)
    jcache = JKVCache.create(jcfg, batch=2, layered=True)
    cache = KVCache.create(cfg, batch=2, device="cpu")
    jl, jcache = jllama.forward(jp, jnp.asarray(toks), jcache, jnp.zeros(2, jnp.int32), jcfg)
    tl, cache = llama.forward_impl(tp, torch.from_numpy(toks), cache,
                                   torch.zeros(2, dtype=torch.long), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for i in range(6):  # greedy decode: K3 writes, K4 attends
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        assert tt.tolist() == np.asarray(jt).tolist()
        pos = 9 + i
        jl, jcache = jllama.forward(jp, jt[:, None], jcache, jnp.full((2,), pos, jnp.int32),
                                    jcfg)
        tl, cache = llama.forward_impl(tp, tt[:, None], cache, torch.full((2,), pos), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for layer in range(cfg.n_layers):
        np.testing.assert_allclose(cache.ks[layer].numpy(), np.asarray(jcache.ks[layer]),
                                   rtol=1e-5)


def test_prefill_into_slot_int8_matches_jax():
    jcfg, jp, cfg, tp = _dense("tiny-gqa", kv_dtype="int8")
    ids = _rng(1).integers(1, 500, 7)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :7] = ids
    jcache = JKVCache.create(jcfg, batch=3, layered=True)
    jlogits, jcache = jllama.prefill_into_slot(
        jp, jnp.asarray(toks), jcache, jnp.asarray(1, jnp.int32),
        jnp.asarray([0], jnp.int32), jnp.asarray([6], jnp.int32), jcfg)
    cache = KVCache.create(cfg, batch=3, device="cpu")
    logits, cache = llama.prefill_into_slot(tp, torch.from_numpy(toks), cache, 1,
                                            torch.tensor([0]), torch.tensor([6]), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    for layer in range(cfg.n_layers):
        for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
            np.testing.assert_array_equal(got[layer].numpy(), np.asarray(want[layer]))
        for got, want in ((cache.ks, jcache.ks), (cache.vs, jcache.vs)):
            np.testing.assert_allclose(got[layer].numpy(), np.asarray(want[layer]),
                                       rtol=1e-6, atol=0)
    for planes in (cache.k, cache.v, cache.ks, cache.vs):  # slots 0 and 2 untouched
        assert not planes[0][0].any() and not planes[1][2].any()
    assert (cache.ks[0][1, :, :16] > 0).all()


def test_forward_int8_with_bf16_scale_planes_matches_jax(bf16_scales):
    """Prefill (plain quantize-and-write, cast on the write) then greedy
    decode (K3 writes, K4 attends) under LLAMAGO_KV_SCALE_DTYPE=bfloat16."""
    jcfg, jp, cfg, tp = _dense("tiny-gqa", kv_dtype="int8")
    toks = _rng(5).integers(1, 500, (2, 9)).astype(np.int32)
    jcache = JKVCache.create(jcfg, batch=2, layered=True)
    cache = KVCache.create(cfg, batch=2, device="cpu")
    assert cache.ks[0].dtype == torch.bfloat16 and jcache.ks[0].dtype == jnp.bfloat16
    jl, jcache = jllama.forward(jp, jnp.asarray(toks), jcache, jnp.zeros(2, jnp.int32), jcfg)
    tl, cache = llama.forward_impl(tp, torch.from_numpy(toks), cache,
                                   torch.zeros(2, dtype=torch.long), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for i in range(4):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        assert tt.tolist() == np.asarray(jt).tolist()
        pos = 9 + i
        jl, jcache = jllama.forward(jp, jt[:, None], jcache, jnp.full((2,), pos, jnp.int32),
                                    jcfg)
        tl, cache = llama.forward_impl(tp, tt[:, None], cache, torch.full((2,), pos), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for layer in range(cfg.n_layers):
        assert cache.vs[layer].dtype == torch.bfloat16
        # f32 scales 1e-5 apart may round to neighbouring bf16 values
        np.testing.assert_allclose(cache.ks[layer].float().numpy(),
                                   np.asarray(jcache.ks[layer], np.float32), rtol=2.0 ** -7)
        assert (cache.ks[layer][:, :, :13] > 0).all()


def test_engine_int8_cache_greedy_tokens_match_dense_cache():
    _, _, cfg, tp = _dense("tiny", max_seq_len=64)
    vocab = Vocab(list(make_test_vocab().tokens))
    gen = GenerateConfig(max_tokens=10, ctx_size=64, temp=0.0)
    out = {}
    for kv_dtype in ("auto", "int8"):
        eng = Engine(cfg.replace(kv_dtype=kv_dtype), tp, vocab, slots=2,
                     buckets=(16, 32, 64), decode_chunk_size=4, device="cpu")
        assert eng.cache.quantized == (kv_dtype == "int8")
        job = eng.generate("hello world", gen)
        assert job.status == JobStatus.FINISHED and len(job.output_tokens) == 10
        out[kv_dtype] = job.output_tokens
    assert out["int8"] == out["auto"]
