"""The port's kernels per rank at the shard shapes, against the JAX
package's shard_map path (mirrors tests/test_tp_kernels.py).

The ranks are gloo CPU processes (tests/torch_ranks.py), where every
kernel wrapper takes its plain version; the JAX side runs its Pallas
kernels in interpret mode on its 8 CPU devices. Inputs are made from numpy
seeds and the same numpy weights go to both.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.config import ModelConfig as JModelConfig
from llamago_tpu.models.llama import _attention_local
from llamago_tpu.models.llama import forward_impl as jforward_impl
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu.ops import quant as jquant
from llamago_tpu.ops.attention import attention_math as jattention_math
from llamago_tpu.parallel import cache_sharding as jcache_sharding
from llamago_tpu.parallel import make_mesh as jmake_mesh
from llamago_tpu.parallel import param_shardings as jparam_shardings
from llamago_tpu.parallel.tp_kernels import maybe_tp_attention as jmaybe_tp_attention
from llamago_tpu.parallel.tp_kernels import (
    maybe_tp_attention_quant as jmaybe_tp_attention_quant,
)
from llamago_tpu.parallel.tp_kernels import maybe_tp_matmul as jmaybe_tp_matmul
from llamago_tpu.parallel.tp_kernels import tp_kinds as jtp_kinds
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu.runtime.kv_cache import quantize_kv_rows as jquantize_kv_rows
from llamago_tpu.ops import attention as jattention
from llamago_tpu_torch.checkpoint.params import to_torch
from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.models.llama import _attention
from llamago_tpu_torch.ops.quant import quant_matmul
from llamago_tpu_torch.parallel.mesh import Mesh
from llamago_tpu_torch.parallel.tp_kernels import activate_mesh, maybe_tp_matmul, tp_kinds

from conftest import random_ggjt_tensors
from torch_ranks import load, run_ranks, save

TOL = 1e-4  # x max|ref|, f32


@contextlib.contextmanager
def jax_mesh(mesh, interpret=True):
    """JAX's process-wide mesh and interpret flag, restored afterwards."""
    jax.clear_caches()
    jkernels.ACTIVE_MESH = mesh
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = interpret
    try:
        yield mesh
    finally:
        jkernels.ACTIVE_MESH = None
        jkernels.FORCE_INTERPRET = old
        jax.clear_caches()


@contextlib.contextmanager
def port_mesh(mesh):
    activate_mesh(mesh)
    try:
        yield mesh
    finally:
        activate_mesh(None)


def _close(got, want, what, tol=TOL):
    err = float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())
    assert err <= tol, f"{what}: max|d| / max|ref| = {err:.2e}"


def _leaf(fmt, k, n, seed=0):
    w = jnp.asarray(np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.05)
    if fmt == "w4x8":
        return jquant.quantize_w4x8(w)
    return jquant.quantize(w, 8 if fmt == "q8" else 4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


MATMULS = [(fmt, kind) for fmt in ("q8", "q4", "w4x8") for kind in ("col", "row")]


@pytest.fixture(scope="module")
def tp_matmuls(tmp_path_factory):
    """Each (format, kind) of MATMULS on 2 ranks, and JAX's result."""
    d = tmp_path_factory.mktemp("mm")
    x = np.random.default_rng(1).standard_normal((4, 1, 256)).astype(np.float32)
    runs, want = [], []
    with jax_mesh(jmake_mesh(tp=2)):
        for i, (fmt, kind) in enumerate(MATMULS):
            leaf = _leaf(fmt, 256, 256, seed=i)
            want.append(np.asarray(jmaybe_tp_matmul(jnp.asarray(x), leaf, kind)))
            runs.append({"x": x, "leaf": _np_tree(leaf), "kind": kind})
    save(d, "mm.pkl", runs)
    run_ranks("matmuls", 2, d, name="mm", tp=2)
    return [load(d, f"mm.rank{r}.pkl") for r in range(2)], want


@pytest.mark.parametrize("case", range(len(MATMULS)), ids=[f"{f}-{k}" for f, k in MATMULS])
def test_tp_matmul_matches_jax_shard_map(tp_matmuls, case):
    """Q8_0, Q4_0 (K1) and w4x8 (K5) on a rank's column block, and on its
    row block all-reduced over tp, against JAX's shard_map in interpret
    mode: every rank holds the whole product."""
    got, want = tp_matmuls
    fmt, kind = MATMULS[case]
    for r in range(2):
        out = got[r][case]
        if kind == "col":  # each rank holds its columns
            full = np.concatenate([got[i][case] for i in range(2)], axis=-1)
            assert out.shape[-1] == want[case].shape[-1] // 2
            out = full
        _close(out, want[case], f"{fmt} {kind} rank {r}")


def test_dp_only_runs_the_kernel_on_each_ranks_rows(tmp_path):
    x = np.random.default_rng(2).standard_normal((8, 128)).astype(np.float32)
    leaf = _leaf("q8", 128, 256)
    with jax_mesh(jmake_mesh(tp=1, dp=2)):
        want = np.asarray(jmaybe_tp_matmul(jnp.asarray(x), leaf, None))
    save(tmp_path, "dp.pkl", [{"x": x, "leaf": _np_tree(leaf), "kind": None}])
    run_ranks("matmuls", 2, tmp_path, name="dp", dp=2)
    got = np.concatenate([load(tmp_path, f"dp.rank{r}.pkl")[0] for r in range(2)])
    _close(got, want, "dp rows")


def test_fallbacks_return_none():
    """Where the JAX function returns None the port's does too, and a row
    block without a local kernel is refused, never passed as the sum."""
    q8 = {k: to_torch(v, "cpu") for k, v in _np_tree(_leaf("q8", 128, 256)).items()}
    x = torch.ones(2, 128)
    assert maybe_tp_matmul(x, q8, "col") is None  # no mesh
    with port_mesh(Mesh(tp=4, dp=2)):
        affine = dict(q8, m=torch.zeros(4, 256))  # Q4_1: no kernel
        assert maybe_tp_matmul(x, affine, "col") is None
        stacked = {"q8": torch.zeros(2, 128, 256, dtype=torch.int8),
                   "s": torch.zeros(2, 4, 256)}
        assert maybe_tp_matmul(x, stacked, "col") is None
        assert maybe_tp_matmul(x, q8, None) is None  # a whole leaf under tp
    with port_mesh(Mesh(tp=8)):
        x16 = torch.ones(2, 16)  # a row block of 16 rows: no whole Q8_0 block
        row = {"q8": q8["q8"][:16], "s": q8["s"][:1]}
        assert maybe_tp_matmul(x16, row, "row") is None
        with pytest.raises(ValueError, match="row block"):
            quant_matmul(x16, row, tp_kind="row")


@pytest.mark.parametrize("kv,tp", [(2, 4), (2, 2), (4, 1)])
def test_tp_kinds_head_gating_matches_jax(kv, tp):
    jcfg = JModelConfig(vocab_size=64, dim=64, n_layers=1, n_heads=4, n_kv_heads=kv,
                        multiple_of=32, max_seq_len=32)
    cfg = ModelConfig(**jcfg.__dict__)
    assert tp_kinds(cfg, Mesh(tp=tp)) == jtp_kinds(jcfg, jmake_mesh(tp=tp))
    assert tp_kinds(cfg, None) == {} and tp_kinds(cfg, Mesh(dp=8)) == {}


def _attn_inputs(b, t, h, kv, s, hd, pos, seed, quantized=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    out = {"q": q, "k": k, "v": v, "pos": np.full((b, t), pos, np.int32)}
    if quantized:
        for name in ("k", "v"):
            qv, sc = jquantize_kv_rows(jnp.asarray(out[name]))
            out[name], out[name + "s"] = np.asarray(qv), np.asarray(sc)
    return out


def _per_shard(fn, inp, tp, dp):
    """The port's attention on each (dp, tp) shard's slots and heads, the
    outputs put back in place: [B, T, H*hd]."""
    b, _, h, hd = inp["q"].shape
    kv = inp["k"].shape[1]
    rows = []
    for di in range(dp):
        cols = []
        for ti in range(tp):
            with port_mesh(Mesh(tp=tp, dp=dp, rank=di * tp + ti)):
                bs = slice(di * b // dp, (di + 1) * b // dp)
                t = {k: torch.from_numpy(v[bs]) for k, v in inp.items()}
                q = t["q"][:, :, ti * h // tp:(ti + 1) * h // tp]
                heads = slice(ti * kv // tp, (ti + 1) * kv // tp)
                extra = [t[n][:, heads] for n in ("ks", "vs")] if "ks" in t else []
                cols.append(fn(q, t["k"][:, heads], t["v"][:, heads], t["pos"], *extra).numpy())
        rows.append(np.concatenate(cols, axis=-1))
    return np.concatenate(rows)


def test_tp_attention_per_shard_matches_jax():
    """K2 on each shard's local heads and slots (tp 4, dp 2): the port's
    single-card dispatch (models/llama.py:_attention) on the rank's blocks,
    as _block_sharded calls it, against JAX's maybe_tp_attention."""
    inp = _attn_inputs(2, 1, 8, 4, 32, 64, 7, seed=3)
    with jax_mesh(jmake_mesh(tp=4, dp=2)):
        want = np.asarray(jmaybe_tp_attention(_attention_local, *(
            jnp.asarray(inp[k]) for k in ("q", "k", "v", "pos"))))
    got = _per_shard(_attention, inp, 4, 2)
    _close(got, want, "K2 per shard", 1e-5)


def test_tp_attention_quant_per_shard_matches_jax():
    """K4 on each shard of the int8 cache (tp 2, dp 2): _attention with the
    rank's scale planes, against JAX's K4 in interpret mode under
    shard_map (maybe_tp_attention_quant), and against the scale-folded
    math."""
    inp = _attn_inputs(2, 1, 4, 4, 64, 128, 41, seed=21, quantized=True)
    args = [jnp.asarray(inp[k]) for k in ("q", "k", "v", "pos", "ks", "vs")]
    with jax_mesh(jmake_mesh(tp=2, dp=2)):
        want = np.asarray(jmaybe_tp_attention_quant(*args))
    got = _per_shard(_attention, inp, 2, 2)
    _close(got, want, "K4 per shard")
    _close(got, np.asarray(jattention_math(*args)), "K4 per shard against the math", 2e-2)


SP_MESHES = [(1, 4), (2, 2)]  # (tp, sp)


@pytest.mark.parametrize("tp,sp", SP_MESHES)
def test_attention_math_sp_matches_jax(tmp_path, tp, sp):
    """The flash combine over sp (positions from 0 to past the first
    shard, so that high shards are fully masked), over the dense and the
    int8 cache, composed with a tp head split."""
    runs = [_attn_inputs(2, 1, 4, 4, 64, 32, 17, seed=8),
            _attn_inputs(2, 3, 4, 4, 64, 32, 40, seed=9, quantized=True)]
    want = []
    with jax_mesh(jmake_mesh(tp=tp, sp=sp)):
        want.append(np.asarray(jmaybe_tp_attention(_attention_local, *(
            jnp.asarray(runs[0][k]) for k in ("q", "k", "v", "pos")))))
        want.append(np.asarray(jmaybe_tp_attention_quant(*(
            jnp.asarray(runs[1][k]) for k in ("q", "k", "v", "pos", "ks", "vs")))))
    save(tmp_path, "sp.pkl", runs)
    run_ranks("attention_sp", tp * sp, tmp_path, name="sp", tp=tp, sp=sp)
    for i, what in enumerate(("dense", "int8")):
        # rank sp_i * tp + tp_i holds its heads' output, the same on every sp_i
        for sp_i in range(sp):
            full = np.concatenate([load(tmp_path, f"sp.rank{sp_i * tp + t}.pkl")[i]
                                   for t in range(tp)], axis=-1)
            _close(full, want[i], f"{what} sp rank {sp_i}", 1e-5)


def _fwd_config(weights: str, kv: str, cls=ModelConfig):
    """dim 512, hd 128: every rank's block at tp 2 and 4 is a width the JAX
    w4x8 launcher takes (a multiple of 128) and a row block of whole
    128-row groups."""
    return cls(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=1024,
               max_seq_len=64, dtype="float32",
               weight_dtype="int8" if weights == "q8_0" else "int4", kv_dtype=kv)


# (weights, cache) of each mesh's forwards: every format and both caches
FORWARD_RUNS = (("q8_0", "bfloat16"), ("q8_0", "int8"), ("q4_0", "int8"), ("w4x8", "bfloat16"))
FORWARD_MESHES = ((2, 1, 1), (4, 1, 1), (2, 2, 1), (2, 1, 2))  # (tp, dp, sp)


def sharded_forwards(tmp_path, monkeypatch, tp, dp, sp):
    """Each run of FORWARD_RUNS (Q8_0 over the bf16 and the int8 cache,
    Q4_0 over the int8 cache, w4x8 over the bf16 cache; f32 compute): the
    port's ranks on the (tp, dp, sp) mesh and JAX's meshed forward
    (interpret mode) on the same numpy weights: an 8-token prefill of 2
    rows, then one decode step. The ranks' logits against JAX's within
    1e-4 of max|logit| (SP_INT8_TOL under sp over the int8 cache,
    W4A8_TOL for w4x8 at tp = 4 and on sp alone); every
    rank's the same; each rank's cache block. On a mesh of sp alone JAX
    runs no matmul kernel (its maybe_tp_matmul returns None at tp = dp = 1
    and XLA dequantizes), so w4x8 there, whose kernel rounds the
    activations to int8, is held to JAX's one-card forward in interpret
    mode."""
    runs, want, exact = [], [], []
    tokens = np.random.default_rng(22).integers(0, 512, (2, 8)).astype(np.int64)
    step = (tokens[:, :1].copy(), np.full(2, 8, np.int64))
    for weights, kv in FORWARD_RUNS:
        monkeypatch.setenv("LLAMAGO_INT4_EXEC", "w4x8" if weights == "w4x8" else "q4_0")
        jcfg = _fwd_config(weights, kv, JModelConfig)
        tensors = random_ggjt_tensors(jcfg, seed=23)
        one_card_ref = weights == "w4x8" and tp == dp == 1
        with jax_mesh(None if one_card_ref else jmake_mesh(tp=tp, dp=dp, sp=sp)) as mesh:
            params = jparams.load_parameters(
                jcfg, tensors, shardings=None if mesh is None else jparam_shardings(jcfg, mesh))
            cache = JKVCache.create(jcfg, batch=2, sharding=None if mesh is None else
                                    jcache_sharding(jcfg, mesh, batch=2))
            lg, cache = jforward_impl(params, jnp.asarray(tokens, jnp.int32), cache,
                                      jnp.zeros(2, jnp.int32), jcfg, return_all_logits=True)
            lg1, _ = jforward_impl(params, jnp.asarray(step[0], jnp.int32), cache,
                                   jnp.asarray(step[1], jnp.int32), jcfg)
            want.append((np.asarray(lg), np.asarray(lg1)))
        host = _np_tree(jparams.load_parameters(jcfg, tensors))
        if sp > 1 and kv == "int8":
            exact.append(_jax_one_card_math(jcfg, host, tokens, step, monkeypatch))
        assert ("q4x" in host["layers"]["wq"]) == (weights == "w4x8")
        runs.append({"config": _fwd_config(weights, kv).__dict__, "params": host,
                     "tokens": tokens, "pos": np.zeros(2, np.int64), "steps": [step]})
    save(tmp_path, "fwd.pkl", runs)
    run_ranks("forwards", tp * dp * sp, tmp_path, name="fwd", tp=tp, dp=dp, sp=sp)
    for r in range(tp * dp * sp):
        got = load(tmp_path, f"fwd.rank{r}.pkl")
        one_card = iter(exact)
        for (weights, kv), g, (w, w1) in zip(FORWARD_RUNS, got, want):
            what = f"{weights}, cache {kv}, rank {r}"
            tol = SP_INT8_TOL if sp > 1 and kv == "int8" else TOL
            if weights == "w4x8" and (tp == 4 or tp == dp == 1):
                tol = W4A8_TOL
            if tol == SP_INT8_TOL:
                e, e1 = next(one_card)
                _close(g["logits"], e, what + " against one card")
                _close(g["steps"][0], e1, what + ", decode step against one card")
            _close(g["logits"], w, what, tol)
            _close(g["steps"][0], w1, what + ", decode step", tol)
            assert g["cache"] == [2 // dp, 4 // tp, 64 // sp, 128], what


def _jax_one_card_math(jcfg, host, tokens, step, monkeypatch):
    """JAX's one-card forward with its matmul kernels in interpret mode and
    the int8 cache's attention on the math (LLAMAGO_ATTN_LENAWARE off), the
    function the sp path computes."""
    jax.clear_caches()
    monkeypatch.setattr(jattention, "_LENAWARE", False)
    old, jkernels.FORCE_INTERPRET = jkernels.FORCE_INTERPRET, True
    try:
        params = jax.tree.map(jnp.asarray, host)
        cache = JKVCache.create(jcfg, batch=2)
        lg, cache = jforward_impl(params, jnp.asarray(tokens, jnp.int32), cache,
                                  jnp.zeros(2, jnp.int32), jcfg, return_all_logits=True)
        lg1, _ = jforward_impl(params, jnp.asarray(step[0], jnp.int32), cache,
                               jnp.asarray(step[1], jnp.int32), jcfg)
        return np.asarray(lg), np.asarray(lg1)
    finally:
        jkernels.FORCE_INTERPRET = old
        monkeypatch.setattr(jattention, "_LENAWARE", True)
        jax.clear_caches()


@pytest.mark.parametrize("tp,dp,sp", FORWARD_MESHES)
def test_sharded_forward_matches_jax_meshed(tmp_path, monkeypatch, tp, dp, sp):
    sharded_forwards(tmp_path, monkeypatch, tp, dp, sp)


# JAX's partitioned compile divides absmax by 127 where its one-card compile
# multiplies by fl(1/127) (1 ulp apart on some rows), so under sp its int8
# cache rounds some elements the other way: its meshed forward is 2.1e-4
# (Q8_0) and 7.5e-4 (w4x8, whose activations are rounded to int8 too) of
# max|logit| off its own one-card one. The port's sp forward is held to the
# one-card JAX forward with the math attention within TOL, and to the meshed
# one within this.
SP_INT8_TOL = 1e-3
# K5 rounds every activation to int8 per 128-group: a step function. Where
# the sums before it run in another order than JAX's (the 4-way all-reduce
# at tp = 4, the sp combine against JAX's one-card K2), a 1-ulp difference
# flips some roundings, and the logits move by 2.8e-3 (tp = 4) and 1.6e-2
# (sp = 2) of max|logit| (read on this CPU). At tp = 2, dp = 2, tp x dp and
# tp x sp the order is JAX's and w4x8 holds TOL; K5 on a rank's block holds
# TOL everywhere (test_tp_matmul_matches_jax_shard_map).
W4A8_TOL = 3e-2
