"""Port parity: the forward pass (models/llama.py), the parameter builders
(checkpoint/params.py) and the KV-cache write against the JAX package.

Weights are assembled by the JAX package from seeded numpy checkpoint
tensors (dense f32, or fused Q8_0), carried across with
`params_from_numpy`, and both forward passes run on the CPU. Logits agree to 1e-4 (rtol and atol): the
port runs K2's plain online softmax where the JAX CPU path runs one
masked softmax, and sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.models import llama as jllama
from llamago_tpu.ops import quant as jquant
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu_torch.checkpoint import params
from llamago_tpu_torch.config import MODEL_PRESETS
from llamago_tpu_torch.models import llama
from llamago_tpu_torch.ops import quant
from llamago_tpu_torch.runtime.kv_cache import KVCache, write_rows

from conftest import random_ggjt_tensors

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
TOKENS = np.array([[1, 5, 42, 300, 7, 19], [1, 9, 77, 123, 4, 2]], np.int32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _dense(name, seed=1):
    jcfg = JPRESETS[name].replace(dtype="float32", weight_dtype="float32")
    host = jparams.host_parameters(jcfg, random_ggjt_tensors(jcfg, seed=seed))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), host)
    return jcfg, jp


def _q8_fused(name, seed=5, **over):
    """Fused, layered Q8_0 weights (bf16 scales) as JAX arrays: the dense
    checkpoint tensors quantized with the port's quantize (bit-exact with
    JAX's, tests/test_torch_ops.py), padded and fused by the JAX package."""
    jcfg = JPRESETS[name].replace(dtype="float32", weight_dtype="int8", **over)
    host = jparams.host_parameters(jcfg, random_ggjt_tensors(jcfg, seed=seed))

    def q8(a):
        leaf = quant.quantize(torch.from_numpy(np.ascontiguousarray(a, np.float32)))
        return {"q8": jnp.asarray(leaf["q8"].numpy()),
                "s": jnp.asarray(leaf["s"].float().numpy(), jnp.bfloat16)}

    jp = {"tok_embeddings": jnp.asarray(host["tok_embeddings"]),
          "norm": jnp.asarray(host["norm"]),
          "output": jquant.pad_lm_head(q8(host["output"]), vocab_size=jcfg.vocab_size),
          "layers": {k: (q8(v) if k in quant.QUANT_LEAVES else jnp.asarray(v))
                     for k, v in host["layers"].items()}}
    jp = jparams.fuse_layer_weights(jparams.unstack_layer_params(jp, jcfg.n_layers))
    return jcfg, jp


def _port_config(jcfg):
    cfg = MODEL_PRESETS["tiny"].replace(**{
        f: getattr(jcfg, f) for f in ("vocab_size", "dim", "n_layers", "n_heads",
                                      "n_kv_heads", "multiple_of", "max_seq_len",
                                      "dtype", "weight_dtype")})
    assert cfg.ffn_hidden == jcfg.ffn_hidden
    return cfg


def _run_jax(jcfg, jp, tokens, layered, **kw):
    cache = JKVCache.create(jcfg, batch=tokens.shape[0], layered=layered)
    out = jllama.forward_impl(jp, jnp.asarray(tokens), cache,
                              jnp.zeros(tokens.shape[0], jnp.int32), jcfg, **kw)
    return np.asarray(out[0])


def _run_port(jcfg, jp, tokens, **kw):
    cfg = _port_config(jcfg)
    tp = params.params_from_numpy(_np_tree(jp), device="cpu")
    cache = KVCache.create(cfg, batch=tokens.shape[0], device="cpu")
    out = llama.forward_impl(tp, torch.from_numpy(tokens), cache,
                             torch.zeros(tokens.shape[0], dtype=torch.long), cfg, **kw)
    return out[0].numpy()


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_forward_dense_f32_matches_jax(name):
    jcfg, jp = _dense(name)
    want = _run_jax(jcfg, jp, TOKENS, layered=False, return_all_logits=True)
    got = _run_port(jcfg, jp, TOKENS, return_all_logits=True)
    assert got.shape == (2, 6, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_forward_fused_q8_matches_jax(name):
    jcfg, jp = _q8_fused(name)
    assert "wqkv" in jp["layers"][0] and jp["layers"][0]["wqkv"]["q8"].dtype == jnp.int8
    want = _run_jax(jcfg, jp, TOKENS, layered=True)
    got = _run_port(jcfg, jp, TOKENS)
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_padded_lm_head_sliced_like_jax():
    jcfg, jp = _q8_fused("tiny", vocab_size=4000)
    assert jp["output"]["q8"].shape == (64, 4096)  # column-padded head
    idx = np.array([3, 5], np.int32)
    want = _run_jax(jcfg, jp, TOKENS, layered=True, logit_index=jnp.asarray(idx),
                    return_embedding=True)
    got = _run_port(jcfg, jp, TOKENS, logit_index=torch.from_numpy(idx),
                    return_embedding=True)
    assert got.shape == (2, 4000)
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_then_decode_matches_full_prefill():
    """Incremental decode through the KV cache == one full forward."""
    jcfg, jp = _dense("tiny")
    cfg = _port_config(jcfg)
    tp = params.params_from_numpy(_np_tree(jp), device="cpu")
    ids = torch.tensor([[1, 5, 42, 300, 7, 19, 250, 33]])
    full, _ = llama.forward_impl(tp, ids, KVCache.create(cfg, device="cpu"),
                                 torch.zeros(1), cfg, return_all_logits=True)
    cache = KVCache.create(cfg, device="cpu")
    logits, cache = llama.forward_impl(tp, ids[:, :5], cache, torch.zeros(1), cfg)
    np.testing.assert_allclose(logits[0].numpy(), full[0, 4].numpy(), rtol=1e-5, atol=1e-5)
    for i in range(5, 8):
        logits, cache = llama.forward_impl(tp, ids[:, i:i + 1], cache,
                                           torch.tensor([i]), cfg)
        np.testing.assert_allclose(logits[0].numpy(), full[0, i].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_prefill_into_slot_matches_jax():
    jcfg, jp = _q8_fused("tiny-gqa")
    cfg = _port_config(jcfg)
    toks = np.array([[1, 7, 9, 11, 0, 0, 0, 0]], np.int32)
    jcache = JKVCache.create(jcfg, batch=2, layered=True)
    jlogits, jcache = jllama.prefill_into_slot(
        jp, jnp.asarray(toks), jcache, jnp.asarray(1, jnp.int32),
        jnp.asarray([3], jnp.int32), jnp.asarray([3], jnp.int32), jcfg)
    tp = params.params_from_numpy(_np_tree(jp), device="cpu")
    cache = KVCache.create(cfg, batch=2, device="cpu")
    logits, cache = llama.prefill_into_slot(
        tp, torch.from_numpy(toks), cache, 1, torch.tensor([3]), torch.tensor([3]), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for layer in range(cfg.n_layers):
        np.testing.assert_allclose(cache.k[layer].numpy(), np.asarray(jcache.k[layer]),
                                   **TOL)
        np.testing.assert_allclose(cache.v[layer].numpy(), np.asarray(jcache.v[layer]),
                                   **TOL)
    assert not cache.k[0][0].any()  # slot 0 untouched


@pytest.mark.parametrize("starts", [[60, 2], [64, -3], [63, 0]])
def test_cache_write_clamps_like_dynamic_update_slice(starts):
    rng = np.random.default_rng(0)
    layer = rng.standard_normal((2, 2, 64, 8)).astype(np.float32)
    new = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    want = np.asarray(jllama._update_cache(jnp.asarray(layer), jnp.asarray(new),
                                           jnp.asarray(starts, jnp.int32)))
    got = torch.from_numpy(layer.copy())
    write_rows(got, torch.from_numpy(new), torch.tensor(starts))
    np.testing.assert_array_equal(got.numpy(), want)
    # an overrunning start lands at S - T, overwriting the rows before it
    if starts[0] > 60:
        np.testing.assert_array_equal(got[0, :, 60:].numpy(), new[0].transpose(1, 0, 2))


def test_params_from_numpy_keeps_layout_and_dtypes():
    jcfg, jp = _q8_fused("tiny")
    jp["layers"][0]["wo"]["s"] = jp["layers"][0]["wo"]["s"].astype(jnp.float32)
    tree = _np_tree(jp)
    tp = params.params_from_numpy(tree, device="cpu")
    assert isinstance(tp["layers"], tuple) and len(tp["layers"]) == jcfg.n_layers
    assert tp["layers"][0]["wqkv"]["s"].dtype == torch.bfloat16
    assert tp["layers"][0]["wo"]["s"].dtype == torch.float32  # file-style f32 scales
    assert tp["layers"][0]["w13"]["q8"].dtype == torch.int8
    np.testing.assert_array_equal(tp["layers"][1]["w2"]["q8"].numpy(),
                                  tree["layers"][1]["w2"]["q8"])


def test_unstack_and_fuse_match_jax():
    jcfg, jp = _dense("tiny-gqa")
    tp = params.params_from_numpy(_np_tree(jp), device="cpu")
    fused = params.fuse_layer_weights(params.unstack_layer_params(tp, jcfg.n_layers))
    jf = jparams.fuse_layer_weights(jparams.unstack_layer_params(jp, jcfg.n_layers))
    for key in ("wqkv", "w13", "wo", "attention_norm"):
        np.testing.assert_array_equal(fused["layers"][1][key].numpy(),
                                      np.asarray(jf["layers"][1][key]))


def test_random_quantized_parameters_layout_matches_jax():
    jcfg = JPRESETS["tiny-gqa"].replace(weight_dtype="int8", vocab_size=4000)
    jp = jparams.random_quantized_parameters(jcfg, seed=0, layered=True)
    tp = params.random_quantized_parameters(_port_config(jcfg), seed=0, device="cpu")
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    tshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tp)
    assert jax.tree.structure(jshapes) == jax.tree.structure(tshapes)
    assert jax.tree.leaves(jshapes) == jax.tree.leaves(tshapes)
