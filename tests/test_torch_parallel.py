"""The port's parallel path against the JAX package's GSPMD mesh
(mirrors tests/test_parallel.py).

The mesh grid, each leaf's split and the cache's against JAX's
param_shardings / cache_sharding specs, then the tp = 2 and tp = 4
forwards of gloo CPU ranks (tests/torch_ranks.py) against JAX's meshed
forward on its 8 CPU devices, on the same numpy weights: f32, within 1e-4
of max|logit|, every rank's logits the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llamago_tpu.checkpoint.params import host_parameters
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.models.llama import forward_impl as jforward_impl
from llamago_tpu.parallel import cache_sharding as jcache_sharding
from llamago_tpu.parallel import make_mesh as jmake_mesh
from llamago_tpu.parallel import param_shardings as jparam_shardings
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu_torch.config import MODEL_PRESETS
from llamago_tpu_torch.parallel import cache_sharding, make_mesh, param_shardings
from llamago_tpu_torch.parallel.mesh import Mesh

from conftest import random_ggjt_tensors
from test_torch_tp_kernels import sharded_forwards
from torch_ranks import load, run_ranks, save

TOL = 1e-4  # x max|logit|, f32: the tp all-reduce sums its partials in another order


def _spec_kind(spec) -> str | None:
    """A JAX PartitionSpec of a leaf as the port's kind."""
    spec = tuple(spec)
    if "tp" not in spec:
        return None
    return "col" if spec.index("tp") == len(spec) - 1 else "row"


@pytest.mark.parametrize("tp,dp,sp", [(4, 2, 1), (2, 2, 2), (8, 1, 1), (1, 2, 4)])
def test_mesh_coordinates_follow_the_jax_grid(tp, dp, sp):
    jmesh = jmake_mesh(tp=tp, dp=dp, sp=sp)
    assert dict(jmesh.shape) == Mesh(tp=tp, dp=dp, sp=sp).shape
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)  # [dp, sp, tp]
    for rank in range(tp * dp * sp):
        m = Mesh(tp=tp, dp=dp, sp=sp, rank=rank)
        assert ids[m.coord("dp"), m.coord("sp"), m.coord("tp")] == jax.devices()[rank].id
        for axis in ("dp", "sp", "tp"):
            assert m.axis_ranks(axis)[m.coord(axis)] == rank


def test_make_mesh_counts_devices_and_needs_a_world():
    with pytest.raises(ValueError, match="mesh needs 32 devices, have 8"):
        make_mesh(tp=16, dp=2, devices=["cpu"] * 8)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(tp=2, devices=["cpu"] * 2)
    assert make_mesh(devices=["cpu"]).world == 1


@pytest.mark.parametrize("preset,tp", [("tiny", 2), ("tiny", 4), ("tiny", 8),
                                       ("tiny-gqa", 2), ("tiny-gqa", 4)])
def test_param_kinds_match_jax_specs(preset, tp):
    """tiny-gqa at tp = 4: kv_heads 2 do not divide, wk / wv replicate,
    wq / wo split (JAX's head gate)."""
    jsh = jparam_shardings(JPRESETS[preset], jmake_mesh(tp=tp))
    kinds = param_shardings(MODEL_PRESETS[preset], Mesh(tp=tp))
    for key in ("tok_embeddings", "norm", "output"):
        assert kinds[key] == _spec_kind(jsh[key].spec), key
    for key, sh in jsh["layers"].items():
        assert kinds["layers"][key] == _spec_kind(sh.spec), key
    if preset == "tiny-gqa" and tp == 4:
        assert kinds["layers"]["wk"] is None and kinds["layers"]["wv"] is None
        assert kinds["layers"]["wq"] == "col" and kinds["layers"]["wo"] == "row"


@pytest.mark.parametrize("preset,tp,dp,sp,batch", [
    ("tiny", 4, 2, 1, None), ("tiny-gqa", 4, 1, 1, None), ("tiny", 2, 2, 2, 4),
    ("tiny", 2, 2, 2, 3)])
def test_cache_sharding_matches_jax(preset, tp, dp, sp, batch):
    jmesh = jmake_mesh(tp=tp, dp=dp, sp=sp)
    spec = jcache_sharding(JPRESETS[preset], jmesh, batch=batch).spec  # [L, B, KV, S, hd]
    cs = cache_sharding(MODEL_PRESETS[preset], Mesh(tp=tp, dp=dp, sp=sp), batch=batch)
    assert cs.batch == (dp if spec[1] == "dp" else 1)
    assert cs.kv == (tp if spec[2] == "tp" else 1)
    assert cs.seq == (sp if spec[3] == "sp" else 1)
    assert cs.local_shape(4, 4, 128)[2] == 128 // cs.seq


def _f32(preset):
    return (JPRESETS[preset].replace(dtype="float32", weight_dtype="float32"),
            MODEL_PRESETS[preset].replace(dtype="float32", weight_dtype="float32"))


def _jax_meshed(jcfg, host, tp, tokens, steps=()):
    """JAX's forward on its tp mesh: all positions' logits of `tokens` at
    position 0, then each decode step's."""
    mesh = jmake_mesh(tp=tp)
    shardings = jparam_shardings(jcfg, mesh)
    params = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(np.asarray(a, np.float32)), s),
                          host, shardings)
    b = tokens.shape[0]
    cache = JKVCache.create(jcfg, batch=b, dtype=jnp.float32,
                            sharding=jcache_sharding(jcfg, mesh))
    logits, cache = jforward_impl(params, jnp.asarray(tokens, jnp.int32), cache,
                                  jnp.zeros(b, jnp.int32), jcfg, return_all_logits=True)
    outs = []
    for tok, pos in steps:
        lg, cache = jforward_impl(params, jnp.asarray(tok, jnp.int32), cache,
                                  jnp.asarray(pos, jnp.int32), jcfg)
        outs.append(np.asarray(lg))
    return np.asarray(logits), outs


def _assert_close(got, want, what):
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= TOL, f"{what}: max|d| / max|logit| = {err:.2e}"


@pytest.mark.parametrize("preset,tp,seed", [("tiny", 2, 5), ("tiny", 4, 5),
                                            ("tiny-gqa", 2, 6), ("tiny-gqa", 4, 6)])
def test_tp_forward_matches_jax_meshed(tmp_path, preset, tp, seed):
    """Prefill, then decode through the cache: tiny at tp 2 and 4 (every
    leaf split), tiny-gqa at tp 2 (the cache's kv heads split) and 4 (wk,
    wv and the cache whole; the query heads gathered over tp)."""
    jcfg, cfg = _f32(preset)
    host = host_parameters(jcfg, random_ggjt_tensors(jcfg, seed=seed))
    tokens = np.array([[1, 5, 42, 300, 7]], np.int64)
    steps = [(np.array([[9]], np.int64), np.array([5], np.int64)),
             (np.array([[77]], np.int64), np.array([6], np.int64))]
    want, want_steps = _jax_meshed(jcfg, host, tp, tokens, steps)
    save(tmp_path, "fwd.pkl", [{"config": cfg.__dict__, "params": host, "tokens": tokens,
                                "pos": np.zeros(1, np.int64), "steps": steps}])
    run_ranks("forwards", tp, tmp_path, name="fwd", tp=tp)
    for r in range(tp):
        got = load(tmp_path, f"fwd.rank{r}.pkl")[0]
        _assert_close(got["logits"], want, f"rank {r} prefill")
        for i, (g, w) in enumerate(zip(got["steps"], want_steps)):
            _assert_close(g, w, f"rank {r} decode step {i}")
        hd, d = cfg.head_dim, cfg.dim
        gqa_whole = cfg.kv_heads % tp != 0
        assert got["shapes"]["wq"] == [d, cfg.n_heads * hd // tp]
        assert got["shapes"]["wk"] == [d, cfg.kv_heads * hd // (1 if gqa_whole else tp)]
        assert got["shapes"]["wo"] == [cfg.n_heads * hd // tp, d]
        assert got["shapes"]["w2"] == [cfg.ffn_hidden // tp, d]
        assert got["head"] == [d, cfg.vocab_size // tp]
        assert got["cache"][1] == cfg.kv_heads // (1 if gqa_whole else tp)


@pytest.mark.parametrize("tp,dp,sp", [(1, 2, 1), (1, 1, 2)])
def test_dp_and_sp_forwards_match_jax_meshed(tmp_path, monkeypatch, tp, dp, sp):
    """dp = 2 (each rank its slot of the cache, the logits gathered) and
    sp = 2 (each rank its half of the positions, the flash combine): the
    runs of test_torch_tp_kernels.py's sharded forwards, Q8_0, Q4_0 and
    w4x8 weights over the bf16, f32 and int8 caches."""
    sharded_forwards(tmp_path, monkeypatch, tp, dp, sp)


@pytest.mark.parametrize("fmt", ["dense", "q8", "q4", "w4x8"])
@pytest.mark.parametrize("kind", ["col", "row"])
def test_shard_leaf_blocks_are_the_slices_and_own_their_memory(fmt, kind):
    """Each block equals the leaf's slice at its block granularity, and
    owns a copy of only its rows or columns: a row block kept as a view
    would hold the whole leaf's storage on the rank."""
    import torch

    from llamago_tpu_torch.ops.quant import quantize, quantize_w4x8
    from llamago_tpu_torch.parallel.sharding import shard_leaf, split_ok

    w = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 256)).astype(np.float32))
    leaf = {"dense": lambda: w, "q8": lambda: quantize(w, 8), "q4": lambda: quantize(w, 4),
            "w4x8": lambda: quantize_w4x8(w)}[fmt]()
    parts = leaf if isinstance(leaf, dict) else {"w": leaf}
    assert split_ok(leaf, kind, 2)
    for i in range(2):
        block = shard_leaf(leaf, kind, 2, i)
        blocks = block if isinstance(block, dict) else {"w": block}
        for key, full in parts.items():
            dim = -1 if kind == "col" else -2
            n = full.shape[dim] // 2
            want = full.narrow(dim, i * n, n)
            got = blocks[key]
            assert torch.equal(got, want) and got.is_contiguous()
            assert got.untyped_storage().nbytes() == want.numel() * want.element_size()
