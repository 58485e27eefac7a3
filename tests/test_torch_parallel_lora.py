"""QLoRA, perplexity and `--lora` merging on a mesh of the port's ranks
against the JAX package's meshed results (tests/test_torch_parallel_train.py
holds the full-weight step and the collectives).

The model is tests/test_torch_speculative.py's (dim 128, two layers, FFN
320, f32 compute) on Q8_0, Q4_0 and w4x8 bases, loaded by the JAX package
stacked and unfused (as it loads a model under a mesh) and carried across.
Adapters of rank 4 on wq / wk / wv / wo with B drawn from a seed (a zero B
leaves A without a gradient); both packages start from JAX's A and B. At
tp 2, dp 2 and sp 2:

  * `lora_train_step`: each step's loss within 1e-5 of JAX's meshed step,
    relative; every adapter's gradient, whole, within 1e-4 of max|g| of
    JAX's `jax.grad`; the adapters after one step within 1e-5 (the AdamW
    rule of tests/test_torch_training.py); after three steps a cut half
    bit-equal on the ranks of its block and a whole half on every rank;
    the JAX w4x8 kernel runs outside interpret mode (above 16 rows, where
    it is the exact dequantized product);
  * `init_lora` under tp: each rank's A the slice of one card's draw;
  * `perplexity` of a Q8_0 model against the JAX package's on its mesh:
    the mean NLL within 1e-5, relative, and window 0's NLL per position.

The int4 bases run in tests/test_torch_parallel_qlora_int4.py (the same
checks; two files for the test workers' balance). Then `--lora` merging
at tp 2: each rank's merged block (the loader
merges whole layer leaves before the cut) bit-equal to the slice of one
card's `merge_lora(attach_lora(...))`.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.config import ModelConfig as JModelConfig
from llamago_tpu.models import lora as jlora
from llamago_tpu.models import training as jtraining
from llamago_tpu.parallel import make_mesh as jmake_mesh
from llamago_tpu.parallel import param_shardings as jparam_shardings
from llamago_tpu_torch.checkpoint import params
from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.models import lora

from conftest import random_ggjt_tensors
from test_torch_parallel_train import (
    LOSS_TOL,
    _np_tree,
    assert_blocks_agree,
    assert_grads_close,
    batches,
    flat_jax,
    jax_meshed_steps,
    whole,
)
from test_torch_speculative import KINDS as SPEC_KINDS
from test_torch_speculative import _config, _int4_exec
from test_torch_tp_kernels import jax_mesh
from test_torch_training import _assert_adam_close
from torch_ranks import load, run_ranks, save

jperplexity = importlib.import_module("llamago_tpu.eval.perplexity")

MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2)]
TARGETS = ("wq", "wk", "wv", "wo")


@functools.cache
def _base(kind):
    """(JAX config, file tensors, host tree stacked and unfused, port
    config)."""
    wdt, exec_format, _, _ = SPEC_KINDS[kind]
    with _int4_exec(exec_format):
        jcfg = _config(JModelConfig, wdt, "auto")
        tensors = random_ggjt_tensors(jcfg, seed=41)
        host = _np_tree(jparams.load_parameters(jcfg, tensors))
    return jcfg, tensors, host, _config(ModelConfig, wdt, "auto")


@functools.cache
def _adapters(kind):
    """JAX's A (seed 3) and a seeded B over the kind's stacked tree, as a
    numpy subtree ({"layers": {key: {"lora_a", "lora_b"}}})."""
    _, _, host, _ = _base(kind)
    jw = jlora.init_lora(host, rank=4, alpha=8.0, targets=TARGETS, seed=3)
    rng = np.random.default_rng(4)
    sub = _np_tree(jlora.extract_lora(jw, jlora.TRAINABLE_KEYS))
    sub = {"layers": {k: sub["layers"][k] for k in TARGETS}}
    for leaf in sub["layers"].values():
        leaf["lora_b"] = (rng.standard_normal(leaf["lora_b"].shape) * 0.1).astype(np.float32)
    return sub


def _wrap(kind):
    def wrap(p):
        return jlora.apply_lora_state(jlora.init_lora(p, rank=4, alpha=8.0, targets=TARGETS,
                                                      seed=3), _adapters(kind))
    return wrap


@functools.cache
def _jax_grads(kind):
    """JAX's loss and every adapter's gradient on the first batch."""
    jcfg, _, host, _ = _base(kind)
    jw = _wrap(kind)(jax.tree.map(jnp.asarray, host))
    tr = jlora.extract_lora(jw, jlora.TRAINABLE_KEYS)
    with _int4_exec(SPEC_KINDS[kind][1]):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda tr: jtraining.loss_fn(jlora.apply_lora_state(jw, tr),
                                         jnp.asarray(batches(9)[0]), jcfg)))(tr)
    return float(loss), flat_jax(_np_tree(grads))


def _ppl_ids():
    return np.random.default_rng(12).integers(3, 512, 70).astype(np.int64)


def run_meshed(mesh_shape, tmp_path_factory, kinds, with_ppl: bool):
    """The LoRA steps of `kinds` (and, `with_ppl`, the Q8_0 perplexity) on
    the port's ranks and on JAX's mesh: (mesh shape, JAX's, the ranks')."""
    tp, dp, sp = mesh_shape
    steps = batches(9)
    want, runs = {}, []
    for kind in kinds:
        jcfg, tensors, host, cfg = _base(kind)
        with _int4_exec(SPEC_KINDS[kind][1]):
            want[kind] = jax_meshed_steps(jcfg, tensors, steps, tp, dp, sp, jlora.lora_train_step,
                                          jlora.init_lora_opt_state, wrap=_wrap(kind))
        ad = flat_jax(_adapters(kind))
        runs.append({"config": cfg.__dict__, "params": host,
                     "steps": [s.astype(np.int64) for s in steps],
                     "lora": {"rank": 4, "alpha": 8.0, "seed": 3,
                              "a": {k: v for k, v in ad.items() if k.endswith("lora_a")},
                              "b": {k: v for k, v in ad.items() if k.endswith("lora_b")}}})
    d = tmp_path_factory.mktemp("lora")
    save(d, "lo.pkl", runs)
    n = tp * dp * sp
    run_ranks("train", n, d, name="lo", tp=tp, dp=dp, sp=sp, timeout=240)
    got = {kind: [load(d, f"lo.rank{r}.pkl")[i] for r in range(n)] for i, kind in enumerate(kinds)}
    if with_ppl:
        jcfg, tensors, host, cfg = _base("q8_0")
        mesh = jmake_mesh(tp=tp, dp=dp, sp=sp)
        with jax_mesh(mesh, interpret=False):
            jp = jparams.load_parameters(jcfg, tensors, shardings=jparam_shardings(jcfg, mesh))
            want["ppl"] = jperplexity.perplexity(jp, jcfg, _ppl_ids(), ctx=32, min_context=8)
            want["nll0"] = np.asarray(jperplexity._window_nll(
                jp, jnp.asarray(_ppl_ids()[None, :32].astype(np.int32)), jcfg))
        save(d, "pp.pkl", [{"config": cfg.__dict__, "params": host, "ids": _ppl_ids(),
                            "ctx": 32, "min_context": 8}])
        run_ranks("ppl", n, d, name="pp", tp=tp, dp=dp, sp=sp)
        got["ppl"] = [load(d, f"pp.rank{r}.pkl")[0] for r in range(n)]
    return mesh_shape, want, got


def check_lora_step(meshed, kind):
    """The module docstring's checks of one base's LoRA steps."""
    (tp, _, _), want, got = meshed
    want_losses, first, _ = want[kind]
    outs = got[kind]
    for r, o in enumerate(outs):
        for i, (g, w) in enumerate(zip(o["losses"], want_losses)):
            assert abs(g - w) <= LOSS_TOL * abs(w), f"rank {r} step {i}: {g} vs {w}"
    _, grads = _jax_grads(kind)
    assert_grads_close([o["grads"] for o in outs], grads, tp)
    adapters = flat_jax(jlora.extract_lora(first, jlora.TRAINABLE_KEYS))
    for path, w in adapters.items():
        got_p = whole([o["params"] for o in outs], path, w.shape, tp)
        _assert_adam_close(torch.from_numpy(got_p), w, 1e-3, 1)
    assert_blocks_agree(outs, "last", tp, {k: v.shape for k, v in adapters.items()})


def check_init_lora(meshed, kind):
    """A drawn whole and cut: the ranks' A together are one card's A of
    the same seed, bit for bit (and equal on every rank where not cut)."""
    (tp, _, _), _, got = meshed
    _, _, host, cfg = _base(kind)
    one = lora.init_lora(params.unstack_layer_params(params.params_from_numpy(host, "cpu"),
                                                     cfg.n_layers),
                         rank=4, alpha=8.0, targets=TARGETS, seed=3)
    for i, lp in enumerate(one["layers"]):
        for key in TARGETS:
            path = f"layers/{i}/{key}/lora_a"
            w = lp[key]["lora_a"].numpy()
            assert np.array_equal(whole([o["init_a"] for o in got[kind]], path, w.shape, tp), w)


MESH_IDS = ["tp{}dp{}sp{}".format(*m) for m in MESHES]


@pytest.fixture(scope="module", params=MESHES, ids=MESH_IDS)
def meshed(request, tmp_path_factory):
    """Q8_0's LoRA steps and perplexity on each mesh (the int4 bases:
    tests/test_torch_parallel_qlora_int4.py)."""
    return run_meshed(request.param, tmp_path_factory, ("q8_0",), with_ppl=True)


def test_lora_train_step_matches_jax_meshed(meshed):
    check_lora_step(meshed, "q8_0")


def test_init_lora_under_tp_cuts_one_cards_draw(meshed):
    check_init_lora(meshed, "q8_0")


def test_perplexity_matches_jax_meshed(meshed):
    _, want, got = meshed
    for r, g in enumerate(got["ppl"]):
        assert g["n_tokens"] == want["ppl"]["n_tokens"] and g["n_windows"] == 2
        assert abs(g["nll"] - want["ppl"]["nll"]) <= 1e-5 * abs(want["ppl"]["nll"]), r
        np.testing.assert_allclose(g["nll0"], want["nll0"].reshape(-1), rtol=1e-5, atol=1e-5)


def test_lora_merge_under_tp_gives_one_cards_slices(tmp_path):
    """load_parameters(..., mesh, adapters) on two ranks: every merged
    block bit-equal to the slice of one card's merge_lora(attach_lora(...))
    of the same Q8_0 file tensors and adapters."""
    cfg = _config(ModelConfig, "int8", "auto")
    tensors = random_ggjt_tensors(_config(JModelConfig, "int8", "auto"), seed=31)
    one = params.unstack_layer_params(params.load_parameters(cfg, tensors, device="cpu"),
                                      cfg.n_layers)
    wrapped = lora.init_lora(one, rank=4, alpha=8.0, targets=TARGETS, seed=5)
    rng = np.random.default_rng(6)
    adapters = {"layers": [
        {k: {"lora_a": v["lora_a"].numpy(), "lora_scale": v["lora_scale"].numpy(),
             "lora_b": (rng.standard_normal(v["lora_b"].shape) * 0.1).astype(np.float32)}
         for k, v in lp.items() if lora.is_lora(v)} for lp in wrapped["layers"]]}
    want = lora.merge_lora(lora.attach_lora(one, adapters))
    save(tmp_path, "merge.pkl", {"config": cfg.__dict__, "tensors": tensors,
                                 "adapters": adapters})
    run_ranks("merged", 2, tmp_path)
    ranks = [load(tmp_path, f"merge.rank{r}.pkl") for r in range(2)]
    for i, lp in enumerate(want["layers"]):
        for key in TARGETS:
            for part, w in lp[key].items():
                path = f"layers/{key}/{part}"
                got = [r[path][i] for r in ranks]
                full = whole([{path: g} for g in got], path, w.shape, 2)
                assert np.array_equal(full, w.float().numpy() if w.is_floating_point()
                                      else w.numpy()), (i, key, part)
                if key == "wo":  # a row block
                    assert got[0].shape[-2] * 2 == w.shape[-2]
                else:
                    assert got[0].shape[-1] * 2 == w.shape[-1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_torch_keeps_a_zero_d_array_zero_d(dtype):
    """A per-layer adapter's lora_scale is 0-d, as jnp.asarray keeps it; a
    (1,)-shaped copy would give the merged leaf an extra leading dim."""
    arr = np.asarray(2.0, dtype=jnp.dtype(dtype))
    assert params.to_torch(arr, "cpu").shape == jnp.asarray(arr).shape == ()
    assert params.to_torch(arr[None], "cpu").shape == (1,)
