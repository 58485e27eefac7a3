"""Sharded training of the port against the JAX package's meshed training.

The differentiable collectives of parallel/mesh.py on two gloo CPU ranks
(tests/torch_ranks.py) against one process's autograd; then the full-weight
`train_step` of the tiny model (and tiny-gqa at tp 4, where wk / wv stay
whole) at tp 2, dp 2, sp 2, tp 2 x dp 2 and tp 2 x sp 2 against the JAX
package's `train_step` on its meshes of 8 CPU devices (GSPMD with the
mesh active, as its CLI runs it), on the same numpy weights and batches:

  * each step's loss within 1e-5 of JAX's, relative;
  * every trained leaf's gradient, the ranks' blocks put together, within
    1e-4 of max|g| of JAX's `jax.grad(loss_fn)` (a gradient off by a
    factor of tp or sp fails);
  * the parameters after one AdamW step within 1e-5 of their largest
    magnitude, but for the few elements whose gradient is near the f32
    noise of the sums (tests/test_torch_training.py's rule);
  * after three steps every leaf bit-equal on the ranks that hold the
    same block (a replicated leaf: on every rank);

and, on the meshes, `remat=True` against `remat=False` and a train state
saved after two steps and resumed for the third against three straight
steps, bit for bit. f32 throughout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.models import training as jtraining
from llamago_tpu.parallel import make_mesh as jmake_mesh
from llamago_tpu.parallel import param_shardings as jparam_shardings
from llamago_tpu_torch.config import MODEL_PRESETS

from conftest import random_ggjt_tensors
from test_torch_tp_kernels import jax_mesh
from test_torch_training import _assert_adam_close
from torch_ranks import load, run_ranks, save

LOSS_TOL = 1e-5  # relative
GRAD_TOL = 1e-4  # x max|g|


def _np_tree(tree):
    """Host copies (the steps donate their input buffers)."""
    return jax.tree.map(lambda a: np.array(a, copy=True), jax.device_get(tree))


def batches(seed: int, n: int = 3, b: int = 4, t: int = 16, vocab: int = 512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (b, t)).astype(np.int32) for _ in range(n)]


def jax_meshed_steps(jcfg, tensors, steps, tp, dp, sp, step_fn, init_opt, wrap=None):
    """JAX's step on its (dp, sp, tp) mesh of CPU devices with the mesh
    active, the model loaded from the file tensors with the mesh's
    shardings: each step's loss and the tree after the first step and
    after the last (numpy). `wrap(params)` makes the trained tree (LoRA)."""
    mesh = jmake_mesh(tp=tp, dp=dp, sp=sp)
    with jax_mesh(mesh, interpret=False):
        params = jparams.load_parameters(jcfg, tensors, shardings=jparam_shardings(jcfg, mesh))
        if wrap is not None:
            params = wrap(params)
        opt = init_opt(params)
        dp_rows = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp", None))
        losses, first = [], None
        ctx = jax.sharding.use_mesh(mesh) if hasattr(jax.sharding, "use_mesh") else mesh
        with ctx:
            for i, tok in enumerate(steps):
                params, opt, loss = step_fn(params, opt, jax.device_put(tok, dp_rows), jcfg)
                losses.append(float(loss))
                if i == 0:
                    first = _np_tree(params)
        return losses, first, _np_tree(params)


def flat_jax(tree, prefix=""):
    """path -> numpy of a JAX tree with stacked layers, in the port's
    per-layer paths ("layers/0/wq", "layers/1/wq/lora_a")."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_jax(v, f"{prefix}/{k}" if prefix else k))
        return out
    arr = np.asarray(tree)
    if prefix.startswith("layers/"):
        key = prefix.removeprefix("layers/")
        return {f"layers/{i}/{key}": arr[i] for i in range(arr.shape[0])}
    return {prefix: arr}


def whole(ranks: list[dict], path: str, shape, tp: int) -> np.ndarray:
    """A leaf whole from the ranks' flat trees: rank i < tp holds tp block
    i (dp = sp = 0), cut along the dim whose size differs from `shape`."""
    a = ranks[0][path]
    if a.shape == tuple(shape):
        return a
    ax = next(d for d in range(a.ndim) if a.shape[d] != shape[d])
    return np.concatenate([ranks[i][path] for i in range(tp)], axis=ax)


def assert_grads_close(ranks, want: dict, tp: int, paths=None):
    for path in paths or want:
        w = want[path]
        g = whole(ranks, path, w.shape, tp)
        err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        assert err <= GRAD_TOL, f"{path}: max|d| / max|g| = {err:.2e}"


def assert_blocks_agree(outs: list[dict], key: str, tp: int, whole_shapes: dict):
    """Every leaf bit-equal on the ranks that hold the same block (rank r
    holds tp block r % tp), and a leaf of its whole shape (`whole_shapes`,
    by path: a replicated one) bit-equal on every rank."""
    for path, a in outs[0][key].items():
        replicated = whole_shapes.get(path) == a.shape
        for r, o in enumerate(outs):
            ref = outs[0 if replicated else r % tp][key][path]
            assert np.array_equal(o[key][path], ref), (
                f"{path}: rank {r} differs from rank {0 if replicated else r % tp}")


# --------------------------------------------------------- collectives

def test_differentiable_collectives_match_one_process_autograd(tmp_path):
    """Each form alone and the column / row blocks they build: the value
    and x's gradient on every rank against one process's autograd of the
    whole function. copy_to's backward sums the ranks' parts and the
    others pass or cut theirs: doing either twice would double a
    gradient, which this catches."""
    rng = np.random.default_rng(0)
    inp = {"x": rng.standard_normal((4, 6)).astype(np.float32),
           "w": rng.standard_normal((6, 4)).astype(np.float32),
           "g": rng.standard_normal((4, 6)).astype(np.float32)}
    save(tmp_path, "coll.pkl", inp)
    run_ranks("collectives", 2, tmp_path)
    x, w, g = (torch.from_numpy(inp[k]) for k in ("x", "w", "g"))
    xr = x.clone().requires_grad_(True)
    (xr @ w).backward(g[:, :4])
    dx_prod = xr.grad.numpy()
    for r in range(2):
        got = load(tmp_path, f"coll.rank{r}.pkl")
        rows = slice(3 * r, 3 * r + 3)
        mine = np.zeros((4, 6), np.float32)
        mine[:, rows] = (g[:, :4] @ w[rows].T).numpy()  # reduce_from: this rank's rows
        only = np.zeros((4, 6), np.float32)
        only[:, rows] = inp["g"][:, rows]  # gather_from: this rank's slice
        want = {
            "copy_to": ((x @ w[:, 2 * r:2 * r + 2]).numpy(), dx_prod),
            "reduce_from": ((x @ w).numpy(), mine),
            "gather_from": (inp["x"], only),
            "tp_slice": (inp["x"][:, rows], inp["g"]),
            "column_block": ((x @ w).numpy(), dx_prod),
            "row_block": ((x @ w).numpy(), dx_prod),
        }
        for name, (y, dx) in want.items():
            np.testing.assert_allclose(got[name]["y"], y, rtol=1e-6, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(got[name]["dx"], dx, rtol=1e-6, atol=1e-6, err_msg=name)


# --------------------------------------------------------- train_step

MESHES = [("tiny", 2, 1, 1), ("tiny", 1, 2, 1), ("tiny", 1, 1, 2), ("tiny", 2, 2, 1),
          ("tiny", 2, 1, 2), ("tiny-gqa", 4, 1, 1)]


@functools.cache
def _dense(preset):
    """(JAX config, file tensors, host tree, port config): f32, stacked and
    unfused, as the JAX package loads a model under a mesh."""
    jcfg = JPRESETS[preset].replace(dtype="float32", weight_dtype="float32", max_seq_len=32)
    tensors = random_ggjt_tensors(jcfg, seed=11)
    host = _np_tree(jparams.load_parameters(jcfg, tensors))
    return jcfg, tensors, host, MODEL_PRESETS[preset].replace(**{
        k: getattr(jcfg, k) for k in ("dtype", "weight_dtype", "max_seq_len")})


@functools.cache
def _jax_grads(preset, seed):
    jcfg, _, host, _ = _dense(preset)
    loss, grads = jax.jit(jax.value_and_grad(jtraining.loss_fn), static_argnums=2)(
        jax.tree.map(jnp.asarray, host), jnp.asarray(batches(seed)[0]), jcfg)
    return float(loss), flat_jax(_np_tree(grads))


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}-tp{m[1]}dp{m[2]}sp{m[3]}")
def meshed(request, tmp_path_factory):
    """The port's ranks and JAX's mesh on three steps of the preset."""
    preset, tp, dp, sp = request.param
    jcfg, tensors, host, cfg = _dense(preset)
    steps = batches(7)
    want = jax_meshed_steps(jcfg, tensors, steps, tp, dp, sp, jtraining.train_step,
                            lambda p: jtraining.make_optimizer().init(p))
    d = tmp_path_factory.mktemp("train")
    save(d, "tr.pkl", [{"config": cfg.__dict__, "params": host, "resume": True, "remat": True,
                        "steps": [s.astype(np.int64) for s in steps]}])
    run_ranks("train", tp * dp * sp, d, name="tr", tp=tp, dp=dp, sp=sp, timeout=240)
    outs = [load(d, f"tr.rank{r}.pkl")[0] for r in range(tp * dp * sp)]
    return request.param, want, outs


def test_train_step_loss_and_gradients_match_jax(meshed):
    (preset, tp, dp, sp), (want_losses, _, _), outs = meshed
    for r, o in enumerate(outs):
        for i, (g, w) in enumerate(zip(o["losses"], want_losses)):
            assert abs(g - w) <= LOSS_TOL * abs(w), f"rank {r} step {i}: {g} vs {w}"
    _, want = _jax_grads(preset, 7)
    assert_grads_close([o["grads"] for o in outs], want, tp)


def test_train_step_parameters_match_jax_after_one_step(meshed):
    (_, tp, _, _), (_, first, _), outs = meshed
    for path, w in flat_jax(first).items():
        got = whole([o["params"] for o in outs], path, w.shape, tp)
        _assert_adam_close(torch.from_numpy(got), w, 1e-4, 1)


def test_train_step_keeps_replicated_leaves_bit_equal(meshed):
    """After three steps: a block bit-equal on the ranks of its tp index,
    a replicated leaf on every rank; the tp blocks really are blocks."""
    (preset, tp, _, _), (_, first, _), outs = meshed
    shapes = {k: v.shape for k, v in flat_jax(first).items()}
    assert_blocks_agree(outs, "last", tp, shapes)
    assert any(outs[0]["last"][k].shape == v for k, v in shapes.items())
    ffn = MODEL_PRESETS[preset].ffn_hidden
    assert outs[0]["last"]["layers/0/w1"].shape[-1] * tp == ffn
    assert outs[0]["last"]["layers/0/w2"].shape[-2] * tp == ffn


def test_remat_on_and_off_give_equal_gradients_on_a_mesh(meshed):
    """loss_fn with remat (every layer recomputed, its collectives re-run
    in the same order on every rank) against without: the same loss and
    gradients on each rank, within f32 noise."""
    _, _, outs = meshed
    for o in outs:
        on, off = o["remat"]
        assert abs(on["loss"] - off["loss"]) <= 1e-6 * abs(off["loss"])
        for path, g in off["grads"].items():
            np.testing.assert_allclose(on["grads"][path], g, rtol=0,
                                       atol=1e-6 * np.abs(g).max(), err_msg=path)


def test_train_state_resume_on_a_mesh_equals_continuing(meshed):
    """Two steps, save (a file a rank), restore into a fresh tree and
    optimizer on the same mesh, one more step: bit for bit the three
    straight steps' parameters on every rank."""
    _, _, outs = meshed
    for o in outs:
        assert o["resumed"].keys() == o["last"].keys()
        for path, a in o["resumed"].items():
            assert np.array_equal(a, o["last"][path]), path
