"""Port parity: training (models/training.py) and the autograd Functions
of the kernels (ops/kernels.py:FrozenQuantMatmul,
ops/attention.py:FlashAttention) against the JAX package on the CPU.

The models are those of tests/test_torch_speculative.py (dim 128, two
layers, fused wqkv/w13; dense f32, Q8_0, Q4_0 and w4x8 bases), loaded by
the JAX package and carried across, f32 compute in both packages, and the
tiny preset for full-weight training. Where the JAX function reaches a
Pallas kernel whose CPU fallback is another function (K5's activation
rounding at up to 16 rows of a w4x8 leaf) the JAX kernels run in
interpret mode (`FORCE_INTERPRET`): in the direct tests of the two custom
VJPs, op by op. The model-level steps run 48 rows, where the w4x8 kernel
is K6, the dequantized product that JAX computes outside interpret mode
too: under jax.jit the interpreted w4x8 kernels gave a different loss from
run to run here.
Tolerances: losses and gradients within 1e-5 of the reference's largest
magnitude (f32 sums in another order); parameters after AdamW steps within
1e-5 of their largest magnitude, but for the few elements (at most one in
a hundred) whose gradient is near the f32 noise of the sums: AdamW divides
each gradient element by its own running size, so there the two packages'
updates may differ by a part of the step, within 0.1 lr a step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.models import lora as jlora
from llamago_tpu.models import training as jtraining
from llamago_tpu.ops import attention as jattention
from llamago_tpu.ops import basic as jbasic
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu_torch.checkpoint import params
from llamago_tpu_torch.config import MODEL_PRESETS
from llamago_tpu_torch.models import llama, lora, training
from llamago_tpu_torch.ops import attention, basic, kernels, quant

from conftest import random_ggjt_tensors
from test_torch_speculative import KINDS as SPEC_KINDS
from test_torch_speculative import _int4_exec, _model

torch.set_num_threads(1)

TOL = 1e-5
KINDS = ("dense", "q8_0", "q4_0", "w4x8")
KINDS_EXEC = {k: SPEC_KINDS[k][1] for k in KINDS}


def _rel(got, want) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_adam_close(got, want, lr, steps):
    """The parameter tolerance of the module docstring."""
    got = got.detach().cpu().numpy()
    d = np.abs(got - np.asarray(want))
    tight = 1e-5 * np.abs(want).max()
    assert (d > tight).sum() <= max(1, d.size // 100), (d.max(), (d > tight).sum())
    assert d.max() <= max(tight, 0.1 * lr * steps), d.max()


def _tokens(seed, b, t, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _to_port(tree):
    return params.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _b_values(wrapped, seed):
    """A subtree of random B (numpy) for every adapter of a wrapped JAX
    tree: B = 0 would leave A without a gradient."""
    rng = np.random.default_rng(seed)
    sub = jlora.extract_lora(wrapped, ("lora_b",))
    return jax.tree.map(lambda b: (rng.standard_normal(b.shape) * 0.1).astype(np.float32), sub)


def _wrapped(kind, seed=0):
    """The kind's model wrapped with adapters (B random) in both packages:
    (JAX config, JAX tree, port config, port tree)."""
    jcfg, jp, cfg, _ = _model(kind)
    jw = jlora.init_lora(jp, rank=4, alpha=8.0, seed=seed)
    bs = _b_values(jw, seed + 1)
    jw = jlora.apply_lora_state(jw, bs)
    tw = lora.apply_lora_state(lora.init_lora(_to_port(jp), rank=4, alpha=8.0, seed=seed), bs)
    return jcfg, jw, cfg, tw


@functools.cache
def _jax_lora_grads(kind, t):
    """JAX's loss and its gradient over every adapter's A and B."""
    jcfg, jw, _, _ = _wrapped(kind)
    tokens = jnp.asarray(_tokens(5, 2, t))
    tr = jlora.extract_lora(jw, jlora.TRAINABLE_KEYS)
    with _int4_exec(KINDS_EXEC[kind]):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda tr: jtraining.loss_fn(jlora.apply_lora_state(jw, tr), tokens, jcfg)))(tr)
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_lora_grads(kind, t, remat=True):
    _, _, cfg, tw = _wrapped(kind)
    ts = lora.adapter_tensors(tw)
    for x in ts:
        x.requires_grad_(True)
    with _int4_exec(KINDS_EXEC[kind]):
        loss = training.loss_fn(tw, torch.from_numpy(_tokens(5, 2, t)), cfg, remat=remat)
    grads = torch.autograd.grad(loss, ts)
    return loss, grads


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("t", [24, 40])
def test_lora_loss_and_grads_match_jax(kind, t):
    """loss_fn and its gradient over A and B for each base: t = 24 takes K2
    (its Function) in the port, t = 40 the einsum math."""
    want_loss, want = _jax_lora_grads(kind, t)
    loss, grads = _port_lora_grads(kind, t)
    assert abs(loss.item() - want_loss) <= TOL * abs(want_loss)
    flat = jax.tree.leaves(want)
    assert len(flat) == len(grads) == 2 * 2 * 2  # 2 layers x (wqkv, wo) x (A, B)
    for g, w in zip(grads, flat):
        assert _rel(g, w) <= TOL
    assert float(grads[0].abs().max()) > 0  # layer 0's A on wqkv


@functools.cache
def _jax_full_grads():
    jcfg, jp, _, _ = _model("dense")
    tokens = jnp.asarray(_tokens(6, 2, 24))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtraining.loss_fn(p, tokens, jcfg)))(jp)
    return float(loss), jax.tree.map(np.asarray, grads)


def test_full_loss_and_grads_match_jax():
    """Full-weight gradients of a dense model: every leaf."""
    want_loss, want = _jax_full_grads()
    _, _, cfg, tp = _model("dense")
    tp = _to_port(jax.tree.map(np.asarray, _model("dense")[1]))
    ts = training.trainable(tp)
    for x in ts:
        x.requires_grad_(True)
    loss = training.loss_fn(tp, torch.from_numpy(_tokens(6, 2, 24)), cfg)
    grads = torch.autograd.grad(loss, ts)
    assert abs(loss.item() - want_loss) <= TOL * abs(want_loss)
    flat = jax.tree.leaves(want)
    assert len(flat) == len(grads)
    for g, w in zip(grads, flat):
        assert g.shape == w.shape and _rel(g, w) <= TOL


@pytest.mark.parametrize("kind", ["q8_0", "w4x8"])
def test_remat_on_and_off_give_equal_gradients(kind):
    loss_r, g_r = _port_lora_grads(kind, 24, remat=True)
    loss_n, g_n = _port_lora_grads(kind, 24, remat=False)
    assert torch.equal(loss_r, loss_n)
    for a, b in zip(g_r, g_n):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


# ------------------------------------------------- the Functions, directly


def _leaf(kind, k, n, seed):
    """A quantized leaf from the port's quantizers (bit for bit the JAX
    package's) and the same leaf as JAX arrays."""
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32))
    leaf = quant.quantize_w4x8(w) if kind == "q4x" else quant.quantize(w, 8 if kind == "q8" else 4)
    return leaf, {key: jnp.asarray(v.view(torch.int16).numpy().view(jnp.bfloat16)
                                   if v.dtype == torch.bfloat16 else v.numpy())
                  for key, v in leaf.items()}


@pytest.mark.parametrize("kind", ["q8", "q4", "q4x"])
@pytest.mark.parametrize("m", [8, 40])
def test_frozen_quant_matmul_vjp_matches_jax(kind, m):
    """FrozenQuantMatmul's forward and dx against jax.vjp of JAX's
    dequant_matmul in interpret mode (w4x8: K5 at 8 rows, K6 at 40)."""
    w, jw = _leaf(kind, 256, 128, 11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    g = rng.standard_normal((m, 128)).astype(np.float32)
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    try:
        assert jkernels.can_fuse(jnp.asarray(x), jw)
        want, vjp = jax.vjp(lambda x_: jkernels.dequant_matmul(x_, jw), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(g))
    finally:
        jkernels.FORCE_INTERPRET = old
    xt = torch.from_numpy(x).requires_grad_(True)
    out = kernels.FrozenQuantMatmul.apply(xt, w)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert _rel(out, want) <= TOL and _rel(dx, want_dx) <= TOL
    assert all(not v.requires_grad for v in w.values())


def _attn_inputs(t, seed):
    b, h, kv, hd, s = 2, 4, 2, 64, 64
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    pos = (np.array([[s - t], [s // 2 - t // 2]]) + np.arange(t)[None, :]).astype(np.int32)
    g = rng.standard_normal((b, t, h * hd)).astype(np.float32)
    return q, k, v, pos, g


@pytest.mark.parametrize("t", [8, 48])
def test_flash_attention_vjp_matches_jax(t):
    """FlashAttention's forward (K2's plain version at t = 8, K7's at 48)
    and its dq, dk, dv against jax.vjp of JAX's flash_attention (the
    kernels in interpret mode, the VJP of attention_math)."""
    q, k, v, pos, g = _attn_inputs(t, 13 + t)
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    try:
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        assert jattention.can_fuse_attention(jq, jk)
        want, vjp = jax.vjp(lambda a, b, c: jattention.flash_attention(a, b, c, jnp.asarray(pos)),
                            jq, jk, jv)
        wants = vjp(jnp.asarray(g))
    finally:
        jkernels.FORCE_INTERPRET = old
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention.flash_attention(*ins, torch.from_numpy(pos))
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g))
    assert _rel(out, want) <= TOL
    for got, w in zip(grads, wants):
        assert _rel(got, w) <= TOL


def test_linear_on_a_quantized_leaf_takes_the_function_under_grad():
    """The card path is the one tested here: under grad a quantized leaf's
    matmul (and a LoRA leaf's quantized base) goes through
    FrozenQuantMatmul; without grad, or for an x that needs none, it does
    not."""
    w, _ = _leaf("q8", 64, 32, 14)
    x = torch.randn(3, 64, requires_grad=True)
    assert type(basic.linear(x, w).grad_fn).__name__ == "FrozenQuantMatmulBackward"
    assert basic.linear(x.detach(), w).grad_fn is None
    with torch.no_grad():
        assert basic.linear(x, w).grad_fn is None
    a = torch.randn(64, 4, requires_grad=True)
    leaf = {"base": w, "lora_a": a, "lora_b": torch.randn(4, 32, requires_grad=True),
            "lora_scale": torch.tensor(2.0)}
    out = basic.linear(x, leaf)
    names = set()
    stack = [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and type(fn).__name__ not in names:
            names.add(type(fn).__name__)
            stack += [f for f, _ in fn.next_functions]
    assert "FrozenQuantMatmulBackward" in names


def test_fused_norm_refuses_grad_as_jax_does(monkeypatch):
    """K10 has no VJP in the JAX package: jax.grad through it fails there
    (interpret mode), and the port raises where grad is enabled and x
    requires it, never dropping the gradient; without grad it runs."""
    x = np.random.default_rng(15).standard_normal((4, 128)).astype(np.float32)
    w = np.ones(128, np.float32)
    monkeypatch.setattr(jkernels, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jkernels, "USE_FUSED_NORM", True)
    assert jkernels.can_fuse_norm(jnp.asarray(x))
    with pytest.raises(ValueError):
        jax.grad(lambda a: jbasic.rms_norm(a, jnp.asarray(w)).sum())(jnp.asarray(x))
    monkeypatch.setattr(kernels, "USE_FUSED_NORM", True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="USE_FUSED_NORM"):
        basic.rms_norm(xt, torch.from_numpy(w))
    out = basic.rms_norm(xt.detach(), torch.from_numpy(w))
    assert out.shape == (4, 128)


# ------------------------------------------------------ optimizer steps


def _tiny():
    jcfg = JPRESETS["tiny"].replace(dtype="float32", weight_dtype="float32", max_seq_len=32)
    jp = jparams.load_parameters(jcfg, random_ggjt_tensors(jcfg, seed=16))
    return jcfg, jp, MODEL_PRESETS["tiny"].replace(dtype="float32", weight_dtype="float32",
                                                   max_seq_len=32)


@functools.cache
def _jax_train_steps(n=3):
    jcfg, jp, _ = _tiny()
    p = jax.tree.map(jnp.array, jp)
    opt = jtraining.make_optimizer().init(p)
    losses = []
    for i in range(n):
        p, opt, loss = jtraining.train_step(p, opt, jnp.asarray(_tokens(20 + i, 2, 16)), jcfg)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


def test_three_train_steps_match_jax():
    """Full-weight AdamW (optax.adamw's defaults) over the stacked tiny
    model: the loss of each step and every parameter after three."""
    want_losses, want = _jax_train_steps()
    jcfg, jp, cfg = _tiny()
    tp = _to_port(jp)
    opt = training.make_optimizer(tp)
    assert opt.defaults["weight_decay"] == 1e-4 and opt.defaults["eps"] == 1e-8
    for i, wl in enumerate(want_losses):
        tp, opt, loss = training.train_step(tp, opt, torch.from_numpy(_tokens(20 + i, 2, 16)),
                                            cfg)
        assert abs(float(loss) - wl) <= TOL * abs(wl)
    flat_want, flat_got = jax.tree.leaves(want), training.trainable(tp)
    assert len(flat_want) == len(flat_got)
    for g, w in zip(flat_got, flat_want):
        _assert_adam_close(g, w, 1e-4, len(want_losses))


@functools.cache
def _jax_lora_steps(kind, n=3):
    jcfg, jp, _, _ = _model(kind)
    jw = jlora.init_lora(jp, rank=4, alpha=8.0, seed=3)
    jw = jax.tree.map(jnp.array, jlora.apply_lora_state(jw, _b_values(jw, 4)))
    opt = jlora.init_lora_opt_state(jw)
    losses = []
    with _int4_exec(KINDS_EXEC[kind]):
        for i in range(n):
            jw, opt, loss = jlora.lora_train_step(jw, opt, jnp.asarray(_tokens(30 + i, 2, 24)),
                                                  jcfg)
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jlora.extract_lora(jw, jlora.TRAINABLE_KEYS))


def _frozen(tree) -> list[torch.Tensor]:
    """Every tensor of a tree but the adapters', a LoRA leaf by its base."""
    if lora.is_lora(tree):
        return _frozen(tree["base"])
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _frozen(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _frozen(v)]
    return [tree]


@pytest.mark.parametrize("kind", ["dense", "q8_0", "w4x8"])
def test_three_lora_train_steps_match_jax(kind):
    """Adapter-only AdamW: A bit for bit at init, each step's loss, A and B
    after three steps, and the base bit-identical after training."""
    want_losses, want = _jax_lora_steps(kind)
    jcfg, jp, cfg, _ = _model(kind)
    tw = lora.init_lora(_to_port(jp), rank=4, alpha=8.0, seed=3)
    want_a = jax.tree.leaves(jlora.extract_lora(jlora.init_lora(jp, rank=4, alpha=8.0, seed=3),
                                                ("lora_a",)))
    got_a = [a for a in lora.adapter_tensors(tw) if a.shape[-1] == 4]
    assert len(got_a) == len(want_a) == 4
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got_a, want_a))
    tw = lora.apply_lora_state(tw, _b_values(jlora.init_lora(jp, rank=4, alpha=8.0, seed=3), 4))
    base = [t.clone() for t in _frozen(tw)]
    opt = lora.init_lora_opt_state(tw)
    with _int4_exec(KINDS_EXEC[kind]):
        for i, wl in enumerate(want_losses):
            tw, opt, loss = lora.lora_train_step(tw, opt, torch.from_numpy(_tokens(30 + i, 2, 24)),
                                                 cfg)
            assert abs(float(loss) - wl) <= TOL * abs(wl)
    for g, w in zip(lora.adapter_tensors(tw), jax.tree.leaves(want)):
        _assert_adam_close(g, w, 1e-3, len(want_losses))
    after = _frozen(tw)
    assert len(after) == len(base) and all(torch.equal(a, b) for a, b in zip(after, base))


def test_train_state_resume_equals_an_uninterrupted_run(tmp_path):
    """Two steps, save, restore into a fresh tree and optimizer, one more
    step: bit for bit the parameters of three uninterrupted steps."""
    jcfg, jp, cfg = _tiny()
    toks = [torch.from_numpy(_tokens(40 + i, 2, 16)) for i in range(3)]

    straight = _to_port(jp)
    opt = training.make_optimizer(straight)
    for x in toks:
        straight, opt, _ = training.train_step(straight, opt, x, cfg)

    first = _to_port(jp)
    opt = training.make_optimizer(first)
    for x in toks[:2]:
        first, opt, _ = training.train_step(first, opt, x, cfg)
    path = str(tmp_path / "state.pt")
    training.save_train_state(path, first, opt, 2)
    fresh = _to_port(jp)
    opt2 = training.make_optimizer(fresh, lr=5e-3)
    fresh, opt2, step = training.load_train_state(path, fresh, opt2)
    assert step == 2 and opt2.param_groups[0]["lr"] == 1e-4
    fresh, opt2, _ = training.train_step(fresh, opt2, toks[2], cfg)
    for a, b in zip(training.trainable(fresh), training.trainable(straight)):
        assert torch.equal(a, b)


def test_forward_writes_the_cache_in_place_unless_autograd_tracks_it():
    """Serving keeps the in-place cache write; under grad the new rows go
    into copies that the cache then holds."""
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    _, _, cfg, tw = _wrapped("dense")
    toks = torch.from_numpy(_tokens(50, 1, 8))
    cache = KVCache.create(cfg, batch=1, max_seq=16, device="cpu")
    k0 = cache.k[0]
    llama.forward_impl(tw, toks, cache, torch.zeros(1, dtype=torch.long), cfg)
    assert cache.k[0] is k0 and k0[:, :, :8].abs().sum() > 0
    for a in lora.adapter_tensors(tw):
        a.requires_grad_(True)
    cache = KVCache.create(cfg, batch=1, max_seq=16, device="cpu")
    k0 = cache.k[0]
    llama.forward_impl(tw, toks, cache, torch.zeros(1, dtype=torch.long), cfg)
    assert cache.k[0] is not k0 and k0.abs().sum() == 0
    assert cache.k[0].requires_grad and cache.k[0][:, :, :8].abs().sum() > 0
