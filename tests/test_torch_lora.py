"""Port parity: LoRA (models/lora.py), `finetune` and `--lora` against the
JAX package on the CPU.

The models are those of tests/test_torch_speculative.py (dim 128, two
layers, fused wqkv/w13; dense f32, Q8_0, Q4_0 and w4x8 bases), loaded by
the JAX package and carried across, f32 compute. A must equal JAX's bit
for bit (the same numpy draws in the same order); a merged quantized base
must equal JAX's byte for byte; logits through adapters carried across
within 1e-5 of max|logit|; the CLI's adapters after AdamW steps within the
tolerance tests/test_torch_training.py states for them, and its greedy
output with `--lora` equal to the JAX CLI's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu import cli as jcli
from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.config import ModelConfig as JModelConfig
from llamago_tpu.models import llama as jllama
from llamago_tpu.models import lora as jlora
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu_torch import cli
from llamago_tpu_torch.checkpoint import params, write_ggjt
from llamago_tpu_torch.checkpoint.quant_file import quantize_ggjt
from llamago_tpu_torch.config import MODEL_PRESETS
from llamago_tpu_torch.models import llama, lora
from llamago_tpu_torch.runtime.kv_cache import KVCache
from llamago_tpu_torch.tokenizer import Vocab

from conftest import make_test_vocab, random_ggjt_tensors
from test_torch_speculative import _config, _int4_exec, _model
from test_torch_training import KINDS, KINDS_EXEC, _assert_adam_close, _b_values, _to_port

torch.set_num_threads(1)

LOGIT_TOL = 1e-5


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy, bf16 kept as its bits (uint16)."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _wrap_both(kind, seed=0):
    jcfg, jp, cfg, _ = _model(kind)
    jw = jlora.init_lora(jp, rank=4, alpha=8.0, seed=seed)
    bs = _b_values(jw, seed + 1)
    jw = jlora.apply_lora_state(jw, bs)
    tw = lora.apply_lora_state(lora.init_lora(_to_port(jp), rank=4, alpha=8.0, seed=seed), bs)
    return jcfg, jw, cfg, tw


def _logits(tree, cfg, toks):
    lg, _ = llama.forward_impl(tree, torch.from_numpy(toks), KVCache.create(cfg, batch=2,
                                                                             device="cpu"),
                               torch.zeros(2, dtype=torch.long), cfg, return_all_logits=True)
    return lg.numpy()


def _jlogits(tree, jcfg, toks):
    lg, _ = jllama.forward_impl(tree, jnp.asarray(toks), JKVCache.create(jcfg, batch=2),
                                jnp.zeros(2, jnp.int32), jcfg, return_all_logits=True)
    return np.asarray(lg)


def _toks(seed=60):
    return np.random.default_rng(seed).integers(0, 512, (2, 20)).astype(np.int32)


@pytest.mark.parametrize("layout", ["layered", "stacked"])
def test_init_lora_draws_a_as_jax_does(layout):
    """A bit for bit, B zero, the scale alpha / rank with the layer-stack
    lead dims, for fused per-layer params and for stacked ones; the
    wrapped model gives the base's logits exactly at step 0."""
    if layout == "layered":
        jcfg, jp, cfg, tp = _model("q8_0")
    else:
        jcfg = _config(JModelConfig, "float32", "auto")
        jp = jparams.load_parameters(jcfg, random_ggjt_tensors(jcfg, seed=41))
        cfg = _model("dense")[2]
        tp = _to_port(jp)
    jw = jlora.init_lora(jp, rank=4, alpha=8.0, seed=7)
    tw = lora.init_lora(tp, rank=4, alpha=8.0, seed=7)
    want = jax.tree.leaves(jlora.extract_lora(jw))
    got = jax.tree.leaves(lora.extract_lora(tw), is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.array_equal(_np(g), np.asarray(w))
    toks = _toks()
    assert np.array_equal(_logits(tw, cfg, toks), _logits(tp, cfg, toks))


def test_extract_and_apply_lora_state_round_trip():
    """extract_lora's subtree has JAX's structure (a quantized leaf that
    carries no adapter leaves an empty dict, as there); applying it back
    replaces only what it names."""
    _, jw, _, tw = _wrap_both("q8_0")
    ad = lora.extract_lora(tw, lora.TRAINABLE_KEYS)
    jad = jlora.extract_lora(jw, jlora.TRAINABLE_KEYS)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, ad, is_leaf=lambda x: isinstance(
        x, torch.Tensor))) == jax.tree.structure(jax.tree.map(lambda _: 0, jad))
    assert set(ad["layers"][0]["wo"]) == {"lora_a", "lora_b"} and ad["layers"][0]["w2"] == {}
    zero = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), ad,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    back = lora.apply_lora_state(tw, zero)
    assert float(back["layers"][1]["wo"]["lora_b"].abs().sum()) == 0
    assert back["layers"][1]["wo"]["base"] is tw["layers"][1]["wo"]["base"]
    assert back["layers"][1]["wo"]["lora_scale"] is tw["layers"][1]["wo"]["lora_scale"]


@pytest.mark.parametrize("kind", KINDS)
def test_merge_lora_matches_jax(kind):
    """Dense bases merge in f32 back to their dtype; quantized bases are
    requantized at their bit width (a w4x8 base becomes Q4_0), byte for
    byte JAX's; logits of the merged tree equal JAX's merged tree's."""
    jcfg, jw, cfg, tw = _wrap_both(kind)
    with _int4_exec(KINDS_EXEC[kind]):
        jm = jlora.merge_lora(jw)
        tm = lora.merge_lora(tw)
        for jl, tl in zip(jm["layers"], tm["layers"]):
            for key in ("wqkv", "wo"):
                if isinstance(jl[key], dict):
                    assert sorted(jl[key]) == sorted(tl[key])
                    assert ("q4" in tl[key]) == (kind in ("q4_0", "w4x8"))
                    for sub in jl[key]:
                        assert np.array_equal(_np(tl[key][sub]), _jnp_bits(jl[key][sub])), sub
                else:
                    np.testing.assert_allclose(_np(tl[key]), np.asarray(jl[key]),
                                               rtol=0, atol=1e-7)
        toks = _toks(61)
        want = _jlogits(jm, jcfg, toks)
        got = _logits(tm, cfg, toks)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


@pytest.mark.parametrize("kind", ["dense", "q4_0"])
def test_adapters_cross_between_packages(kind, tmp_path):
    """Adapters saved by either package load in the other (the same .npz
    keys) and give the same logits as the saving package's tree."""
    jcfg, jw, cfg, tw = _wrap_both(kind)
    _, jp, _, _ = _model(kind)
    toks = _toks(62)
    with _int4_exec(KINDS_EXEC[kind]):
        want = _jlogits(jw, jcfg, toks)
        jpath = str(tmp_path / "jax.npz")
        jlora.save_lora(jpath, jw)
        attached = lora.attach_lora(_to_port(jp), lora.load_lora(jpath))
        got = _logits(attached, cfg, toks)
        assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()

        tpath = str(tmp_path / "port.npz")
        lora.save_lora(tpath, tw)
        with np.load(jpath) as a, np.load(tpath) as b:
            assert sorted(a.files) == sorted(b.files) and "layers/0/wqkv/lora_a" in a.files
            assert all(np.array_equal(a[k], b[k]) for k in a.files)
        jback = jlora.attach_lora(jp, jlora.load_lora(tpath))
        assert np.abs(_jlogits(jback, jcfg, toks) - _logits(tw, cfg, toks)).max() \
            <= LOGIT_TOL * np.abs(want).max()


def test_attach_lora_normalizes_stacked_adapters_and_raises_on_a_mismatch(tmp_path):
    """Adapters of a stacked tree attach to per-layer params; adapters of
    split wq/wk/wv projections against fused wqkv params raise."""
    jcfg = _config(JModelConfig, "float32", "auto")
    stacked = jparams.load_parameters(jcfg, random_ggjt_tensors(jcfg, seed=41))
    js = jlora.init_lora(stacked, rank=4, alpha=8.0, targets=("wo",), seed=2)
    path = str(tmp_path / "stacked.npz")
    jlora.save_lora(path, js)
    _, _, cfg, tp = _model("dense")
    fused = lora.attach_lora(tp, lora.load_lora(path))
    assert [lora.is_lora(lp["wo"]) for lp in fused["layers"]] == [True, True]
    assert np.array_equal(fused["layers"][1]["wo"]["lora_a"].numpy(),
                          np.asarray(js["layers"]["wo"]["lora_a"][1]))
    split = jlora.init_lora(stacked, rank=4, alpha=8.0, seed=2)  # wq, wk, wv, wo
    jlora.save_lora(path, split)
    with pytest.raises(ValueError, match="adapters attached"):
        lora.attach_lora(tp, lora.load_lora(path))


@pytest.fixture(scope="module")
def q8_model_and_text(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora_cli")
    cfg = MODEL_PRESETS["tiny-gqa"]
    f32 = str(d / "tiny-f32.bin")
    write_ggjt(f32, cfg, Vocab(make_test_vocab().tokens), random_ggjt_tensors(cfg, seed=6))
    text = str(d / "train.txt")
    with open(text, "w") as f:
        f.write("hello world, the world says hello again and again.\n" * 12)
    return quantize_ggjt(f32, str(d / "tiny-q8_0.bin"), "q8_0"), text, d


def test_finetune_then_lora_match_the_jax_cli(q8_model_and_text, capsys):
    """`finetune` with --device cpu against the JAX CLI's on the same file
    and draws (its lora_train_step): the same [FINETUNE] report shape and
    adapters within the AdamW tolerance; then `--lora` greedy output from
    the port's adapters equal to the JAX CLI's with the same file."""
    model, text, d = q8_model_and_text
    common = ["finetune", "--model", model, "--file", text, "--steps", "3", "--seq", "32",
              "--context", "64", "--train-batch", "2", "--rank", "4", "--silent"]
    jout, tout = str(d / "jax.npz"), str(d / "port.npz")
    assert jcli.main(common + ["--out", jout, "--tp", "1"]) == 0
    want = capsys.readouterr().out
    assert cli.main(common + ["--out", tout, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.startswith("[FINETUNE] 3 steps, final loss ") and "--lora " + tout in got
    assert want.split(", final loss ")[1][:6] == got.split(", final loss ")[1][:6]
    with np.load(jout) as a, np.load(tout) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "layers/1/wqkv/lora_b" in a.files
        for k in a.files:
            _assert_adam_close(torch.from_numpy(b[k]), a[k], 1e-3, 3)
            if k.endswith("lora_b"):
                assert np.abs(b[k]).max() > 0

    gen = ["--model", model, "--lora", tout, "--prompt", "hello world", "--temp", "0",
           "--predict", "12", "--context", "64", "--silent"]
    assert jcli.main(gen + ["--tp", "1"]) == 0
    want = capsys.readouterr().out
    assert cli.main(gen + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello world")
