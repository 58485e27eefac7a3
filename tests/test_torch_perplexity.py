"""Port parity: the perplexity harness (eval/perplexity.py) and the
`perplexity` subcommand against the JAX package on the CPU.

The models are those of tests/test_torch_speculative.py (dense f32, Q8_0,
Q4_0, w4x8 and the int8 KV cache, loaded by the JAX package and carried
across), f32 compute in both packages. Per-position NLL must agree within
1e-5 (f32 sums in another order); the perplexity dicts within the same
relative tolerance, their counts exactly.
"""

import numpy as np
import pytest
import torch

from llamago_tpu import cli as jcli
from llamago_tpu.eval.perplexity import _window_nll as j_window_nll
from llamago_tpu.eval.perplexity import perplexity as jperplexity
from llamago_tpu.eval.perplexity import perplexity_of_text as jperplexity_of_text
from llamago_tpu_torch import cli
from llamago_tpu_torch.eval import perplexity as port_perplexity
from llamago_tpu_torch.checkpoint.ggjt import write_ggjt
from llamago_tpu_torch.checkpoint.quant_file import quantize_ggjt
from llamago_tpu_torch.config import MODEL_PRESETS
from llamago_tpu_torch.eval.perplexity import _window_nll, perplexity, perplexity_of_text
from llamago_tpu_torch.tokenizer import Vocab, tokenize

from conftest import make_test_vocab, random_ggjt_tensors
from test_torch_speculative import KINDS, _jax_kernels, _model

torch.set_num_threads(1)

NLL_TOL = 1e-5


def _ids(seed, n):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


@pytest.mark.parametrize("kind", list(KINDS))
def test_window_nll_matches_jax(kind):
    """A 48-token window: the int8 cache's window is written by the plain
    quantize-and-write and attended by the scale-folded math in both."""
    jcfg, jp, cfg, tp = _model(kind)
    window = _ids(3, 48)[None, :]
    with _jax_kernels(kind):
        want = np.asarray(j_window_nll(jp, window, jcfg))
        got = _window_nll(tp, torch.from_numpy(window), cfg)
    assert got.shape == (47,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NLL_TOL)


def _assert_same(got, want):
    assert got["n_tokens"] == want["n_tokens"] and got["n_windows"] == want["n_windows"]
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=NLL_TOL)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=NLL_TOL)


@pytest.mark.parametrize("ctx,min_context,max_windows", [(32, 4, None), (40, 32, None),
                                                         (16, 0, 2), (70, 80, None)])
def test_perplexity_matches_jax(ctx, min_context, max_windows):
    """Windows of ctx tokens over 100 ids (the tail dropped), min_context
    skipped in each (at least one position kept), a cap on the windows."""
    jcfg, jp, cfg, tp = _model("dense")
    ids = _ids(4, 100)
    want = jperplexity(jp, jcfg, ids, ctx=ctx, min_context=min_context,
                       max_windows=max_windows)
    got = perplexity(tp, cfg, list(ids), ctx=ctx, min_context=min_context,
                     max_windows=max_windows)
    _assert_same(got, want)
    assert got["n_windows"] == (min(100 // ctx, max_windows) if max_windows else 100 // ctx)


def test_perplexity_of_text_matches_jax_and_perplexity():
    jcfg, jp, cfg, tp = _model("q8_0")
    vocab = make_test_vocab()
    text = "hello world, hello again: the world says hello " * 3
    kw = dict(ctx=32, min_context=8)
    want = jperplexity_of_text(jp, jcfg, vocab, text, **kw)
    got = perplexity_of_text(tp, cfg, Vocab(list(vocab.tokens)), text, **kw)
    _assert_same(got, want)
    ids = tokenize(Vocab(list(vocab.tokens)), " " + text, bos=True)
    assert perplexity(tp, cfg, ids, **kw) == got
    assert port_perplexity is perplexity  # eval/__init__.py exports it


def test_too_short_input_raises_like_jax():
    jcfg, jp, cfg, tp = _model("dense")
    ids = _ids(5, 31)
    with pytest.raises(ValueError, match="need at least 32 tokens, got 31") as want:
        jperplexity(jp, jcfg, ids, ctx=32)
    with pytest.raises(ValueError) as got:
        perplexity(tp, cfg, ids, ctx=32)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        perplexity(tp, cfg, _ids(5, 64), ctx=32, max_windows=0)


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def q8_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppl")
    cfg = MODEL_PRESETS["tiny-gqa"]
    f32 = str(d / "tiny-f32.bin")
    write_ggjt(f32, cfg, Vocab(make_test_vocab().tokens), random_ggjt_tensors(cfg, seed=8))
    text = d / "text.txt"
    text.write_text("hello world, the world said hello to the world. " * 12)
    return quantize_ggjt(f32, str(d / "tiny-q8_0.bin"), "q8_0"), str(text)


@pytest.mark.parametrize("context", ["64", "1024"])
def test_perplexity_subcommand_prints_what_the_jax_cli_prints(q8_model, context, capsys):
    """--context 64: windows of 64 tokens; 1024: capped at 512, more than
    the text holds, so both CLIs fail the same way."""
    model, text = q8_model
    argv = ["perplexity", "--model", model, "--file", text, "--context", context, "--silent"]
    if context == "1024":
        with pytest.raises(ValueError, match="need at least 512 tokens") as want:
            jcli.main(argv + ["--tp", "1"])
        with pytest.raises(ValueError) as got:
            cli.main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value)
        return
    assert jcli.main(argv + ["--tp", "1"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("[PPL] perplexity ") and "(ctx 64, int8 weights)" in got


def test_perplexity_subcommand_needs_model_and_file(q8_model, capsys):
    model, _ = q8_model
    assert cli.main(["perplexity", "--model", model, "--silent", "--device", "cpu"]) == 2
    assert "perplexity needs --model and --file" in capsys.readouterr().err
    assert cli.main(["perplexity", "--file", "x.txt", "--silent", "--device", "cpu"]) == 2
