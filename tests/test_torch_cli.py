"""Port parity and guards: the CLI (cli.py), the ggjt reader, and the
rules the port keeps (no JAX imports, CUDA unless the CPU is asked for,
unported flags fail by name).

The CLI test builds a tiny Q8_0 ggjt with the JAX package's writer and
quantizer; `--temp 0 --device cpu` one-shot output must equal the JAX
CLI's output.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from llamago_tpu import cli as jcli
from llamago_tpu.checkpoint import write_ggjt
from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.checkpoint.ggjt import read_ggjt as jread_ggjt
from llamago_tpu.checkpoint.quant_file import quantize_ggjt
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu_torch import cli
from llamago_tpu_torch.checkpoint import params
from llamago_tpu_torch.checkpoint.ggjt import read_ggjt
from llamago_tpu_torch.config import MODEL_PRESETS
from llamago_tpu_torch.runtime.engine import Engine
from llamago_tpu_torch.tokenizer import Vocab

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parent.parent / "llamago_tpu_torch"


@pytest.fixture(scope="module")
def q8_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("q8")
    cfg = JPRESETS["tiny-gqa"]
    f32 = str(d / "tiny-f32.bin")
    write_ggjt(f32, cfg, make_test_vocab(), random_ggjt_tensors(cfg, seed=6))
    return quantize_ggjt(f32, str(d / "tiny-q8_0.bin"), "q8_0")


def test_oneshot_greedy_output_matches_jax_cli(q8_model, capsys):
    argv = ["--model", q8_model, "--prompt", "hello world", "--temp", "0",
            "--predict", "12", "--context", "64", "--silent"]
    assert jcli.main(argv + ["--tp", "1"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello world")


def test_read_ggjt_and_host_parameters_match_jax(q8_model):
    ck, jck = read_ggjt(q8_model), jread_ggjt(q8_model)
    assert ck.ftype == jck.ftype == 7 and ck.config.weight_dtype == "int8"
    assert ck.config.n_kv_heads == jck.config.n_kv_heads == 2
    assert ck.vocab.tokens == jck.vocab.tokens
    host = params.host_parameters(ck.config, ck.tensors)
    jhost = jparams.host_parameters(jck.config, jck.tensors)
    flat, jflat = jax.tree.leaves(host), jax.tree.leaves(jhost)
    assert len(flat) == len(jflat)
    for a, b in zip(flat, jflat):
        assert a.dtype == b.dtype  # f32 file scales stay f32
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def f32_and_q4_models(tmp_path_factory):
    d = tmp_path_factory.mktemp("q4")
    cfg = JPRESETS["tiny-gqa"]
    f32 = str(d / "tiny-f32.bin")
    write_ggjt(f32, cfg, make_test_vocab(), random_ggjt_tensors(cfg, seed=7))
    return {"f32": f32, "q4_0": quantize_ggjt(f32, str(d / "tiny-q4_0.bin"), "q4_0"),
            "q4_1": quantize_ggjt(f32, str(d / "tiny-q4_1.bin"), "q4_1")}


@pytest.mark.parametrize("model,flags", [("f32", ["--weight-dtype", "int4"]),
                                         ("q4_0", []), ("q4_1", [])])
def test_oneshot_int4_greedy_output_matches_jax_cli(f32_and_q4_models, model, flags,
                                                    capsys, monkeypatch):
    """`--weight-dtype int4` on a dense file, and Q4_0 / Q4_1 files, in the
    file's own format on both sides (the CPU default of both packages)."""
    monkeypatch.setenv("LLAMAGO_INT4_EXEC", "q4_0")
    argv = ["--model", f32_and_q4_models[model], "--prompt", "hello world", "--temp", "0",
            "--predict", "12", "--context", "64", "--silent"] + flags
    assert jcli.main(argv + ["--tp", "1"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello world")
    assert len(got.strip()) > len("hello world")


def test_int4_needs_cuda_unless_cpu_is_asked(monkeypatch, f32_and_q4_models):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--model", f32_and_q4_models["q4_0"], "--prompt", "x", "--silent"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params.random_quantized_parameters(MODEL_PRESETS["tiny"].replace(weight_dtype="int4"))


def test_oneshot_int8_kv_cache_runs(q8_model, capsys):
    argv = ["--model", q8_model, "--prompt", "hello world", "--temp", "0",
            "--predict", "8", "--context", "64", "--silent", "--kv-dtype", "int8",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert out.startswith("hello world") and len(out.strip()) > len("hello world")


@pytest.mark.parametrize("flags,slice_name", [
    (["--sp", "2"], "parallel"),
    (["--spec"], "speculative"),
    (["--tp", "2"], "parallel"),
    (["--dp", "2"], "parallel"),
    (["--multihost"], "parallel"),
    (["--lora", "a.npz"], "training"),
    (["perplexity"], "eval"),
    (["convert"], "checkpoint tools"),
])
def test_unported_flags_fail_naming_the_slice(flags, slice_name, capsys):
    assert cli.main(["--model", "m.bin", "--silent", "--device", "cpu"] + flags) == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and slice_name in err


def test_gguf_file_is_not_yet_ported(tmp_path, capsys):
    path = tmp_path / "m.gguf"
    path.write_bytes(b"GGUF" + bytes(60))
    assert cli.main(["--model", str(path), "--prompt", "x", "--silent",
                     "--device", "cpu"]) == 2
    assert "GGUF" in capsys.readouterr().err


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, q8_model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MODEL_PRESETS["tiny"].replace(weight_dtype="int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params.random_quantized_parameters(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params.params_from_numpy({"norm": np.ones(4, np.float32)})
    tp = params.random_quantized_parameters(cfg, device="cpu")
    vocab = Vocab([(b"a", 0.0)] * cfg.vocab_size)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, tp, vocab)
    assert Engine(cfg, tp, vocab, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--model", q8_model, "--prompt", "x", "--silent"])


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    smoke = PKG.parent / "chip_smoke.py"
    assert smoke.exists()
    for path in sorted(PKG.rglob("*.py")) + [smoke]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "llamago_tpu"):
                    bad.append(f"{path.relative_to(PKG.parent)}: {name}")
    assert len(list(PKG.rglob("*.py"))) > 15
    assert bad == []
