"""Port parity and guards: the CLI (cli.py), the ggjt reader, and the
rules the port keeps (no JAX imports, CUDA unless the CPU is asked for),
and the --tp / --dp / --sp / --coordinator one-shots on the CPU.

The CLI tests build a tiny Q8_0 ggjt with the port's writer and
quantizer; `--temp 0 --device cpu` one-shot output, with and without
`--spec`, must equal the JAX CLI's output on the same file.
"""

import ast
import filecmp
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from llamago_tpu import cli as jcli
from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.checkpoint.ggjt import read_ggjt as jread_ggjt
from llamago_tpu_torch import cli
from llamago_tpu_torch.checkpoint import params, write_ggjt
from llamago_tpu_torch.checkpoint.ggjt import read_ggjt, write_meta_sidecar
from llamago_tpu_torch.checkpoint.quant_file import quantize_ggjt
from llamago_tpu_torch.config import MODEL_PRESETS
from llamago_tpu_torch.runtime.engine import Engine
from llamago_tpu_torch.tokenizer import Vocab

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parent.parent / "llamago_tpu_torch"


@pytest.fixture(scope="module")
def q8_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("q8")
    cfg = MODEL_PRESETS["tiny-gqa"]
    f32 = str(d / "tiny-f32.bin")
    write_ggjt(f32, cfg, Vocab(make_test_vocab().tokens), random_ggjt_tensors(cfg, seed=6))
    return quantize_ggjt(f32, str(d / "tiny-q8_0.bin"), "q8_0")


def test_oneshot_greedy_output_matches_jax_cli(q8_model, capsys):
    argv = ["--model", q8_model, "--prompt", "hello world", "--temp", "0",
            "--predict", "12", "--context", "64", "--silent"]
    assert jcli.main(argv + ["--tp", "1"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello world")


@pytest.mark.parametrize("chunk", ["1", "4"])
def test_oneshot_spec_output_matches_jax_cli_and_plain(q8_model, chunk, capsys):
    """`--spec --temp 0` one-shot: the output equals the JAX CLI's with the
    same flags and the port's without --spec (speculation is lossless)."""
    argv = ["--model", q8_model, "--prompt", "hello hello hello", "--temp", "0",
            "--predict", "24", "--context", "64", "--silent", "--chunk", chunk, "--draft", "4"]
    assert jcli.main(argv + ["--spec", "--tp", "1"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--spec", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello hello hello")
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == got


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
    cfg = MODEL_PRESETS["tiny-gqa"]
    f32 = str(d / "tiny-f32.bin")
    write_ggjt(f32, cfg, Vocab(make_test_vocab().tokens), random_ggjt_tensors(cfg, seed=7))
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


def _ranked_cli(argv: list[str], nprocs: int = 1, timeout: float = 120,
                torchrun: bool = False, stdin: str = "") -> list[tuple]:
    """Run `python -m llamago_tpu_torch.cli argv` (with nprocs > 1 as ranks
    0..nprocs-1 of one world on a free port: --coordinator, or with
    `torchrun` --multihost and the environment torchrun sets); `stdin` goes
    to rank 0. The (returncode, stdout, stderr) of each process."""
    import os
    import socket
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(PKG.parent), OMP_NUM_THREADS="1")
    cmds = [[sys.executable, "-m", "llamago_tpu_torch.cli", *argv]]
    envs = [env]
    if nprocs > 1:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if torchrun:
            cmds = [cmds[0] + ["--multihost"]] * nprocs
            envs = [dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(i),
                         LOCAL_RANK=str(i), WORLD_SIZE=str(nprocs)) for i in range(nprocs)]
        else:
            cmds = [cmds[0] + ["--coordinator", f"127.0.0.1:{port}", "--nprocs", str(nprocs),
                               "--procid", str(i)] for i in range(nprocs)]
            envs = [env] * nprocs
    procs = [subprocess.Popen(c, env=e, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c, e in zip(cmds, envs)]
    outs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(stdin if i == 0 else "", timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    return outs


@pytest.mark.parametrize("flags,nprocs", [
    (["--tp", "2"], 1),
    (["--dp", "2", "--pods", "2"], 1),
    (["--sp", "2"], 1),
    (["--tp", "2"], 2),  # --coordinator 127.0.0.1:P --nprocs 2 --procid 0 / 1
])
def test_parallel_oneshot_output_matches_one_process(q8_model, flags, nprocs, capsys):
    """--tp / --dp / --sp one-shots on --device cpu (the CLI spawns the
    ranks, or two processes join one --coordinator world): rank 0 prints the
    one-process output exactly, the other ranks print nothing, and every
    rank logs its launch counts."""
    argv = ["--model", q8_model, "--prompt", "hello world", "--temp", "0",
            "--predict", "12", "--context", "64", "--silent", "--device", "cpu"]
    assert cli.main(argv + ["--tp", "1"]) == 0
    want = capsys.readouterr().out
    runs = _ranked_cli(argv + flags, nprocs)
    for code, _, err in runs:
        assert code == 0, err[-3000:]
    assert runs[0][1] == want and want.startswith("hello world")
    assert all(out == "" for _, out, _ in runs[1:])
    ranks = sorted(json.loads(line)["rank"] for _, _, err in runs
                   for line in err.splitlines() if line.startswith('{"rank"'))
    assert ranks == [0, 1]


def test_multihost_reads_the_torchrun_environment(q8_model, capsys):
    """--multihost alone: the world from MASTER_ADDR / MASTER_PORT / RANK /
    WORLD_SIZE, --tp 0 taking world // (dp * sp) = 2."""
    argv = ["--model", q8_model, "--prompt", "hello world", "--temp", "0",
            "--predict", "12", "--context", "64", "--silent", "--device", "cpu"]
    assert cli.main(argv + ["--tp", "1"]) == 0
    want = capsys.readouterr().out
    runs = _ranked_cli(argv, 2, torchrun=True)
    for code, _, err in runs:
        assert code == 0, err[-3000:]
    assert runs[0][1] == want and runs[1][1] == ""
    assert "[mesh] tp=2 dp=1 sp=1" in runs[0][2]


def test_chat_under_tp_matches_one_process(q8_model):
    """--chat over two --coordinator ranks: rank 0 reads the turns and
    prints what one process prints; rank 1 follows the broadcast and ends
    with it."""
    argv = ["--model", q8_model, "--chat", "--temp", "0", "--predict", "8", "--context", "64",
            "--silent", "--device", "cpu"]
    turns = "hello\nworld\n\n"
    (code, want, err), = _ranked_cli(argv, 1, stdin=turns)
    assert code == 0, err[-3000:]
    runs = _ranked_cli(argv + ["--tp", "2"], 2, stdin=turns)
    for code, _, err in runs:
        assert code == 0, err[-3000:]
    assert runs[0][1] == want and want.count("model> ") == 2
    assert runs[1][1] == ""


def _one_process_finetune(model, text, steps, seq, batch, rank, lr):
    """What `finetune` computes, in this process on the unfused model (the
    layout the ranks train): the adapters after `steps` LoRA steps on the
    CLI's batches."""
    from llamago_tpu_torch.checkpoint.gguf import read_checkpoint
    from llamago_tpu_torch.models import lora
    from llamago_tpu_torch.tokenizer import tokenize

    ckpt = read_checkpoint(model, max_seq_len=64)
    cfg = ckpt.config.replace(dtype="float32", max_seq_len=64)
    p = params.unstack_layer_params(params.load_parameters(cfg, ckpt.tensors, device="cpu"),
                                    cfg.n_layers)
    with open(text, encoding="utf-8") as f:
        ids = np.asarray(tokenize(ckpt.vocab, " " + f.read(), bos=True), np.int32)
    blocks = ids[: len(ids) // seq * seq].reshape(-1, seq)
    p = lora.init_lora(p, rank=rank, alpha=16.0)
    opt = lora.init_lora_opt_state(p, lr=lr)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        take = rng.integers(0, len(blocks), size=batch)
        p, opt, _ = lora.lora_train_step(p, opt, torch.from_numpy(blocks[take]), cfg, lr=lr)
    return {k: v.detach().numpy() for k, v in _flat_lora(lora.extract_lora(p)).items()}


def _flat_lora(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_lora(v, f"{prefix}/{k}" if prefix else k).items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat_lora(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_finetune_lora_and_perplexity_run_under_tp(q8_model, tmp_path, capsys):
    """`finetune --tp 2` on two spawned CPU ranks: rank 0 reports and writes
    whole adapters in the JAX layout, within 1e-6 of one process's training
    on the same draws, which the JAX package's load_lora reads and attaches
    to its meshed (unfused) tree; `--lora` of them at --tp 2 greedy-decodes
    one process's tokens; `perplexity --tp 2` prints one process's line."""
    from llamago_tpu.models import lora as jlora

    text = tmp_path / "train.txt"
    text.write_text("hello world, the world says hello again and again.\n" * 12)
    out = str(tmp_path / "tp.npz")
    tune = ["finetune", "--model", q8_model, "--file", str(text), "--steps", "3", "--seq",
            "32", "--context", "64", "--train-batch", "2", "--rank", "4", "--silent",
            "--device", "cpu", "--out", out, "--tp", "2"]
    (code, stdout, err), = _ranked_cli(tune, 1, timeout=180)
    assert code == 0, err[-3000:]
    assert stdout.startswith("[FINETUNE] 3 steps, final loss ") and stdout.count("[FINETUNE]") == 2
    assert sorted(json.loads(line)["rank"] for line in err.splitlines()
                  if line.startswith('{"rank"')) == [0, 1]
    want = _one_process_finetune(q8_model, str(text), 3, 32, 2, 4, 1e-3)
    with np.load(out) as z:
        assert sorted(z.files) == sorted(want)
        assert "layers/1/wq/lora_a" in z.files and "layers/1/wo/lora_b" in z.files
        for k in z.files:
            np.testing.assert_allclose(z[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    jtree = jparams.host_parameters(*_jax_file(q8_model))
    # four stacked leaves (wq wk wv wo), each with both layers' adapters
    assert jlora._count_lora(jlora.attach_lora(jtree, jlora.load_lora(out))) == 4

    gen = ["--model", q8_model, "--lora", out, "--prompt", "hello world", "--temp", "0",
           "--predict", "12", "--context", "64", "--silent", "--device", "cpu"]
    assert cli.main(gen) == 0
    one = capsys.readouterr().out
    (code, stdout, err), = _ranked_cli(gen + ["--tp", "2"], 1)
    assert code == 0, err[-3000:]
    assert stdout == one and one.startswith("hello world")

    ppl = ["perplexity", "--model", q8_model, "--file", str(text), "--context", "64",
           "--silent", "--device", "cpu"]
    assert cli.main(ppl) == 0
    one = capsys.readouterr().out
    (code, stdout, err), = _ranked_cli(ppl + ["--tp", "2"], 1)
    assert code == 0, err[-3000:]
    assert stdout == one and one.startswith("[PPL] perplexity ")


def _jax_file(path):
    """(JAX config, file tensors) of a ggjt file, as the JAX package reads it."""
    ck = jread_ggjt(path)
    return ck.config, ck.tensors


def test_more_ranks_than_cards_is_refused(monkeypatch, q8_model, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["--model", q8_model, "--prompt", "x", "--silent", "--tp", "2"]) == 2
    assert "mesh needs 2 devices, have 1" in capsys.readouterr().err


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
    scanned = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {f"parallel/{m}.py" for m in ("mesh", "sharding", "tp_kernels", "multihost")} <= scanned
    assert "dryrun.py" in scanned
    assert bad == []


def test_every_cuda_source_is_built_and_says_what_it_replaces():
    from llamago_tpu_torch.ops import _build

    sources = {p.stem: p.read_text() for p in (PKG / "csrc").glob("*.cu")}
    assert set(_build.SOURCES) == set(sources) and len(sources) >= 9
    for name, text in sources.items():
        low = text.lower()
        # a kernel of the package, or of the JAX package's lab script
        assert "replaces llamago_tpu/" in low or "replaces scripts/kernel_lab.py" in low, name
        assert "bound" in low, name
        assert 'extern "C"' in text and "#include <torch" not in text, name


# ------------------------------------------------- the checkpoint tools


@pytest.mark.parametrize("kind", ["q8_0", "q4_0", "q4_1"])
@pytest.mark.parametrize("ext", [".bin", ".gguf"])
def test_quantize_subcommand_matches_the_jax_cli(tmp_path, kind, ext, capsys):
    """`quantize --qkind K [--out X.gguf]`: both CLIs write the same bytes
    (and sidecar) and report the native path."""
    cfg = MODEL_PRESETS["tiny-gqa"].replace(rope_theta=500000.0)
    f32 = str(tmp_path / "tiny-f32.bin")
    write_ggjt(f32, cfg, Vocab(make_test_vocab().tokens), random_ggjt_tensors(cfg, seed=4))
    write_meta_sidecar(f32, cfg)
    outs = [str(tmp_path / f"{who}-{kind}{ext}") for who in ("j", "p")]
    assert jcli.main(["quantize", "--model", f32, "--out", outs[0], "--qkind", kind,
                      "--silent"]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["quantize", "--model", f32, "--out", outs[1], "--qkind", kind,
                     "--silent"]) == 0
    out = capsys.readouterr().out
    assert filecmp.cmp(*outs, shallow=False)
    if ext == ".bin":
        assert filecmp.cmp(outs[0] + ".meta.json", outs[1] + ".meta.json", shallow=False)
    assert out.startswith(f"[QUANT] wrote {outs[1]} ({kind}, native=True) in ")
    assert jout.split(" in ")[0].replace(outs[0], outs[1]) == out.split(" in ")[0]


def test_quantize_default_output_name_and_bits(tmp_path, capsys):
    cfg = MODEL_PRESETS["tiny-gqa"]
    f32 = str(tmp_path / "m.bin")
    write_ggjt(f32, cfg, Vocab(make_test_vocab().tokens), random_ggjt_tensors(cfg, seed=5))
    assert cli.main(["quantize", "--model", f32, "--bits", "4", "--silent"]) == 0
    assert read_ggjt(str(tmp_path / "m-q4_0.bin")).ftype == 2
    assert cli.main(["quantize", "--silent"]) == 2
    assert "needs --model" in capsys.readouterr().err


def test_convert_subcommand_matches_the_jax_cli(tmp_path, capsys):
    from test_torch_convert import _meta_dir

    d, _ = _meta_dir(tmp_path, n_kv_heads=2, rope_theta=500000.0)
    outs = [str(tmp_path / f"{who}.bin") for who in ("j", "p")]
    for main, out in ((jcli.main, outs[0]), (cli.main, outs[1])):
        assert main(["convert", "--model", str(d), "--out", out, "--dtype", "float32",
                     "--silent"]) == 0
        assert capsys.readouterr().out == f"[CONVERT] wrote {out}\n"
    assert filecmp.cmp(*outs, shallow=False)
    assert filecmp.cmp(outs[0] + ".meta.json", outs[1] + ".meta.json", shallow=False)
    for main in (jcli.main, cli.main):
        assert main(["convert", "--model", str(d), "--out", str(tmp_path / "v.bin"),
                     "--vocab-only", "--silent"]) == 0
    assert read_ggjt(str(tmp_path / "v.bin")).tensors == {}


def _bpe_vocab(pattern):
    from llamago_tpu_torch.tokenizer_bpe import BPEVocab, bytes_to_unicode

    b2u = bytes_to_unicode()
    tokens = ["<|begin_of_text|>", "<|end_of_text|>"] + [b2u[b] for b in range(256)]
    merges = {}
    for a, b in (("h", "e"), ("l", "l"), ("he", "ll"), ("Ġ", "w"), ("o", "r"), ("Ġw", "or")):
        merges[(a, b)] = len(merges)
        tokens.append(a + b)
    return BPEVocab(tokens=tokens, merges=merges, bos_id=0, eos_id=1, pattern=pattern,
                    special_ids=frozenset({0, 1}))


@pytest.mark.parametrize("vocab_kind", ["llama", "llama-bpe", "gpt2"])
def test_oneshot_greedy_from_a_gguf_matches_the_jax_cli(tmp_path, vocab_kind, capsys):
    """A Q8_0 GGUF with a sentencepiece (`llama`) vocab or a byte-level BPE
    (`gpt2`) vocab under either pre-tokenizer: greedy one-shot output of
    both CLIs from the same file."""
    from llamago_tpu_torch.checkpoint.gguf import write_gguf

    vocab = (Vocab(make_test_vocab().tokens) if vocab_kind == "llama"
             else _bpe_vocab(vocab_kind))
    cfg = MODEL_PRESETS["tiny-gqa"].replace(vocab_size=len(vocab), rope_theta=500000.0)
    f32 = str(tmp_path / "m-f32.gguf")
    write_gguf(f32, cfg, vocab, random_ggjt_tensors(cfg, seed=13))
    q8 = quantize_ggjt(f32, str(tmp_path / "m-q8_0.gguf"), "q8_0")
    argv = ["--model", q8, "--prompt", "hello world", "--temp", "0", "--predict", "12",
            "--context", "64", "--silent"]
    assert jcli.main(argv + ["--tp", "1"]) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello world")


@pytest.mark.parametrize("size,rc,says", [(2 << 20, 0, "[LOAD] model of size 0.00 GiB"),
                                          (100, 1, "suspiciously small"),
                                          (None, 1, "was not downloaded")])
def test_load_subcommand_matches_the_jax_cli_without_fetching(tmp_path, monkeypatch,
                                                              capsys, size, rc, says):
    """`load --model NAME --dir D` builds the URL and checks the size as the
    JAX CLI does; urlretrieve is replaced, so nothing is fetched."""
    import urllib.request

    calls = []

    def fake_urlretrieve(url, dest):
        calls.append((url, dest))
        if size is None:
            raise OSError("no network")
        with open(dest, "wb") as f:
            f.write(bytes(size))

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    argv = ["load", "--model", "7B.bin", "--dir", str(tmp_path), "--silent"]
    results = []
    for main in (jcli.main, cli.main):
        code = main(argv)
        captured = capsys.readouterr()
        results.append((code, captured.out, captured.err))
    assert results[0] == results[1]
    assert results[1][0] == rc and says in results[1][1] + results[1][2]
    assert calls == [("https://nogpu.com/7B.bin", str(tmp_path / "7B.bin"))] * 2


def test_load_without_a_model_name(capsys):
    assert cli.main(["load", "--silent"]) == 2
    assert "names the file" in capsys.readouterr().err
