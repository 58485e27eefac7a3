"""Port parity of the converter (checkpoint/convert.py): Meta `.pth` and
HuggingFace directories made here in a temp dir convert to ggjt and GGUF
files equal byte for byte to the JAX package's `convert` output, and the
converted models run the port's forward against the JAX forward from the
same file (TOL of tests/test_torch_model.py) and against transformers.
"""

import argparse
import filecmp
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint import convert as jconvert
from llamago_tpu.checkpoint.gguf import read_checkpoint as jread_checkpoint
from llamago_tpu.checkpoint.params import load_parameters as jload_parameters
from llamago_tpu.checkpoint.sp_model import write_sp_model as jwrite_sp_model
from llamago_tpu.models import llama as jllama
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu_torch.checkpoint import convert
from llamago_tpu_torch.checkpoint.gguf import read_checkpoint
from llamago_tpu_torch.checkpoint.params import load_parameters
from llamago_tpu_torch.checkpoint.sp_model import (
    BYTE,
    CONTROL,
    NORMAL,
    UNKNOWN,
    SentencePiece,
    read_sp_model,
    write_sp_model,
)
from llamago_tpu_torch.models import llama
from llamago_tpu_torch.runtime.kv_cache import KVCache
from llamago_tpu_torch.tokenizer_bpe import LLAMA3_PATTERN, BPEVocab, bytes_to_unicode

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def make_sp_model(path, extra=(("▁hi", -1.0), ("▁the", -2.0), ("▁a", -3.0))):
    pieces = [SentencePiece("<unk>", 0.0, UNKNOWN), SentencePiece("<s>", 0.0, CONTROL),
              SentencePiece("</s>", 0.0, CONTROL)]
    pieces += [SentencePiece(f"<0x{b:02X}>", -1000.0, BYTE) for b in range(256)]
    pieces += [SentencePiece(p, s, NORMAL) for p, s in extra]
    write_sp_model(path, pieces)
    return len(pieces)


def _meta_dir(tmp_path, dim=4096, n_parts=1, n_kv_heads=None, rope_theta=None):
    """A Meta checkpoint directory: params.json, consolidated.NN.pth (saved
    with torch.save, TP shards split by the reference's rules) and
    ../tokenizer.model. `dim` picks the part count (4096: 1, 5120: 2); the
    tensors themselves are small."""
    d = tmp_path / f"meta{dim}"
    d.mkdir()
    hp = {"dim": dim, "n_heads": 4, "n_layers": 2, "multiple_of": 256, "vocab_size": -1}
    if n_kv_heads:
        hp["n_kv_heads"] = n_kv_heads
    if rope_theta:
        hp["rope_theta"] = rope_theta
    (d / "params.json").write_text(json.dumps(hp))
    n_vocab = make_sp_model(str(tmp_path / "tokenizer.model"))
    rng = np.random.default_rng(dim)
    e, kvd, f = 16, 16 * (n_kv_heads or 4) // 4, 32

    def mat(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    full = {"tok_embeddings.weight": mat(n_vocab, e), "norm.weight": mat(e),
            "output.weight": mat(n_vocab, e)}
    for i in range(2):
        p = f"layers.{i}."
        full |= {p + "attention_norm.weight": mat(e), p + "ffn_norm.weight": mat(e),
                 p + "attention.wq.weight": mat(e, e), p + "attention.wk.weight": mat(kvd, e),
                 p + "attention.wv.weight": mat(kvd, e), p + "attention.wo.weight": mat(e, e),
                 p + "feed_forward.w1.weight": mat(f, e), p + "feed_forward.w2.weight": mat(e, f),
                 p + "feed_forward.w3.weight": mat(f, e)}
    for part in range(n_parts):
        state = {"rope.freqs": torch.ones(4)}
        for name, arr in full.items():
            split = convert.split_dim_for(name) if arr.ndim == 2 else -1
            if split >= 0:
                arr = np.split(arr, n_parts, axis=split)[part]
            state[name] = torch.from_numpy(np.ascontiguousarray(arr))
        torch.save(state, str(d / f"consolidated.{part:02d}.pth"))
    return d, full


@pytest.mark.parametrize("dim,n_parts", [(4096, 1), (5120, 2)])
@pytest.mark.parametrize("ftype", [0, 1])
def test_meta_checkpoint_converts_to_the_jax_packages_bytes(tmp_path, dim, n_parts, ftype):
    d, full = _meta_dir(tmp_path, dim, n_parts, n_kv_heads=2, rope_theta=500000.0)
    got = convert.convert(str(d), out_path=str(tmp_path / "p.bin"), ftype=ftype, fmt="meta")
    want = jconvert.convert(str(d), out_path=str(tmp_path / "j.bin"), ftype=ftype, fmt="meta")
    assert filecmp.cmp(got, want, shallow=False)
    assert filecmp.cmp(got + ".meta.json", want + ".meta.json", shallow=False)
    ck = read_checkpoint(got)
    assert "rope.freqs" not in ck.tensors and ck.config.rope_theta == 500000.0
    for name, arr in full.items():
        t = ck.tensors[name]
        assert t.dtype == (np.float16 if ftype == 1 and arr.ndim == 2 else np.float32)
        np.testing.assert_array_equal(t, arr.astype(t.dtype), err_msg=name)


def test_meta_vocab_only_and_the_cli(tmp_path):
    d, _ = _meta_dir(tmp_path)
    args = dict(model=str(d), dtype="float32", vocab_only=True)
    assert convert.convert_cli(argparse.Namespace(out=str(tmp_path / "p.bin"), **args)) == 0
    assert jconvert.convert_cli(argparse.Namespace(out=str(tmp_path / "j.bin"), **args)) == 0
    assert filecmp.cmp(tmp_path / "p.bin", tmp_path / "j.bin", shallow=False)
    ck = read_checkpoint(str(tmp_path / "p.bin"))
    assert ck.tensors == {} and len(ck.vocab) == 262
    assert not (tmp_path / "p.bin.meta.json").exists()
    assert convert.convert_cli(argparse.Namespace(model="", out="", dtype=None,
                                                  vocab_only=False)) == 2
    # the default output name, beside the checkpoint
    out = convert.convert(str(d), ftype=1)
    assert out == str(d / "ggjt-model-f16.bin")


def test_in_ram_meta_loader_matches_jax(tmp_path):
    d, full = _meta_dir(tmp_path, 5120, 2)
    hp, tensors = convert.load_meta_checkpoint(str(d))
    jhp, jtensors = jconvert.load_meta_checkpoint(str(d))
    assert hp == jhp and list(tensors) == list(jtensors)
    for name in tensors:
        np.testing.assert_array_equal(tensors[name], jtensors[name])
        np.testing.assert_array_equal(tensors[name], full[name])


def test_unpermute_hf_rope_matches_jax_and_inverts_the_hf_permutation():
    rng = np.random.default_rng(0)
    for h, hd, d in ((4, 16, 64), (2, 128, 32)):
        w = rng.standard_normal((h * hd, d)).astype(np.float32)
        permuted = w.reshape(h, hd // 2, 2, d).swapaxes(1, 2).reshape(h * hd, d)
        np.testing.assert_array_equal(convert.unpermute_hf_rope(permuted, h), w)
        np.testing.assert_array_equal(convert.unpermute_hf_rope(permuted, h),
                                      jconvert.unpermute_hf_rope(permuted, h))


def test_split_dim_rules_match_jax():
    for name in ("output.weight", "layers.3.attention.wq.weight", "tok_embeddings.weight",
                 "layers.5.attention.wo.weight", "layers.2.feed_forward.w2.weight",
                 "layers.0.feed_forward.w3.weight", "norm.weight"):
        assert convert.split_dim_for(name) == jconvert.split_dim_for(name)


def _bpe_tokenizer_json(path):
    """A LLaMA-3-style tokenizer.json: byte tokens, a few merges, the
    LLaMA-3 split pattern, special tokens."""
    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    merges = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("Ġ", "h"), ("Ġh", "i")]
    tokens += [a + b for a, b in merges]
    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"]
    data = {"model": {"type": "BPE", "vocab": {t: i for i, t in enumerate(tokens)},
                      "merges": [f"{a} {b}" for a, b in merges]},
            "added_tokens": [{"id": len(tokens) + i, "content": s, "special": True}
                             for i, s in enumerate(specials)],
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}},
                {"type": "ByteLevel"}]}}
    path.write_text(json.dumps(data))
    return len(tokens) + len(specials)


def _hf_dir(tmp_path, tokenizer, safe=True, tie=False, seed=1):
    """A tiny GQA LLaMA saved by transformers, with a sentencepiece
    tokenizer.model or a BPE tokenizer.json."""
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    d = tmp_path / f"hf-{tokenizer}-{safe}-{tie}"
    d.mkdir()
    if tokenizer == "sp":
        vocab_size = make_sp_model(str(d / "tokenizer.model"))
    else:
        vocab_size = _bpe_tokenizer_json(d / "tokenizer.json")
    cfg = transformers.LlamaConfig(
        vocab_size=vocab_size, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=500000.0, tie_word_embeddings=tie,
        bos_token_id=vocab_size - 3 if tokenizer == "bpe" else 1,
        eos_token_id=[vocab_size - 2, vocab_size - 1] if tokenizer == "bpe" else 2)
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(cfg).eval()
    model.save_pretrained(str(d), safe_serialization=safe)
    return d, model


def _logits(path, ids):
    """(port, JAX, ids) logits of a converted file, each package reading it."""
    ck, jck = read_checkpoint(path, max_seq_len=32), jread_checkpoint(path, max_seq_len=32)
    cfg = ck.config.replace(dtype="float32", weight_dtype="float32")
    jcfg = jck.config.replace(dtype="float32", weight_dtype="float32")
    p = load_parameters(cfg, ck.tensors, device="cpu")
    got, _ = llama.forward_impl(p, torch.from_numpy(ids).long(),
                                KVCache.create(cfg, batch=1, device="cpu"),
                                torch.zeros(1, dtype=torch.long), cfg, return_all_logits=True)
    jp = jload_parameters(jcfg, jck.tensors)
    want, _ = jllama.forward(jp, jnp.asarray(ids), JKVCache.create(jcfg, batch=1),
                             jnp.zeros(1, jnp.int32), jcfg, return_all_logits=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("tokenizer,safe,tie", [("sp", True, False), ("sp", True, True),
                                                ("sp", False, False), ("bpe", True, False),
                                                ("bpe", True, True)])
@pytest.mark.parametrize("ftype", [0, 1])
def test_hf_checkpoint_converts_to_the_jax_packages_bytes(tmp_path, tokenizer, safe, tie,
                                                          ftype):
    """HF safetensors (streamed) or torch-bin (through transformers) with a
    sentencepiece tokenizer -> ggjt; with a BPE tokenizer.json -> GGUF. The
    file equals JAX's; its logits equal the JAX forward's within TOL and
    transformers' within 5e-3 (q/k un-permuted, tied heads written)."""
    d, model = _hf_dir(tmp_path, tokenizer, safe, tie)
    ext = ".gguf" if tokenizer == "bpe" else ".bin"
    got = convert.convert(str(d), out_path=str(tmp_path / f"p{ext}"), ftype=ftype)
    want = jconvert.convert(str(d), out_path=str(tmp_path / f"j{ext}"), ftype=ftype)
    assert filecmp.cmp(got, want, shallow=False)
    ck = read_checkpoint(got, max_seq_len=32)
    assert ck.config.kv_heads == 2 and ck.config.rope_theta == 500000.0
    if tokenizer == "bpe":
        assert isinstance(ck.vocab, BPEVocab) and ck.vocab.pattern == "llama-bpe"
        assert ck.vocab.bos_id == ck.config.vocab_size - 3
    ids = np.array([[1, 17, 99, 4, 55]], np.int32)
    mine, theirs = _logits(got, ids)
    np.testing.assert_allclose(mine, theirs, **TOL)
    if ftype == 0:
        with torch.no_grad():
            hf = model(torch.from_numpy(ids.astype(np.int64))).logits.numpy()
        np.testing.assert_allclose(mine, hf, rtol=0, atol=5e-3)


def test_hf_vocab_only_and_hparams(tmp_path):
    d, _ = _hf_dir(tmp_path, "sp")
    got = convert.convert(str(d), out_path=str(tmp_path / "p.bin"), ftype=0, vocab_only=True)
    want = jconvert.convert(str(d), out_path=str(tmp_path / "j.bin"), ftype=0, vocab_only=True)
    assert filecmp.cmp(got, want, shallow=False)
    ck = read_checkpoint(got)
    assert ck.tensors == {} and ck.config.dim == 64
    assert convert.hf_hparams(str(d)) == jconvert.hf_hparams(str(d))
    hp, tensors = convert.load_hf_checkpoint(str(d))
    jhp, jtensors = jconvert.load_hf_checkpoint(str(d))
    assert hp == jhp and sorted(tensors) == sorted(jtensors)
    for name in tensors:
        np.testing.assert_array_equal(tensors[name], jtensors[name])


def test_bpe_hf_refuses_vocab_only_and_a_ggjt_output(tmp_path):
    d, _ = _hf_dir(tmp_path, "bpe")
    for fn in (convert.convert, jconvert.convert):
        with pytest.raises(ValueError, match="vocab-only"):
            fn(str(d), vocab_only=True)
        with pytest.raises(ValueError, match=r"\.gguf"):
            fn(str(d), out_path=str(tmp_path / "x.bin"))


def test_sp_model_written_by_the_jax_package_reads_here(tmp_path):
    from llamago_tpu.checkpoint import sp_model as jsp

    path = str(tmp_path / "tokenizer.model")
    jwrite_sp_model(path, [jsp.SentencePiece("▁a", -1.0, jsp.NORMAL),
                           jsp.SentencePiece("<0x0A>", 0.0, jsp.BYTE)])
    back = read_sp_model(path)
    assert [(p.piece, p.score, p.type) for p in back] == [("▁a", -1.0, NORMAL),
                                                         ("<0x0A>", 0.0, BYTE)]
