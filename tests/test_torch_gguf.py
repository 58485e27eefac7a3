"""Port parity of the file writers and readers: checkpoint/ggjt.py (write_ggjt,
the sidecar), checkpoint/gguf.py (read_gguf, read_checkpoint, write_gguf)
and checkpoint/sp_model.py.

The same tensors and vocab go to the JAX package's writer and the port's;
the files must be equal byte for byte, and each package must read the
other's files to equal tensors and configs. A model read from a GGUF file
runs the port's forward against the JAX forward from the same file
(TOL of tests/test_torch_model.py).
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint import ggjt as jggjt
from llamago_tpu.checkpoint import gguf as jgguf
from llamago_tpu.checkpoint import sp_model as jsp
from llamago_tpu.checkpoint.convert import vocab_from_sp_model as jvocab_from_sp_model
from llamago_tpu.checkpoint.params import load_parameters as jload_parameters
from llamago_tpu.checkpoint.quant_file import QuantTensor as JQuantTensor
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.models import llama as jllama
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu.tokenizer_bpe import BPEVocab as JBPEVocab
from llamago_tpu_torch.checkpoint import ggjt, gguf, sp_model
from llamago_tpu_torch.checkpoint.convert import vocab_from_sp_model
from llamago_tpu_torch.checkpoint.params import load_parameters
from llamago_tpu_torch.checkpoint.quant_file import QuantTensor, quantize_array
from llamago_tpu_torch.config import MODEL_PRESETS
from llamago_tpu_torch.models import llama
from llamago_tpu_torch.runtime.kv_cache import KVCache
from llamago_tpu_torch.tokenizer import Vocab, tokenize
from llamago_tpu_torch.tokenizer_bpe import BPEVocab, bytes_to_unicode

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
MATMULS = ("attention.wq", "attention.wk", "attention.wv", "attention.wo",
           "feed_forward.w1", "feed_forward.w2", "feed_forward.w3")


def _cfg(**over):
    """The same tiny-gqa config in both packages."""
    return (MODEL_PRESETS["tiny-gqa"].replace(**over),
            JPRESETS["tiny-gqa"].replace(**over))


def _tensors(cfg, kind=None, f16=False, seed=6):
    t = random_ggjt_tensors(cfg, seed=seed)
    if f16:
        t = {k: (v.astype(np.float16) if v.ndim == 2 else v) for k, v in t.items()}
    if kind:
        t = {k: (quantize_array(np.asarray(v, np.float32), kind)
                 if any(m in k for m in MATMULS) or k == "output.weight" else v)
             for k, v in t.items()}
    return t


def _jax_tensors(tensors):
    """The port's QuantTensor blocks as the JAX package's."""
    return {k: (JQuantTensor(v.kind, v.raw, v.shape) if isinstance(v, QuantTensor) else v)
            for k, v in tensors.items()}


def _bpe_vocabs(n_merges=40):
    """A byte-level BPE vocab (both packages): specials, the 256 byte tokens
    and merges of frequent pairs, with the LLaMA-3 pattern."""
    b2u = bytes_to_unicode()
    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"]
    tokens = specials + [b2u[b] for b in range(256)]
    merges = {}
    for a, b in [("t", "h"), ("th", "e"), ("Ġ", "t"), ("Ġt", "he"), ("e", "r"),
                 ("i", "n"), ("Ġ", "w"), ("o", "r"), ("Ġw", "or"), ("l", "d")][:n_merges]:
        merges[(a, b)] = len(merges)
        tokens.append(a + b)
    kw = dict(tokens=tokens, merges=merges, bos_id=0, eos_id=1, pattern="llama-bpe",
              special_ids=frozenset({0, 1, 2}))
    return BPEVocab(**kw), JBPEVocab(**kw)


# ------------------------------------------------------------------ ggjt


@pytest.mark.parametrize("ftype,kind,f16", [(0, None, False), (1, None, True),
                                            (2, "q4_0", False), (3, "q4_1", False),
                                            (7, "q8_0", False)])
def test_ggjt_bytes_match_jax_and_each_reads_the_other(tmp_path, ftype, kind, f16):
    cfg, jcfg = _cfg(rope_theta=500000.0)
    t = _tensors(cfg, kind, f16)
    p, j = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    ggjt.write_ggjt(p, cfg, Vocab(make_test_vocab().tokens), t, ftype=ftype)
    ggjt.write_meta_sidecar(p, cfg)
    jggjt.write_ggjt(j, jcfg, make_test_vocab(), _jax_tensors(t), ftype=ftype)
    jggjt.write_meta_sidecar(j, jcfg)
    assert filecmp.cmp(p, j, shallow=False)
    assert filecmp.cmp(p + ".meta.json", j + ".meta.json", shallow=False)
    mine, theirs = ggjt.read_ggjt(j), jggjt.read_ggjt(p)
    assert mine.ftype == theirs.ftype == ftype
    assert mine.config.rope_theta == theirs.config.rope_theta == 500000.0
    assert mine.vocab.tokens == theirs.vocab.tokens
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "kv_heads", "ffn_hidden",
              "norm_eps", "weight_dtype"):
        assert getattr(mine.config, f) == getattr(theirs.config, f), f
    for name, a in mine.tensors.items():
        b = theirs.tensors[name]
        if isinstance(a, QuantTensor):
            assert (a.kind, a.shape) == (b.kind, b.shape)
            np.testing.assert_array_equal(a.raw, b.raw)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("over,written", [({}, None),
                                          ({"rope_theta": 500000.0}, '{"rope_theta": 500000.0}'),
                                          ({"norm_eps": 1e-6, "rope_theta": 1e6},
                                           '{"rope_theta": 1000000.0, "norm_eps": 1e-06}')])
def test_sidecar_bytes_match_jax(tmp_path, over, written):
    cfg, jcfg = _cfg(**over)
    p, j = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    ggjt.write_meta_sidecar(p, cfg)
    jggjt.write_meta_sidecar(j, jcfg)
    assert ggjt.sidecar_path(p) == jggjt.sidecar_path(p) == p + ".meta.json"
    if written is None:
        assert not (tmp_path / "p.bin.meta.json").exists()
        assert not (tmp_path / "j.bin.meta.json").exists()
    else:
        assert (tmp_path / "p.bin.meta.json").read_text() == written
        assert filecmp.cmp(p + ".meta.json", j + ".meta.json", shallow=False)


def test_ggjt_header_pads_a_short_vocab_and_refuses_a_long_one(tmp_path):
    cfg, jcfg = _cfg()
    short = Vocab(make_test_vocab().tokens[:270])
    p, j = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    ggjt.write_ggjt(p, cfg, short, {})
    jggjt.write_ggjt(j, jcfg, make_test_vocab().__class__(short.tokens), {})
    assert filecmp.cmp(p, j, shallow=False)
    ck = ggjt.read_ggjt(p)
    assert len(ck.vocab) == cfg.vocab_size and ck.tensors == {}
    assert ck.vocab.id_to_piece(270) == b"<pad0>"
    with pytest.raises(ValueError, match="overflow"):
        ggjt.write_ggjt(p, cfg.replace(vocab_size=10), short, {})


def test_ggjt_reader_refuses_a_gguf_file_as_the_jax_reader_does(tmp_path):
    cfg, jcfg = _cfg()
    path = str(tmp_path / "m.gguf")
    gguf.write_gguf(path, cfg, Vocab(make_test_vocab().tokens), _tensors(cfg))
    with pytest.raises(ValueError, match="bad magic"):
        ggjt.read_ggjt(path)
    with pytest.raises(ValueError, match="bad magic"):
        jggjt.read_ggjt(path)
    assert gguf.read_checkpoint(path).config.dim == cfg.dim


# ------------------------------------------------------------------ GGUF


@pytest.mark.parametrize("vocab_kind", ["llama", "gpt2"])
@pytest.mark.parametrize("kind", [None, "q8_0", "q4_0", "q4_1"])
def test_gguf_bytes_match_jax_and_each_reads_the_other(tmp_path, vocab_kind, kind):
    if vocab_kind == "llama":
        pv, jv = Vocab(make_test_vocab().tokens), make_test_vocab()
    else:
        pv, jv = _bpe_vocabs()
    cfg, jcfg = _cfg(vocab_size=len(pv), rope_theta=123456.0, norm_eps=1e-6,
                     max_seq_len=64)
    t = _tensors(cfg, kind, f16=kind is None)
    p, j = str(tmp_path / "p.gguf"), str(tmp_path / "j.gguf")
    gguf.write_gguf(p, cfg, pv, t)
    jgguf.write_gguf(j, jcfg, jv, _jax_tensors(t))
    assert filecmp.cmp(p, j, shallow=False)
    assert gguf.is_gguf(p) and not gguf.is_gguf(__file__)
    mine, theirs = gguf.read_gguf(j, max_seq_len=64), jgguf.read_gguf(p, max_seq_len=64)
    assert mine.ftype == theirs.ftype
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "kv_heads", "ffn_hidden",
              "rope_theta", "norm_eps", "weight_dtype", "max_seq_len"):
        assert getattr(mine.config, f) == getattr(theirs.config, f), f
    assert mine.config.kv_heads == 2 and mine.config.rope_theta == 123456.0
    assert type(mine.vocab).__name__ == type(theirs.vocab).__name__
    if vocab_kind == "gpt2":
        assert mine.vocab.tokens == theirs.vocab.tokens
        assert mine.vocab.merges == theirs.vocab.merges
        assert (mine.vocab.pattern, mine.vocab.special_ids) == \
               (theirs.vocab.pattern, theirs.vocab.special_ids) == ("llama-bpe",
                                                                    frozenset({0, 1, 2}))
    else:
        assert mine.vocab.tokens == theirs.vocab.tokens
    assert list(mine.tensors) == list(theirs.tensors)
    for name, a in mine.tensors.items():
        b = theirs.tensors[name]
        if isinstance(a, QuantTensor):
            np.testing.assert_array_equal(a.raw, b.raw)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_read_checkpoint_dispatches_on_the_magic(tmp_path):
    cfg, _ = _cfg()
    t = _tensors(cfg)
    gguf.write_gguf(str(tmp_path / "m.gguf"), cfg, Vocab(make_test_vocab().tokens), t)
    ggjt.write_ggjt(str(tmp_path / "m.bin"), cfg, Vocab(make_test_vocab().tokens), t)
    a = gguf.read_checkpoint(str(tmp_path / "m.gguf"), max_seq_len=32)
    b = gguf.read_checkpoint(str(tmp_path / "m.bin"), max_seq_len=32)
    assert a.config.max_seq_len == b.config.max_seq_len == 32
    for name in t:
        np.testing.assert_array_equal(a.tensors[name], b.tensors[name])


def test_gguf_tied_embeddings_alias_the_table(tmp_path):
    cfg, jcfg = _cfg()
    t = {k: v for k, v in _tensors(cfg).items() if k != "output.weight"}
    path = str(tmp_path / "tied.gguf")
    gguf.write_gguf(path, cfg, Vocab(make_test_vocab().tokens), t)
    ck, jck = gguf.read_checkpoint(path), jgguf.read_checkpoint(path)
    assert ck.tensors["output.weight"] is ck.tensors["tok_embeddings.weight"]
    np.testing.assert_array_equal(ck.tensors["output.weight"], jck.tensors["output.weight"])
    p = load_parameters(ck.config.replace(dtype="float32", weight_dtype="float32"),
                        ck.tensors, device="cpu")
    assert p["output"].shape == p["tok_embeddings"].shape[::-1]


def test_gguf_vocab_only_file_reads_and_cannot_load(tmp_path):
    cfg, jcfg = _cfg()
    p, j = str(tmp_path / "p.gguf"), str(tmp_path / "j.gguf")
    gguf.write_gguf(p, cfg, Vocab(make_test_vocab().tokens), {})
    jgguf.write_gguf(j, jcfg, make_test_vocab(), {})
    assert filecmp.cmp(p, j, shallow=False)
    ck = gguf.read_checkpoint(p)
    assert ck.tensors == {} and len(ck.vocab) == len(make_test_vocab())
    assert ck.config.vocab_size == cfg.vocab_size  # llama.vocab_size, not the list
    from llamago_tpu_torch.checkpoint.params import host_parameters

    with pytest.raises(ValueError, match="no model tensors"):
        host_parameters(ck.config, ck.tensors)


def test_gguf_missing_tensor_is_refused_by_both(tmp_path):
    cfg, _ = _cfg()
    t = {k: v for k, v in _tensors(cfg).items() if k != "layers.1.feed_forward.w2.weight"}
    path = str(tmp_path / "missing.gguf")
    gguf.write_gguf(path, cfg, Vocab(make_test_vocab().tokens), t)
    for read in (gguf.read_checkpoint, jgguf.read_checkpoint):
        with pytest.raises(ValueError, match="missing tensors"):
            read(path)


def _retype(path, name, ggml_type):
    """Rewrite one tensor's ggml type in a GGUF file's tensor infos."""
    data = bytearray(open(path, "rb").read())
    key = name.encode()
    at = data.index(len(key).to_bytes(8, "little") + key) + 8 + len(key)
    n_dims = int.from_bytes(data[at:at + 4], "little")
    at += 4 + 8 * n_dims
    data[at:at + 4] = ggml_type.to_bytes(4, "little")
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("ggml_type", [10, 12, 14])  # Q2_K, Q4_K, Q6_K
def test_gguf_k_quants_are_refused_with_the_jax_message(tmp_path, ggml_type):
    cfg, _ = _cfg()
    path = str(tmp_path / "k.gguf")
    gguf.write_gguf(path, cfg, Vocab(make_test_vocab().tokens), _tensors(cfg, "q8_0"))
    _retype(path, "blk.0.attn_q.weight", ggml_type)
    msgs = []
    for read in (gguf.read_checkpoint, jgguf.read_checkpoint):
        with pytest.raises(ValueError, match="K-quant") as e:
            read(path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_gguf_unknown_tokenizer_model_is_refused(tmp_path):
    cfg, _ = _cfg()
    path = str(tmp_path / "bad.gguf")
    gguf.write_gguf(path, cfg, Vocab(make_test_vocab().tokens), _tensors(cfg),
                    extra_meta={"tokenizer.ggml.model": (gguf._T_STRING, b"wordpiece")})
    for read in (gguf.read_checkpoint, jgguf.read_checkpoint):
        with pytest.raises(ValueError, match="wordpiece"):
            read(path)


def test_gguf_writer_refuses_other_dtypes(tmp_path):
    cfg, _ = _cfg()
    t = _tensors(cfg)
    t["norm.weight"] = t["norm.weight"].astype(np.float64)
    with pytest.raises(ValueError, match="float64"):
        gguf.write_gguf(str(tmp_path / "m.gguf"), cfg, Vocab(make_test_vocab().tokens), t)


@pytest.mark.parametrize("vocab_kind", ["llama", "gpt2"])
@pytest.mark.parametrize("kind", [None, "q8_0"])
def test_forward_from_a_gguf_file_matches_the_jax_forward(tmp_path, vocab_kind, kind):
    """read_checkpoint -> load_parameters -> forward, in each package from
    the same file: logits within TOL; and the prompt tokenizes alike."""
    pv, jv = ((Vocab(make_test_vocab().tokens), make_test_vocab()) if vocab_kind == "llama"
              else _bpe_vocabs())
    cfg, _ = _cfg(vocab_size=len(pv), rope_theta=500000.0, max_seq_len=32)
    path = str(tmp_path / "m.gguf")
    gguf.write_gguf(path, cfg, pv, _tensors(cfg, kind))
    ck, jck = gguf.read_checkpoint(path, max_seq_len=32), jgguf.read_checkpoint(path,
                                                                                max_seq_len=32)
    text = " hello world, the other"
    from llamago_tpu.tokenizer import tokenize as jtokenize

    ids = tokenize(ck.vocab, text, bos=True)
    assert ids == jtokenize(jck.vocab, text, bos=True)
    tokens = np.array([ids[:8]], np.int32)
    wd = "int8" if kind else "float32"
    jcfg = jck.config.replace(dtype="float32", weight_dtype=wd)
    jp = jload_parameters(jcfg, jck.tensors)
    want, _ = jllama.forward(jp, jnp.asarray(tokens), JKVCache.create(jcfg, batch=1),
                             jnp.zeros(1, jnp.int32), jcfg, return_all_logits=True)
    pcfg = ck.config.replace(dtype="float32", weight_dtype=wd)
    p = load_parameters(pcfg, ck.tensors, device="cpu")
    got, _ = llama.forward_impl(p, torch.from_numpy(tokens).long(),
                                KVCache.create(pcfg, batch=1, device="cpu"),
                                torch.zeros(1, dtype=torch.long), pcfg,
                                return_all_logits=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -------------------------------------------------------------- sp_model


def _pieces(mod):
    sp = mod.SentencePiece
    out = [sp("<unk>", 0.0, mod.UNKNOWN), sp("<s>", 0.0, mod.CONTROL),
           sp("</s>", 0.0, mod.CONTROL)]
    out += [sp(f"<0x{b:02X}>", -1000.0, mod.BYTE) for b in range(256)]
    out += [sp(p, s, mod.NORMAL) for p, s in (("▁hello", -1.5), ("wo", -2.0), ("▁", -3.0),
                                               ("日本", -4.25), ("x" * 200, -9.0))]
    out += [sp("<user>", 0.0, mod.USER_DEFINED), sp("<unused0>", 0.0, mod.UNUSED)]
    return out


def test_sp_model_bytes_match_jax_and_read_back(tmp_path):
    p, j = str(tmp_path / "p.model"), str(tmp_path / "j.model")
    sp_model.write_sp_model(p, _pieces(sp_model))
    jsp.write_sp_model(j, _pieces(jsp))
    assert filecmp.cmp(p, j, shallow=False)
    mine, theirs = sp_model.read_sp_model(j), jsp.read_sp_model(p)
    assert [(a.piece, a.score, a.type) for a in mine] == \
           [(b.piece, b.score, b.type) for b in theirs]
    assert mine[3].is_byte and mine[3].byte_value() == 0 and mine[0].is_unknown
    assert vocab_from_sp_model(p).tokens == jvocab_from_sp_model(p).tokens


def test_sp_vocab_survives_a_gguf_round_trip(tmp_path):
    vocab = Vocab(make_test_vocab().tokens)
    cfg, _ = _cfg(vocab_size=len(vocab))
    path = str(tmp_path / "sp.gguf")
    gguf.write_gguf(path, cfg, vocab, _tensors(cfg))
    back = gguf.read_checkpoint(path).vocab
    assert [back.id_to_piece(i) for i in range(len(vocab))] == \
           [vocab.id_to_piece(i) for i in range(len(vocab))]


@pytest.mark.parametrize("vocab_size", [280, 4095])
@pytest.mark.parametrize("kind,exec_fmt", [("q8_0", "q4_0"), ("q4_0", "q4_0"),
                                           ("q4_0", "w4x8"), ("q4_1", "q4_0")])
def test_a_head_the_kernels_cannot_take_is_padded_and_sliced(tmp_path, monkeypatch,
                                                             vocab_size, kind, exec_fmt):
    """A quantized file whose vocab is no multiple of 16: the loaded head's
    width is one the CUDA matmul kernels take (a multiple of 16; the
    4096-multiple where that adds at most 5%; Q4_1 heads run on their plain
    version and stay), and the forward's logits keep the vocab's width,
    bit-identical to the unpadded head's."""
    from llamago_tpu_torch.checkpoint.params import fuse_layer_weights, unstack_layer_params

    monkeypatch.setenv("LLAMAGO_INT4_EXEC", exec_fmt)
    cfg, _ = _cfg(vocab_size=vocab_size, max_seq_len=32)
    vocab = Vocab([(b"t%d" % i, 0.0) for i in range(vocab_size)])
    path = str(tmp_path / "m.gguf")
    gguf.write_gguf(path, cfg, vocab, _tensors(cfg, kind))
    ck = gguf.read_checkpoint(path, max_seq_len=32)
    pcfg = ck.config.replace(dtype="float32")
    p = fuse_layer_weights(unstack_layer_params(load_parameters(pcfg, ck.tensors, device="cpu"),
                                                pcfg.n_layers))
    head = p["output"]
    width = next(v for k, v in head.items() if k != "s" and k != "m").shape[-1]
    want_width = vocab_size if kind == "q4_1" else {280: 288, 4095: 4096}[vocab_size]
    assert width == want_width
    for lp in p["layers"]:
        for leaf in lp.values():
            if isinstance(leaf, dict):
                assert leaf["s"].shape[-1] % 16 == 0
    unpadded = {**p, "output": {k: v[..., :vocab_size] for k, v in head.items()}}
    tokens = torch.tensor([[1, 5, 42, 200, 7]])
    logits = []
    for tree in (p, unpadded):
        lg, _ = llama.forward_impl(tree, tokens, KVCache.create(pcfg, batch=1, device="cpu"),
                                   torch.zeros(1, dtype=torch.long), pcfg, return_all_logits=True)
        logits.append(lg)
    assert logits[0].shape[-1] == vocab_size
    assert torch.equal(logits[0], logits[1])
