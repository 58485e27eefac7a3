"""Port parity of the byte-level BPE tokenizer (tokenizer_bpe.py).

The port splits text with one hand-written scanner per named pattern
(`split_gpt2`, `split_llama3`) where the JAX package uses the `regex`
module; both are held against `regex` on chosen cases and on hypothesis
strings. Encode and decode are held against the JAX package's BPEVocab on
vocabs from an HF tokenizer.json (a ByteLevel BPE trained here by the HF
`tokenizers` library) and from GGUF metadata, and the engine and the
server read a BPEVocab's stop ids and chat-template hint.
"""

import json
import urllib.request
import warnings

import numpy as np
import pytest
import regex
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from llamago_tpu import tokenizer_bpe as jbpe
from llamago_tpu.tokenizer import tokenize as jtokenize
from llamago_tpu_torch import tokenizer_bpe as bpe
from llamago_tpu_torch.checkpoint import gguf
from llamago_tpu_torch.checkpoint.params import load_parameters
from llamago_tpu_torch.config import MODEL_PRESETS, GenerateConfig, ServerConfig
from llamago_tpu_torch.runtime.engine import Engine, JobStatus
from llamago_tpu_torch.server.api import JobServer
from llamago_tpu_torch.tokenizer import detokenize, tokenize

from conftest import random_ggjt_tensors

torch.set_num_threads(1)

CORPUS = [
    "Hello world",
    "Hello, world! It's Ada's 123rd test...",
    "  leading and   multiple   spaces ",
    "tabs\tand\nnewlines\r\n\r\nhere",
    "numbers 1234567890 and 3.14159",
    "unicode: héllo wörld — ünïcödé",
    "emoji: 🚀🔥 and mixed 日本語テキスト",
    "don't can't I'll we've they're it'd I'm HE'S 'ſ",
    "CamelCaseAndSNAKE_CASE mixed123abc",
    "!!!???###$$$ %^&*()",
    "é combining à́b",
    "\x1c\x1d\x1e\x1f unit seps \x85 nel \xa0 nbsp",
    "",
    " ",
    "\n",
    "a",
]

# the cases the scanners must get right, each named by what it covers
SCANNER_CASES = [
    "\x1c\x1d\x1e\x1fx \x85y\xa0z",  # \s is White_Space, not str.isspace
    "it'S I'LL 'ſ 'Re we'VE 'Ll 'x",  # case-folded contractions
    "1 12 123 1234 12345678 ١٢٣٤",  # digit runs longer than 3
    "a  \t b   c\t\td",  # whitespace runs before a letter
    "x\r\n\r\ny \r\n z\n\n\n",  # \r\n runs
    "éx ́a ́̂b",  # combining marks
    "  !!\n\n?? ...\r\n",  # other runs and their newlines
    "'",
    " ",
    "\t\n \u3000x\u2028y",
]


@pytest.mark.parametrize("name,split", [("gpt2", bpe.split_gpt2),
                                        ("llama-bpe", bpe.split_llama3)])
@pytest.mark.parametrize("text", SCANNER_CASES + CORPUS)
def test_scanner_splits_as_regex_does(name, split, text):
    want = [m.group() for m in regex.compile(jbpe.PATTERNS[name]).finditer(text)]
    assert split(text) == want


# letters, digits, marks, the whitespace set and its neighbours, quotes,
# the contraction letters and their folds; no code point that the
# interpreter's and `regex`'s Unicode databases assign differently
_ALPHABET = st.sampled_from(list(
    " \t\n\r\x0b\x0c\x1c\x1d\x1e\x1f\x85\xa0\u2002\u2009\u2028\u3000"
    "'sdmtlvreSDMTLVRE\u017f"
    "ab\u00e9\u0301\u0300x1234567890\u0663\u2167\u00bd!?.-_()"
    "\u65e5\u672c\U0001f680"))


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.text(alphabet=_ALPHABET, max_size=24))
def test_scanners_split_hypothesis_text_as_regex_does(text):
    for name, split in (("gpt2", bpe.split_gpt2), ("llama-bpe", bpe.split_llama3)):
        want = [m.group() for m in regex.compile(jbpe.PATTERNS[name]).finditer(text)]
        assert split(text) == want, name


def test_known_patterns_take_the_scanners_and_others_regex():
    assert bpe.pre_tokenizer("gpt2") is bpe.split_gpt2
    assert bpe.pre_tokenizer("default") is bpe.split_gpt2
    assert bpe.pre_tokenizer("llama-bpe") is bpe.split_llama3
    assert bpe.pre_tokenizer(jbpe.LLAMA3_PATTERN) is bpe.split_llama3
    assert bpe.pre_tokenizer(jbpe.GPT2_PATTERN) is bpe.split_gpt2
    raw = r"\p{L}+|\p{N}|[^\p{L}\p{N}]+"
    assert bpe.pre_tokenizer(raw)("ab12 c") == ["ab", "1", "2", " ", "c"]


# ------------------------------------------------------------ the vocabs


@pytest.fixture(scope="module")
def trained():
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    del tokenizers
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=600, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    text = " ".join(CORPUS) * 5 + " the quick brown fox jumps over the lazy dog " * 20
    tok.train_from_iterator([text], trainer)
    return tok


def _tokenizer_json(tmp_path, trained, pattern=None, specials=()):
    """The trained tokenizer as a tokenizer.json, with a Split pre-tokenizer
    on `pattern` (as LLaMA-3's carries) and added special tokens."""
    data = json.loads(trained.to_str())
    n = len(data["model"]["vocab"])
    data["added_tokens"] = [{"id": n + i, "content": s, "special": True}
                            for i, s in enumerate(specials)]
    if pattern is not None:
        data["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated"},
            {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False}]}
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(data))
    return str(path), n


@pytest.mark.parametrize("pattern", [None, jbpe.LLAMA3_PATTERN,
                                     r"\p{L}+|\p{N}{1,2}|[^\p{L}\p{N}]+"])
def test_tokenizer_json_vocab_encodes_as_jax(tmp_path, trained, pattern):
    """Encode and decode the corpus (with chat markup) as the JAX package's
    BPEVocab from the same tokenizer.json: gpt2 (no Split pattern), the
    LLaMA-3 raw pattern (the scanner here, `regex` in JAX) and a raw
    pattern of its own (`regex` in both)."""
    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>", "<|eot|>"]
    path, n = _tokenizer_json(tmp_path, trained, pattern, specials)
    mine = bpe.bpe_vocab_from_tokenizer_json(path, bos_id=n, eos_id=n + 1)
    theirs = jbpe.bpe_vocab_from_tokenizer_json(path, bos_id=n, eos_id=n + 1)
    assert mine.tokens == theirs.tokens and mine.merges == theirs.merges
    assert mine.special_ids == theirs.special_ids and mine.stop_ids == theirs.stop_ids
    assert mine.pattern == theirs.pattern == (pattern or "gpt2")
    if pattern == jbpe.LLAMA3_PATTERN:
        assert mine._split is bpe.split_llama3
    texts = CORPUS + ["<|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|><|eot|>x",
                      "a<|eot_i<|eot|>d|>", "<|begin_of_text|><|begin_of_text|>"]
    for text in texts:
        ids = tokenize(mine, text, bos=True)
        assert ids == jtokenize(theirs, text, bos=True), text
        assert detokenize(mine, ids) == theirs.decode(ids)
    assert tokenize(mine, "x<|eot|>".encode()) == jtokenize(theirs, "x<|eot|>".encode())


def test_trained_vocab_matches_the_hf_tokenizer(trained, tmp_path):
    path, n = _tokenizer_json(tmp_path, trained)
    mine = bpe.bpe_vocab_from_tokenizer_json(path, bos_id=n, eos_id=n + 1)
    for text in CORPUS:
        assert mine.encode(text) == trained.encode(text).ids, text
        assert mine.decode(mine.encode(text)) == text


def test_gguf_metadata_vocab_encodes_as_jax(tmp_path, trained):
    path, n = _tokenizer_json(tmp_path, trained, jbpe.LLAMA3_PATTERN,
                              ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"])
    vocab = bpe.bpe_vocab_from_tokenizer_json(path, bos_id=n, eos_id=n + 1)
    cfg = MODEL_PRESETS["tiny"].replace(vocab_size=len(vocab))
    out = str(tmp_path / "v.gguf")
    gguf.write_gguf(out, cfg, vocab, {})
    from llamago_tpu.checkpoint.gguf import read_gguf as jread_gguf

    mine, theirs = gguf.read_gguf(out).vocab, jread_gguf(out).vocab
    assert mine.pattern == theirs.pattern == "llama-bpe"  # the raw pattern named
    assert mine.special_ids == theirs.special_ids == frozenset({n, n + 1, n + 2})
    for text in CORPUS + ["hi<|eot_id|>there"]:
        assert mine.encode(text, bos=True) == theirs.encode(text, bos=True), text


@pytest.mark.parametrize("pre", [b"qwen2", b"smaug-bpe"])
def test_unknown_pre_name_warns_and_takes_gpt2_in_both(pre):
    b2u = bpe.bytes_to_unicode()
    meta = {"tokenizer.ggml.tokens": [b2u[b].encode() for b in range(256)],
            "tokenizer.ggml.merges": [b"h e", b"l l"], "tokenizer.ggml.pre": pre,
            "tokenizer.ggml.token_type": np.ones(256, np.int32)}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        mine = bpe.bpe_vocab_from_gguf(meta)
        theirs = jbpe.bpe_vocab_from_gguf(meta)
    assert sum("unknown tokenizer.ggml.pre" in str(w.message) for w in seen) == 2
    assert mine.pattern == theirs.pattern == "gpt2"
    assert mine.encode("hello 1234 it's") == theirs.encode("hello 1234 it's")


def _llama3_style_vocab():
    b2u = bpe.bytes_to_unicode()
    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>"]
    return bpe.BPEVocab(tokens=specials + [b2u[b] for b in range(256)], merges={},
                        bos_id=0, eos_id=1, pattern="llama-bpe",
                        special_ids=frozenset(range(len(specials))))


def test_stop_ids_and_chat_hint():
    v = _llama3_style_vocab()
    assert v.stop_ids == frozenset({1, 4}) and v.chat_template_hint == "llama3"
    ids = v.encode("<|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>")
    assert ids[0] == 2 and ids[-1] == 4 and v.decode(ids) == "user\n\nhi"
    plain = bpe.BPEVocab(tokens=["<s>", "</s>"] + [bpe.bytes_to_unicode()[b]
                                                   for b in range(256)],
                         merges={}, bos_id=0, eos_id=1)
    assert plain.chat_template_hint is None and plain.stop_ids == frozenset({1})


def test_engine_and_server_read_a_bpe_vocab():
    """The Engine stops on the vocab's stop ids and adds no leading space;
    the server's chat endpoint takes the vocab's llama3 template and its
    markup reaches the engine as control ids."""
    vocab = _llama3_style_vocab()
    cfg = MODEL_PRESETS["tiny"].replace(vocab_size=len(vocab), max_seq_len=128,
                                        dtype="float32", weight_dtype="float32")
    params = load_parameters(cfg, random_ggjt_tensors(cfg, seed=21), device="cpu")
    engine = Engine(cfg, params, vocab, slots=1, buckets=(32, 64, 128), device="cpu")
    assert engine._eos_ids == vocab.stop_ids
    captured = {}
    submit = engine.submit

    def spy(prompt, gen, job_id=None):
        captured["prompt"], captured["gen"] = prompt, gen
        return submit(prompt, gen, job_id=job_id)

    engine.submit = spy
    server = JobServer(engine, ServerConfig(host="127.0.0.1", port=0),
                       GenerateConfig(max_tokens=4, ctx_size=128, temp=0.0),
                       model_name="tiny-bpe")
    assert server.chat_template_default == "llama3"
    server.start_background()
    try:
        body = json.dumps({"messages": [{"role": "user", "content": "hi"}]}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/v1/chat/completions",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["choices"][0]["message"]["role"] == "assistant"
    finally:
        server.shutdown()
    assert captured["prompt"].startswith("<|start_header_id|>user")
    assert captured["gen"].stop_at_eos
    ids = tokenize(vocab, captured["prompt"], bos=True)
    assert ids[:2] == [vocab.bos_id, vocab.token_to_id["<|start_header_id|>"]]
    job = engine.submit("hi", GenerateConfig(max_tokens=5, ctx_size=128, temp=0.0))
    while job.status in (JobStatus.QUEUED, JobStatus.PROCESSING):
        engine.step()
    assert job.status == JobStatus.FINISHED and job.prompt_tokens == 3  # bos, h, i
