"""Byte-level BPE tokenizer (GPT-2 family: LLaMA-3 GGUF and HF models).

The port's own copy of the JAX package's `tokenizer_bpe.py`: text is split
by a pre-tokenizer pattern, each pre-token is mapped through GPT-2's
printable-byte bijection, and adjacent pieces merge by lowest merge rank
(training order) rather than by vocab score. It gives the JAX package's ids.

Pre-tokenizer patterns:
  * gpt2      — the original GPT-2 split (also HF ByteLevel's default)
  * llama-bpe — LLaMA-3's variant (case-insensitive contractions,
                1-3 digit number groups, newline handling)

The JAX package compiles these with the `regex` module (for \\p{L} and
\\p{N}). Here one hand-written scanner per named pattern does the same
split (`split_gpt2`, `split_llama3`): `\\p{L}` and `\\p{N}` are the
letter and number categories of `unicodedata`, `\\s` is the Unicode
White_Space set that `regex` uses (`WHITESPACE`: not U+001C-001F, which
`str.isspace` takes), `(?i:...)` folds simply (`'ſ` is `'s`). The
scanners are the only path for those names and for a raw pattern equal to
one of them, as LLaMA-3's tokenizer.json carries; any other raw pattern
imports `regex` when the vocab is built. A character that the
interpreter's Unicode database leaves unassigned is neither letter nor
number here, whatever newer database `regex` carries.

`tokenizer.tokenize`/`detokenize` dispatch on the vocab type. BPE vocabs
carry their own bos/eos ids and want no leading-space normalization
(`space_prefix = False`).
"""

from __future__ import annotations

import functools
import unicodedata
from dataclasses import dataclass, field

GPT2_PATTERN = (
    r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
    r"""|\s+(?!\S)|\s+"""
)
LLAMA3_PATTERN = (
    r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"""
    r"""| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
)
PATTERNS = {"gpt2": GPT2_PATTERN, "llama-bpe": LLAMA3_PATTERN,
            "default": GPT2_PATTERN}
_GGUF_TOK_CONTROL = 3  # tokenizer.ggml.token_type control/special code

# `\s` of the `regex` module: the Unicode White_Space property
WHITESPACE = frozenset(map(chr, (0x9, 0xA, 0xB, 0xC, 0xD, 0x20, 0x85, 0xA0, 0x1680,
                                  *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                                  0x205F, 0x3000)))
_LETTER, _NUMBER, _SPACE, _OTHER = range(4)
# simple case folding of the contraction letters (`(?i:...)`)
_FOLD = {c: c.lower() for c in "STRVMLDE"} | {"ſ": "s"}


@functools.lru_cache(maxsize=65536)
def _cls(c: str) -> int:
    if c in WHITESPACE:
        return _SPACE
    cat = unicodedata.category(c)[0]
    return _LETTER if cat == "L" else _NUMBER if cat == "N" else _OTHER


def _run(classes: list[int], i: int, k: int) -> int:
    """End of the run of class k that starts at i."""
    n = len(classes)
    while i < n and classes[i] == k:
        i += 1
    return i


def _space_end(text: str, classes: list[int], i: int) -> int:
    """`\\s+(?!\\S)|\\s+` at a whitespace character i: the run, less its
    last character when a non-space follows and the run is longer than one."""
    e = _run(classes, i, _SPACE)
    return e - 1 if e < len(text) and e - i >= 2 else e


def split_gpt2(text: str) -> list[str]:
    """GPT2_PATTERN's matches, in order (regex.finditer's)."""
    classes = [_cls(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        c = text[i]
        if c == "'" and i + 1 < n and text[i + 1] in "sdmt":
            e = i + 2
        elif c == "'" and text[i + 1:i + 3] in ("ll", "ve", "re"):
            e = i + 3
        elif c == " " and i + 1 < n and classes[i + 1] != _SPACE:
            e = _run(classes, i + 1, classes[i + 1])
        elif classes[i] != _SPACE:
            e = _run(classes, i, classes[i])
        else:
            e = _space_end(text, classes, i)
        out.append(text[i:e])
        i = e
    return out


def split_llama3(text: str) -> list[str]:
    """LLAMA3_PATTERN's matches, in order (regex.finditer's)."""
    classes = [_cls(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        c, k = text[i], classes[i]
        nxt = _FOLD.get(text[i + 1], text[i + 1]) if i + 1 < n else ""
        if c == "'" and nxt in ("s", "t", "m", "d"):
            e = i + 2
        elif c == "'" and nxt in ("r", "v", "l") and i + 2 < n and \
                _FOLD.get(text[i + 2], text[i + 2]) == {"r": "e", "v": "e", "l": "l"}[nxt]:
            e = i + 3
        elif k not in (_LETTER, _NUMBER) and c not in "\r\n" and i + 1 < n \
                and classes[i + 1] == _LETTER:
            e = _run(classes, i + 1, _LETTER)
        elif k == _LETTER:
            e = _run(classes, i, _LETTER)
        elif k == _NUMBER:
            e = min(_run(classes, i, _NUMBER), i + 3)
        elif k == _OTHER or (c == " " and i + 1 < n and classes[i + 1] == _OTHER):
            e = _run(classes, i + (k != _OTHER), _OTHER)
            while e < n and text[e] in "\r\n":
                e += 1
        else:
            run = _run(classes, i, _SPACE)
            last = max(text.rfind("\r", i, run), text.rfind("\n", i, run))
            e = last + 1 if last >= 0 else _space_end(text, classes, i)
        out.append(text[i:e])
        i = e
    return out


_SCANNERS = {"gpt2": split_gpt2, "default": split_gpt2, "llama-bpe": split_llama3,
             GPT2_PATTERN: split_gpt2, LLAMA3_PATTERN: split_llama3}


def pre_tokenizer(pattern: str):
    """text -> pre-tokens for a pattern name or a raw pattern: the scanner
    where there is one, else `regex` on the raw pattern."""
    scanner = _SCANNERS.get(pattern)
    if scanner is not None:
        return scanner
    import regex

    compiled = regex.compile(pattern)
    return lambda text: [m.group() for m in compiled.finditer(text)]


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's bijection from bytes to printable unicode chars (so BPE
    vocab files stay readable): printable latin-1 maps to itself, the
    rest to 256+n."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


@dataclass
class BPEVocab:
    """tokens[i] = piece string in byte-unicode space; merges rank pairs
    by training order (lower = earlier = higher priority)."""

    tokens: list[str]
    merges: dict[tuple[str, str], int]
    bos_id: int = 0
    eos_id: int = 1
    pattern: str = "gpt2"
    # ids of control/special tokens (<|begin_of_text|> etc.) — skipped by
    # decode so stop_at_eos generations don't render markup into text
    special_ids: frozenset = frozenset()
    space_prefix = False  # no SP leading-space normalization (engine)

    token_to_id: dict[str, int] = field(init=False)

    def __post_init__(self) -> None:
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        # a known pattern NAME, or a raw pattern (HF tokenizer.json carries
        # the split pattern verbatim)
        self._split = pre_tokenizer(self.pattern)
        # special-token pre-split: markup like <|start_header_id|> maps to
        # its single control id, never through byte-BPE. At each position
        # the longest special that matches wins, leftmost first: the JAX
        # package's alternation sorted by length. Specials are ASCII, so
        # their text is the same in byte-unicode space.
        self._specials = frozenset(self.tokens[i] for i in self.special_ids
                                   if 0 <= i < len(self.tokens) and self.tokens[i])
        self._special_lens = sorted({len(p) for p in self._specials}, reverse=True)
        self._special_heads = frozenset(p[0] for p in self._specials)
        # ids that END a generation: eos plus the end-of-turn controls of
        # instruct fine-tunes (LLaMA-3's <|eot_id|>/<|eom_id|>); decode()
        # skips control tokens, so the engine stops on the ids instead
        self.stop_ids = frozenset(
            {self.eos_id}
            | {self.token_to_id[n]
               for n in ("<|eot_id|>", "<|eom_id|>", "<|end_of_text|>")
               if n in self.token_to_id})

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def chat_template_hint(self) -> str | None:
        """Template family implied by the vocab's control tokens."""
        if "<|start_header_id|>" in self.token_to_id:
            return "llama3"
        return None

    def _bpe(self, pieces: list[str]) -> list[str]:
        while len(pieces) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(pieces) - 1):
                r = self.merges.get((pieces[i], pieces[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            pieces = (pieces[:best_i]
                      + [pieces[best_i] + pieces[best_i + 1]]
                      + pieces[best_i + 2:])
        return pieces

    def _special_at(self, text: str, i: int) -> str | None:
        if text[i] not in self._special_heads:
            return None
        for n in self._special_lens:
            if text[i:i + n] in self._specials:
                return text[i:i + n]
        return None

    def encode(self, text: str, bos: bool = False) -> list[int]:
        ids: list[int] = [self.bos_id] if bos else []
        start = i = 0
        while self._specials and i < len(text):
            special = self._special_at(text, i)
            if special is None:
                i += 1
                continue
            self._encode_plain(text[start:i], ids)
            ids.append(self.token_to_id[special])
            start = i = i + len(special)
        self._encode_plain(text[start:], ids)
        return ids

    def _encode_plain(self, text: str, ids: list[int]) -> None:
        """Byte-level BPE of special-free text, appended to `ids`."""
        if not text:
            return
        b2u = bytes_to_unicode()
        for pre in self._split(text):
            mapped = "".join(b2u[b] for b in pre.encode("utf-8"))
            for piece in self._bpe(list(mapped)):
                tid = self.token_to_id.get(piece)
                if tid is not None:
                    ids.append(tid)
                else:  # unmergeable piece: emit per-char byte tokens
                    ids.extend(self.token_to_id[c] for c in piece
                               if c in self.token_to_id)

    def decode(self, ids: list[int]) -> str:
        u2b = unicode_to_bytes()
        # special tokens are markup, not text
        chars = "".join(self.tokens[i] for i in ids
                        if 0 <= i < len(self.tokens)
                        and i not in self.special_ids)
        data = bytes(u2b[c] for c in chars if c in u2b)
        return data.decode("utf-8", "replace")

    @property
    def tokens_scored(self) -> list[tuple[bytes, float]]:
        """(piece bytes, score) pairs, the scored-vocab surface."""
        return [(t.encode(), 0.0) for t in self.tokens]


def bpe_vocab_from_tokenizer_json(path: str, bos_id: int, eos_id: int) -> BPEVocab:
    """Build from an HF tokenizer.json (BPE model — the LLaMA-3 family
    ships these instead of sentencepiece tokenizer.model files). The
    pre-tokenizer's split pattern is lifted verbatim when present."""
    import json

    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    model = data.get("model", {})
    if model.get("type") != "BPE":
        raise ValueError(f"{path}: tokenizer.json model type "
                         f"{model.get('type')!r} is not BPE")
    vocab_map = model["vocab"]
    size = max(vocab_map.values()) + 1
    for extra in data.get("added_tokens", []):
        size = max(size, int(extra["id"]) + 1)
    tokens = [""] * size
    for piece, idx in vocab_map.items():
        tokens[idx] = piece
    specials = set()
    for extra in data.get("added_tokens", []):
        tokens[int(extra["id"])] = extra["content"]
        if extra.get("special"):
            specials.add(int(extra["id"]))
    ranks = {}
    for rank, m in enumerate(model.get("merges", [])):
        pair = tuple(m) if isinstance(m, list) else tuple(m.split(" "))
        ranks[pair] = rank

    pattern = "gpt2"
    pre = data.get("pre_tokenizer") or {}
    for p in pre.get("pretokenizers", [pre]):
        pat = (p or {}).get("pattern", {})
        if isinstance(pat, dict) and "Regex" in pat:
            pattern = pat["Regex"]
            break
    return BPEVocab(tokens=tokens, merges=ranks, bos_id=bos_id,
                    eos_id=eos_id, pattern=pattern,
                    special_ids=frozenset(specials | {bos_id, eos_id}))


def bpe_vocab_from_gguf(meta: dict) -> BPEVocab:
    """Build from GGUF metadata: tokenizer.ggml.{tokens,merges,pre,
    bos_token_id,eos_token_id,token_type}. An unknown `pre` name warns and
    takes the gpt2 pattern."""
    import numpy as np

    tokens = [t.decode("utf-8", "replace") if isinstance(t, bytes) else str(t)
              for t in meta.get("tokenizer.ggml.tokens", [])]
    merges = {}
    for rank, m in enumerate(meta.get("tokenizer.ggml.merges", [])):
        s = m.decode("utf-8", "replace") if isinstance(m, bytes) else str(m)
        left, _, right = s.partition(" ")
        merges[(left, right)] = rank
    pre = meta.get("tokenizer.ggml.pre", b"gpt2")
    pre = pre.decode() if isinstance(pre, bytes) else str(pre)
    if pre not in PATTERNS and "\\p{" not in pre:
        import warnings

        warnings.warn(
            f"unknown tokenizer.ggml.pre={pre!r}; falling back to the "
            "gpt2 pre-tokenizer — token boundaries may differ from the "
            "model's training tokenizer", stacklevel=2)
        pre = "gpt2"
    types = meta.get("tokenizer.ggml.token_type", np.array([], np.int32))
    specials = {i for i, t in enumerate(np.asarray(types).tolist())
                if t == _GGUF_TOK_CONTROL}
    bos_id = int(meta.get("tokenizer.ggml.bos_token_id", 0))
    eos_id = int(meta.get("tokenizer.ggml.eos_token_id", 1))
    return BPEVocab(tokens=tokens, merges=merges, bos_id=bos_id, eos_id=eos_id,
                    pattern=pre, special_ids=frozenset(specials | {bos_id, eos_id}))
