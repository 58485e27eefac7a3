"""SentencePiece-BPE tokenizer (greedy score-priority bigram merge).

The port's own copy of the JAX package's `tokenizer.py` (behavioral parity
with the reference tokenizer, pkg/ml/ml.go:2648-2848):

  * the text is split into UTF-8 characters via a high-nibble length
    table (ml.go:2705-2709);
  * all adjacent pairs seed a max-priority queue keyed by the merged
    token's vocab score, ties broken toward the smaller left index;
  * pairs are merged greedily while any merge is possible;
  * symbols that never formed a vocab token fall back to byte tokens
    with id = byte + 3 (no wrap for bytes 253..255);
  * BOS=1 / EOS=2, newline = token 13.

Byte-level BPE vocabs (tokenizer_bpe.BPEVocab, the LLaMA-3 family) carry
their own encoder and decoder; `tokenize` and `detokenize` dispatch to
them.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

BOS_TOKEN = 1
EOS_TOKEN = 2
NEWLINE_TOKEN = 13

_UTF8_LEN = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4)


def utf8_len(lead_byte: int) -> int:
    return _UTF8_LEN[lead_byte >> 4]


@dataclass
class Vocab:
    """Scored vocabulary: tokens[i] = (piece_bytes, score)."""

    tokens: list[tuple[bytes, float]]
    token_to_id: dict[bytes, int] = field(init=False)

    def __post_init__(self) -> None:
        # later duplicate pieces win (reference: llama.go:805-810)
        self.token_to_id = {t: i for i, (t, _) in enumerate(self.tokens)}

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def size(self) -> int:
        return len(self.tokens)

    def id_to_piece(self, token_id: int) -> bytes:
        if 0 <= token_id < len(self.tokens):
            return self.tokens[token_id][0]
        return b""

    def score(self, token_id: int) -> float:
        return self.tokens[token_id][1]


def tokenize(vocab: Vocab, text: str | bytes, bos: bool = False) -> list[int]:
    """Greedy score-priority BPE (reference: Tokenize, ml.go:2761-2848).
    Byte-level BPE vocabs dispatch to their own encoder."""
    if hasattr(vocab, "encode"):
        if isinstance(text, bytes):
            text = text.decode("utf-8", "replace")
        return vocab.encode(text, bos=bos)
    data = text.encode("utf-8") if isinstance(text, str) else text
    output: list[int] = []
    if bos:
        output.append(BOS_TOKEN)
    if not data:
        return output

    starts: list[int] = []
    lengths: list[int] = []
    offs = 0
    while offs < len(data):
        n = min(len(data) - offs, utf8_len(data[offs]))
        starts.append(offs)
        lengths.append(n)
        offs += n
    count = len(starts)
    prev = list(range(-1, count - 1))
    nxt = [i + 1 for i in range(count)]
    nxt[count - 1] = -1

    # (-score, left, right, size): higher score first, then smaller left
    queue: list[tuple[float, int, int, int]] = []

    def try_add_bigram(left: int, right: int) -> None:
        if left == -1 or right == -1:
            return
        merged = data[starts[left]: starts[left] + lengths[left] + lengths[right]]
        tid = vocab.token_to_id.get(merged)
        if tid is None:
            return
        heapq.heappush(queue, (-vocab.score(tid), left, right, len(merged)))

    for i in range(1, count):
        try_add_bigram(i - 1, i)

    while queue:
        _, left, right, size = heapq.heappop(queue)
        if lengths[left] == 0 or lengths[right] == 0 or lengths[left] + lengths[right] != size:
            continue  # stale entry
        lengths[left] += lengths[right]
        lengths[right] = 0
        nxt[left] = nxt[right]
        if nxt[right] >= 0:
            prev[nxt[right]] = left
        try_add_bigram(prev[left], left)
        try_add_bigram(left, nxt[left])

    i = 0
    while i != -1:
        piece = data[starts[i]: starts[i] + lengths[i]]
        tid = vocab.token_to_id.get(piece)
        if tid is None:
            output.extend(b + 3 for b in piece)
        else:
            output.append(tid)
        i = nxt[i]
    return output


def detokenize(vocab: Vocab, token_ids: list[int]) -> str:
    """Concatenate raw pieces (reference: Token2Str in server.go:228-236);
    byte-level BPE vocabs decode themselves."""
    if hasattr(vocab, "decode"):
        return vocab.decode(token_ids)
    return b"".join(vocab.id_to_piece(t) for t in token_ids).decode("utf-8", errors="replace")
