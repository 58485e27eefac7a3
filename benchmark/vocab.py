"""The benchmark's tokenizer: a byte vocabulary padded to the published size.

Ids 0-2 are <unk>, BOS and EOS; id b + 3 is the byte b; every id above 258
is a filler piece of its own ("<t259>", ...), which no prompt's text can
form, so a prompt is one token a byte. Sampling and the head still run over
all `vocab_size` ids; a sampled filler renders as its piece's text.
"""

from __future__ import annotations


def byte_pieces(vocab_size: int) -> list[tuple[bytes, float]]:
    """(piece, score) for every id, in id order."""
    pieces = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    pieces += [(bytes([b]), 0.0) for b in range(256)]
    pieces += [(f"<t{i}>".encode(), 0.0) for i in range(len(pieces), vocab_size)]
    return pieces
