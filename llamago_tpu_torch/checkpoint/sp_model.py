"""Minimal pure-Python reader and writer of SentencePiece `tokenizer.model`
files: the port's own copy of the JAX package's `checkpoint/sp_model.py`,
writing the same bytes.

No `sentencepiece` package is needed: the few protobuf
fields the converter needs (reference: scripts/convert-pth-to-ggml.py:120-137
uses piece text, score, and the is_unknown/is_control/is_byte flags) are
parsed directly from the protobuf wire format:

  ModelProto { repeated SentencePiece pieces = 1; ... }
  SentencePiece { optional string piece = 1; optional float score = 2;
                  optional Type type = 3; }
  Type: NORMAL=1 UNKNOWN=2 CONTROL=3 USER_DEFINED=4 UNUSED=5 BYTE=6
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


@dataclass
class SentencePiece:
    piece: str
    score: float
    type: int

    @property
    def is_unknown(self) -> bool:
        return self.type == UNKNOWN

    @property
    def is_control(self) -> bool:
        return self.type == CONTROL

    @property
    def is_byte(self) -> bool:
        return self.type == BYTE

    def byte_value(self) -> int:
        # byte pieces look like "<0x0A>"
        if len(self.piece) != 6 or not self.piece.startswith("<0x"):
            raise ValueError(f"invalid byte piece: {self.piece!r}")
        return int(self.piece[3:-1], 16)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:  # 64-bit
        pos += 8
    elif wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:  # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    return pos


def _parse_piece(buf: bytes) -> SentencePiece:
    piece, score, ptype = "", 0.0, NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            piece = buf[pos : pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:
            (score,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        elif field == 3 and wire == 0:
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wire)
    return SentencePiece(piece=piece, score=score, type=ptype)


def read_sp_model(path: str) -> list[SentencePiece]:
    with open(path, "rb") as f:
        buf = f.read()
    pieces: list[SentencePiece] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # pieces
            n, pos = _read_varint(buf, pos)
            pieces.append(_parse_piece(buf[pos : pos + n]))
            pos += n
        else:
            pos = _skip_field(buf, pos, wire)
    return pieces


def write_sp_model(path: str, pieces: list[SentencePiece]) -> None:
    """Emit a minimal tokenizer.model (pieces only: text, score, type)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b = v & 0x7F
            v >>= 7
            out += bytes([b | (0x80 if v else 0)])
            if not v:
                return out

    blob = b""
    for p in pieces:
        body = b""
        enc = p.piece.encode("utf-8")
        body += varint((1 << 3) | 2) + varint(len(enc)) + enc
        body += varint((2 << 3) | 5) + struct.pack("<f", p.score)
        body += varint((3 << 3) | 0) + varint(p.type)
        blob += varint((1 << 3) | 2) + varint(len(body)) + body
    with open(path, "wb") as f:
        f.write(blob)
