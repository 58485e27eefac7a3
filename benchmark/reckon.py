"""The work a forward needs, from the configuration and the shapes alone.

The frozen yardstick behind every roofline share and `mfu`: operations and
bytes of the model's own arithmetic, whatever kernel does it and however it
pads. A matmul of m rows by a [K, N] weight is 2 m K N operations and reads
the weight once in the configuration's format (Q8_0: 34 bytes a block of 32,
f16 scale included), reads x and writes the product in the compute dtype.
Rows are the ones the model needs: a decode step's active slots, a prefill
chunk's real tokens (not its bucket's padding), and the head only where a
logit is wanted (every decode row, one row a prefill chunk). Attention of t
queries from position p0 reads the cache's p0 + t keys and values once (an
int8 cache 1 byte a value plus a 4-byte scale a row), writes its t new rows,
reads q and writes the output; its operations are 4 * heads * head_dim for
each query-key pair, causal. One call of each kind runs per layer, so a
call's least time is the larger of its operations and its bytes against the
chip's peaks (peaks.py), summed over the calls.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.peaks import HBM_BYTES_PER_S, PEAK_FLOPS_PER_S
from benchmark.reference.dims import QK, Q8_BLOCK_BYTES, Dims

_DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
_WEIGHT_BYTES = {"q8_0": Q8_BLOCK_BYTES / QK}
_SCALE_BYTES = 4  # f32 scale of an int8 cache row


@dataclass(frozen=True)
class Work:
    flops: float = 0.0
    nbytes: float = 0.0
    least_s: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.flops + o.flops, self.nbytes + o.nbytes, self.least_s + o.least_s)

    def times(self, n: int) -> "Work":
        return Work(self.flops * n, self.nbytes * n, self.least_s * n)


def _call(d: Dims, flops: float, nbytes: float) -> Work:
    peak = PEAK_FLOPS_PER_S[d.compute]
    return Work(flops, nbytes, max(flops / peak, nbytes / HBM_BYTES_PER_S))


def matmul(d: Dims, m: int, k: int, n: int) -> Work:
    """One matmul call: m rows of x [m, k] times a [k, n] weight."""
    ab = _DTYPE_BYTES[d.compute]
    return _call(d, 2.0 * m * k * n, k * n * _WEIGHT_BYTES[d.weights] + (m * k + m * n) * ab)


def forward_matmuls(d: Dims, rows: int, head_rows: int) -> Work:
    """The matmuls of one forward over `rows` tokens, the head over `head_rows`."""
    if rows <= 0:
        return Work()
    w = Work()
    for out_dim, in_dim in d.layer_matrices().values():
        w = w + matmul(d, rows, in_dim, out_dim)
    w = w.times(d.n_layers)
    return w + (matmul(d, head_rows, d.dim, d.vocab) if head_rows > 0 else Work())


def attention(d: Dims, windows: list[tuple[int, int]]) -> Work:
    """One forward's attention: a window (t queries from position p0) a row,
    one call a layer over all the rows."""
    if not windows:
        return Work()
    ab = _DTYPE_BYTES[d.compute]
    if d.kv_cache == "int8":
        row_bytes = d.kv_width * 1 + d.n_kv_heads * _SCALE_BYTES  # one position, K or V
    else:
        row_bytes = d.kv_width * _DTYPE_BYTES[d.kv_cache]
    flops = nbytes = 0.0
    for t, p0 in windows:
        pairs = t * p0 + t * (t + 1) / 2  # keys seen by the t causal queries
        flops += 4.0 * d.n_heads * d.head_dim * pairs
        nbytes += 2 * (p0 + t) * row_bytes + 2 * t * row_bytes + 2 * t * d.q_width * ab
    return _call(d, flops, nbytes).times(d.n_layers)


def decode_forwards(d: Dims, positions: list[int], forwards: int) -> tuple[Work, Work]:
    """(matmuls, attention) of `forwards` decode steps of the active rows
    whose next cache positions are `positions` at the first step."""
    m, a = Work(), Work()
    for k in range(forwards):
        m = m + forward_matmuls(d, len(positions), len(positions))
        a = a + attention(d, [(1, p + k) for p in positions])
    return m, a


def prefill_chunk(d: Dims, tokens: int, write_pos: int) -> tuple[Work, Work]:
    """(matmuls, attention) of one prefill chunk of `tokens` real tokens
    written from position `write_pos`; its logits at one row."""
    return forward_matmuls(d, tokens, 1), attention(d, [(tokens, write_pos)])
