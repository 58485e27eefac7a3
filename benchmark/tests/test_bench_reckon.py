"""reckon.py against counts made by hand for the tiny configuration."""

import pytest

from benchmark import reckon
from benchmark.peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S
from benchmark.reference.dims import Dims

TINY = Dims(name="tiny", dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, ffn=128,
            vocab=512, rope_theta=1e4, norm_eps=1e-5, weights="q8_0", compute="bfloat16",
            kv_cache="bfloat16")

# per layer: wq 64x64, wk 32x64, wv 32x64, wo 64x64, w1 128x64, w2 64x128, w3 128x64
LAYER_PARAMS = 4096 + 2048 + 2048 + 4096 + 8192 + 8192 + 8192
HEAD_PARAMS = 64 * 512
LAYER_IN_PLUS_OUT = 128 + 96 + 96 + 128 + 192 + 192 + 192


def test_matmul_params():
    assert TINY.matmul_params() == 2 * LAYER_PARAMS + HEAD_PARAMS == 106496


def test_forward_matmuls_by_hand():
    w = reckon.forward_matmuls(TINY, rows=3, head_rows=3)
    assert w.flops == 2 * 3 * 106496
    weights = 106496 * 34 / 32  # Q8_0: 34 bytes a block of 32
    acts = 2 * (3 * LAYER_IN_PLUS_OUT * 2) + 3 * (64 + 512) * 2  # bf16 x in, product out
    assert w.nbytes == pytest.approx(weights + acts)
    # every call is bound by its bytes at these sizes
    assert w.least_s == pytest.approx(w.nbytes / HBM_BYTES_PER_S)


def test_prefill_head_is_one_row():
    m, _ = reckon.prefill_chunk(TINY, tokens=5, write_pos=0)
    full = reckon.forward_matmuls(TINY, 5, 5)
    assert full.flops - m.flops == 2 * 4 * HEAD_PARAMS


def test_attention_by_hand():
    a = reckon.attention(TINY, [(1, 9)])  # one decode row at position 9: 10 keys
    assert a.flops == 2 * 4 * 4 * 16 * 10
    row = 32 * 2  # one position of K or V in bf16
    assert a.nbytes == 2 * (2 * 10 * row + 2 * row + 2 * 64 * 2)
    q = reckon.attention(Dims(**{**TINY.__dict__, "kv_cache": "int8"}), [(1, 9)])
    row8 = 32 + 2 * 4  # int8 values and a 4-byte scale for each of 2 heads
    assert q.nbytes == 2 * (2 * 10 * row8 + 2 * row8 + 2 * 64 * 2)
    p = reckon.attention(TINY, [(4, 2)])  # 4 causal queries after 2 cached rows
    assert p.flops == 2 * 4 * 4 * 16 * (4 * 2 + 10)


def test_decode_forwards_advance_positions():
    m, a = reckon.decode_forwards(TINY, [5, 9], forwards=3)
    assert m.flops == 3 * 2 * 2 * 106496
    assert a.flops == reckon.attention(TINY, [(1, 5), (1, 9)]).flops + reckon.attention(
        TINY, [(1, 6), (1, 10)]).flops + reckon.attention(TINY, [(1, 7), (1, 11)]).flops


def test_a_large_matmul_is_bound_by_operations():
    w = reckon.matmul(TINY, 4096, 4096, 4096)
    assert w.least_s == pytest.approx(w.flops / BF16_FLOPS_PER_S)
