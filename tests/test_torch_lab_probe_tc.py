"""L11's probes on the float rows' tensor-core decode form: decode_only,
decode_bitcast and dma_only as probe modes of `lab_decode_tc`, against
their plain versions on the CPU.

On the card the three probes run `lab_decode_tc` in modes kFDecodeOnly,
kFDecodeBitcast and kFDmaOnly (`csrc/lab_matmul.cu`, `ops/lab_kernels.py:
probe`): the Q4_0 weight rows (and, but for dma_only, the scale rows)
arrive by the decode form's bulk copies into its ring, no x is staged or
counted, K is split into one wave of blocks (`probe_plan`), each split
writes one row of column sums and `lab_reduce_cols` adds the splits in a
fixed order into every row of the output. decode_only sums the form's own exact
nib - 8 A fragments against a B of bf16 ones (two k16 mma a quant block,
an exact integer block sum that the column's scale folds into the f32 sum);
dma_only adds each lane's bytes exactly in 16-bit lanes, flushed to 32 bits
every 64 blocks; decode_bitcast keeps its lossy chain, one rounding an
operation, on the CUDA cores. Here, without a card, the tests pin the plan
and the entry point's arguments, the modes and the ring in the source, and
numpy emulations of each probe's lanes against `probe_plain`.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from llamago_tpu_torch import kernel_lab as lab
from llamago_tpu_torch.ops import kernels
from llamago_tpu_torch.ops import lab_kernels as lk
from llamago_tpu_torch.ops.quant import unpack_q4

from test_torch_k1_decode_tc import GID, TIG, _mma, _q4_pair

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.__file__).parents[1] / "csrc"
# x K * 8 * max|s|, as chip_smoke's LAB_PROBE_TOL: the order of the f32
# sums; the byte sums are exact
PROBE_TOL = 1e-5
PROBES = ("decode_only", "decode_bitcast", "dma_only")
ONES = np.full(32, 0x3F803F80, np.uint32)


def _src(name="lab_matmul.cu") -> str:
    return (CSRC / name).read_text()


def _q4_leaf(k: int, n: int, seed: int, full: bool = False) -> dict:
    """Random Q4_0 bytes (every byte 255 with `full`) and positive bf16
    scales."""
    rng = np.random.default_rng(seed)
    q4 = (np.full((k // 2, n), 255, np.uint8) if full
          else rng.integers(0, 256, (k // 2, n), dtype=np.uint8))
    s = torch.from_numpy((rng.random((k // 32, n)) * 0.02 + 1e-3).astype(np.float32))
    return {"q4": torch.from_numpy(q4), "s": s.to(torch.bfloat16)}


def _scale(leaf: dict, k: int) -> float:
    return k * 8 * leaf["s"].float().abs().max().item()


# ------------------------------------------------------------------ the plan

@pytest.mark.parametrize("k,n", [(8192, 7168), (4096, 4096), (11008, 4096), (512, 512),
                                 (65536, 7168), (32, 16), (1376, 272)])
def test_probe_plan_splits_k_into_one_wave(k, n):
    """As `lab_plan` splits the nibble modes for one group of 8 rows: one
    wave of three blocks an SM of 512 columns, at least 4 quant blocks a
    split where K allows, none empty."""
    ksplit, per = lk.probe_plan(k, n)
    nb = k // 32
    assert ksplit * per >= nb > (ksplit - 1) * per
    blocks = -(-n // 512)
    assert blocks * ksplit <= max(3 * 132, blocks)
    assert per >= min(4, nb) or ksplit == 1
    assert ksplit == lk.lab_plan(8, k, n, lk._F_Q4_BF16)[0]


def test_probe_plan_at_the_labs_shape_and_where_a_split_crosses_a_flush():
    """K = 8192, N = 7168: 26 splits of 10 quant blocks (364 blocks). At K =
    65536 a split holds 74 blocks: dma_only's 16-bit lanes are flushed
    inside it."""
    assert lk.probe_plan(8192, 7168) == (26, 10)
    assert lk.probe_plan(65536, 7168)[1] > 64


class _FakeLib:
    def __init__(self):
        self.calls = []

    def llamago_lab_probe(self, q, s, out, ws, tm, k, n, mode, rows, ksplit, stream):
        self.calls.append(dict(tm=tm, k=k, n=n, mode=mode, rows=rows, ksplit=ksplit))
        return 0


@pytest.mark.parametrize("tm", [8, 16])
def test_probe_hands_the_entry_point_the_decode_forms_split(monkeypatch, tm):
    """On meta tensors: the three probe modes hand the entry point their
    code (0-2), rows = 32 * the plan's quant blocks a split and its ksplit;
    dma_pure keeps one block a k-tile; each call counts one launch."""
    fake = _FakeLib()
    monkeypatch.setattr(lk, "_lib", lambda: fake)
    monkeypatch.setattr(lk, "_cuda_or_raise", lambda x, what: None)
    monkeypatch.setattr(lk, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(lk, "_stream", lambda x: 0)
    monkeypatch.setattr(lk.probe, "launches", 0)
    meta = torch.device("meta")
    k, n, tk = 8192, 7168, 1024
    x = torch.empty((tm, k), dtype=torch.bfloat16, device=meta)
    leaf = {"q4": torch.empty((k // 2, n), dtype=torch.uint8, device=meta),
            "s": torch.empty((k // 32, n), dtype=torch.bfloat16, device=meta)}
    for kind in lk.PROBES:
        assert lk.probe(kind, x, leaf, tk).shape == (tm, n)
    ksplit, per = lk.probe_plan(k, n)
    want = [dict(tm=tm, k=k, n=n, mode=i, rows=32 * per, ksplit=ksplit) for i in range(3)]
    want.append(dict(tm=tm, k=k, n=n, mode=3, rows=tk, ksplit=k // tk))
    assert fake.calls == want and lk.probe.launches == 4


# --------------------------------------------------------------- the source

def test_the_probes_are_modes_of_the_decode_form():
    """Codes 0-2 launch lab_decode_tc in its probe modes, code 3 the
    untouched dma_pure kernel; the old CUDA-core probe kernel is gone."""
    src = _src()
    assert "constexpr int kFDecodeOnly = 5, kFDecodeBitcast = 6, kFDmaOnly = 7;" in src
    assert "constexpr int kPDecode = 0, kPDecodeBitcast = 1, kPDmaOnly = 2, kPDmaPure = 3;" in src
    entry = src.split('extern "C" int llamago_lab_probe(')[1]
    for code, mode in (("kPDecode", "kFDecodeOnly"), ("kPDecodeBitcast", "kFDecodeBitcast"),
                       ("kPDmaOnly", "kFDmaOnly")):
        assert re.search(rf"case {code}:\s*return launch_probe_tc<{mode}>\(", entry), code
    assert "lab_probe_dma_pure<<<grid, kThreads, 0, st>>>(qp, w, N, rows / 2);" in entry
    assert "lab_probe<" not in src and "nibble_minus_8" not in src and "__ldg(" not in src
    launch = src.split("cudaError_t launch_probe_tc(")[1].split("\n}\n")[0]
    assert "lab_reduce_cols<<<(N + 31) / 32, 256, 0, st>>>(ws, out, tm, N, ksplit);" in launch
    assert "const dim3 grid((N + kDtBlockCols - 1) / kDtBlockCols, ksplit);" in launch
    # the reduce: warp g adds splits g, g + 8, ..., then the 8 warps' sums
    assert "for (int y = g; y < ksplit; y += 8) a += ws[(size_t)y * N + n];" in src
    assert "for (int j = 0; j < 8; ++j) t += part[j][c];" in src


def test_the_ring_holds_no_x_and_dma_only_no_scales():
    """The probe modes copy no x (stage_tx counts none), dma_only no scales;
    the stage of decode_only and decode_bitcast is 16 packed rows 528 bytes
    apart and the 512 bf16 scales, four stages a block, three blocks an SM."""
    src = _src()
    assert "return lt_probe<MODE>() ? 0 : 8 * kDtXLd;" in src
    assert "return MODE != kFW16 && MODE != kFDmaOnly;" in src
    assert "ROWS * width * CB + (PROBE ? 0 : 8 * 64) + (lt_scales<MODE>() ? 2 * width : 0);" in src
    assert "} else if (!PROBE && tid >= 32 && tid < 40) {" in src
    stage = 16 * 528 + 1024
    assert 3 * (4 * (stage + 8) + 1024) <= 233472


def test_decode_only_takes_the_forms_a_fragments_against_ones():
    src = _src()
    assert "xb[j] = 0x3F803F80u;" in src
    assert "if constexpr (MODE == kFI4 || MODE == kFDecodeOnly) {" in src  # the scale fold
    # the centred pairs: not the RAW nibbles of split_bf16_h
    assert "constexpr bool RAW = MODE == kFQ4Bf16Fma;" in src


def test_dma_only_flushes_its_16_bit_lanes_in_time():
    """A lane adds 4 rows of at most 255 a block: 64 blocks fit a 16-bit
    lane, 65 would not."""
    assert "if ((it & 63) == 63) flush();" in _src()
    assert 64 * 4 * 255 < 2**16 <= 65 * 4 * 255


def test_probe_rates_and_bounds():
    """decode_only runs on the bf16 tensor cores, decode_bitcast's chain in
    f32; the bytes bound every probe."""
    assert lab.VARIANTS["decode_only"].rate == "bf16"
    assert lab.VARIANTS["decode_bitcast"].rate == "f32"
    assert lab.VARIANTS["dma_only"].rate is None
    for name in PROBES:
        assert lab.variant_bound(name, 8192, 7168, 8, 1024)[1] == "bytes"


# ------------------------------------------------------ the lanes, emulated

def _lane_rows(q4: np.ndarray, kb: int) -> list:
    """The four packed rows of quant block kb that the lanes of each tig
    read, [4 tig, N] each, as the decode form reads them: rows 2 tig,
    2 tig + 1, 8 + 2 tig, 9 + 2 tig of the block's 16."""
    tig = np.arange(4)
    return [q4[kb * 16 + 8 * (r >> 1) + 2 * tig + (r & 1)] for r in range(4)]


def _splits(nb: int, ksplit: int, per: int):
    return [range(y * per, min((y + 1) * per, nb)) for y in range(ksplit)]


def _reduce_cols(parts: list) -> np.ndarray:
    """lab_reduce_cols in f32: warp g adds the splits g, g + 8, ... in
    order from 0, then the 8 warps' sums are added in order from 0."""
    warps = []
    for g in range(8):
        a = np.zeros_like(parts[0])
        for p in parts[g::8]:
            a = (a + p).astype(np.float32)
        warps.append(a)
    t = np.zeros_like(parts[0])
    for a in warps:
        t = (t + a).astype(np.float32)
    return t


def emulate_decode_only_block(q4: np.ndarray, kb: int, n0: int) -> np.ndarray:
    """One warp's columns n0 .. n0 + 127 of quant block kb: each lane's
    16-byte reads, the decode form's nib - 8 A pairs (bit for bit), B = bf16
    ones, two k16 mma a tile into a zeroed sum. Returns the C fragments'
    column sums [128] (every slot the same)."""
    cols = n0 + 16 * GID[:, None] + np.arange(16)[None]
    rows = [kb * 16 + 8 * (r >> 1) + 2 * TIG + (r & 1) for r in range(4)]
    w = [np.ascontiguousarray(q4[row[:, None], cols]).view(np.uint32)
         for row in rows]  # [32 lanes, 4 words] each
    out = np.zeros(128, np.float32)
    for t in range(8):
        i, j = t >> 2, t & 3
        part = np.zeros((32, 4), np.float32)
        for step in range(2):
            sh = 4 * step
            a = [_q4_pair(j, sh, w[0][:, i], w[1][:, i]),
                 _q4_pair(j, sh, w[0][:, i + 2], w[1][:, i + 2]),
                 _q4_pair(j, sh, w[2][:, i], w[3][:, i]),
                 _q4_pair(j, sh, w[2][:, i + 2], w[3][:, i + 2])]
            _mma(part, a, ONES, ONES)
        # every slot the same: c0 and c1 (column n+t), c2 and c3 (n+8+t)
        assert (part[:, 0] == part[:, 1]).all() and (part[:, 2] == part[:, 3]).all()
        assert (part[:, 0] == part[4 * GID, 0]).all()  # the four lanes of a gid agree
        out[16 * GID + t] = part[:, 0]
        out[16 * GID + 8 + t] = part[:, 2]
    return out


def test_decode_only_lanes_give_exact_integer_block_sums():
    """Every lane's A pairs against ones give each column's sum of nib - 8
    over the block's 32 rows exactly, for every byte value."""
    rng = np.random.default_rng(3)
    q4 = rng.integers(0, 256, (32, 128), dtype=np.uint8)
    q4[:16, :4] = 0, 255, 0x0F, 0xF0
    want = (unpack_q4(torch.from_numpy(q4)).numpy().astype(np.int64)
            .reshape(2, 32, 128).sum(1))
    for kb in range(2):
        assert np.array_equal(emulate_decode_only_block(q4, kb, 0), want[kb].astype(np.float32))


def emulate_decode_only(leaf: dict, ksplit: int, per: int) -> np.ndarray:
    """decode_only [N]: per split, each block's exact integer column sum
    folded by fmaf(scale, sum, acc), then lab_reduce_cols."""
    q4, s = leaf["q4"].numpy(), leaf["s"].float().numpy()
    k = 2 * q4.shape[0]
    blocks = (unpack_q4(leaf["q4"]).numpy().astype(np.int64)
              .reshape(k // 32, 32, -1).sum(1).astype(np.float32))
    parts = []
    for split in _splits(k // 32, ksplit, per):
        acc = np.zeros(q4.shape[1], np.float32)
        for kb in split:
            acc = (s[kb].astype(np.float64) * blocks[kb] + acc).astype(np.float32)
        parts.append(acc)
    return _reduce_cols(parts)


def emulate_dma_only(leaf: dict, ksplit: int, per: int) -> np.ndarray:
    """dma_only [N] lane by lane: each lane's four rows of a block added into
    16-bit lanes (even and odd bytes of a word), checked never to carry,
    flushed to 32 bits when the split's block index ends in 63 and at its
    end, the four lanes of a gid added, lab_reduce_cols over the splits."""
    q4 = leaf["q4"].numpy().astype(np.uint32)
    nb, n = q4.shape[0] // 16, q4.shape[1]
    parts = []
    for split in _splits(nb, ksplit, per):
        tot = np.zeros((4, n), np.uint64)
        lanes = np.zeros((4, n), np.uint32)  # a 16-bit lane a column and tig
        for it, kb in enumerate(split):
            rows = np.stack(_lane_rows(q4, kb))  # [4 rows r, 4 tig, n]
            lanes += rows.sum(0)
            assert lanes.max() < 2**16
            if (it & 63) == 63:
                tot += lanes
                lanes[:] = 0
        tot += lanes
        parts.append(tot.sum(0).astype(np.float32))
    return _reduce_cols(parts)


def _bitcast_bytes(q4: np.ndarray, s: np.ndarray, kb: int) -> np.ndarray:
    """The chain of every byte of block kb [16 rows, N] in f32, one rounding
    an operation: ((f_lo * s + bias) + f_hi * s) + bias, f = 2^23 + nib,
    bias = fl(-(2^23 + 8) * s)."""
    b = q4[kb * 16:(kb + 1) * 16].astype(np.uint32)
    f_lo = ((b & 0xF) | 0x4B000000).view(np.float32)
    f_hi = (((b >> 4) & 0xF) | 0x4B000000).view(np.float32)
    sc = s[kb][None]
    bias = np.float32(-(8388608.0 + 8.0)) * sc
    return ((f_lo * sc + bias) + f_hi * sc) + bias


def emulate_decode_bitcast(leaf: dict, ksplit: int, per: int) -> np.ndarray:
    """decode_bitcast [N]: each lane's four rows of a block in order into
    its column sums, the four lanes of a gid by xor shuffles ((t0 + t1) +
    (t2 + t3)), lab_reduce_cols over the splits."""
    q4, s = leaf["q4"].numpy(), leaf["s"].float().numpy()
    parts = []
    for split in _splits(q4.shape[0] // 16, ksplit, per):
        lane = np.zeros((4, q4.shape[1]), np.float32)  # a column and tig
        for kb in split:
            t = _bitcast_bytes(q4, s, kb)
            for r in range(4):
                lane = (lane + t[8 * (r >> 1) + 2 * np.arange(4) + (r & 1)]).astype(np.float32)
        parts.append(((lane[0] + lane[1]) + (lane[2] + lane[3])).astype(np.float32))
    return _reduce_cols(parts)


EMULATE = {"decode_only": emulate_decode_only, "dma_only": emulate_dma_only,
           "decode_bitcast": emulate_decode_bitcast}


@pytest.mark.parametrize("kind", PROBES)
@pytest.mark.parametrize("k,n", [(8192, 512), (4096, 272), (1376, 16)])
def test_emulated_probes_match_plain(kind, k, n):
    """Each probe's lanes at its plan's split against `probe_plain`:
    dma_only bit for bit, the others within K * 8 * max|s| * 1e-5."""
    leaf = _q4_leaf(k, n, k + n)
    got = EMULATE[kind](leaf, *lk.probe_plan(k, n))
    want = lk.probe_plain(kind, leaf, 8, 1024 if k % 1024 == 0 else 32)[0].numpy()
    if kind == "dma_only":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=PROBE_TOL * _scale(leaf, k))


def test_dma_only_crosses_a_flush_bit_for_bit():
    """Every byte 255 and a split of 74 blocks (as K = 65536 at the lab's
    width splits): the lanes flush at block 63 and stay below 2^16; the
    sums equal the plain version's bit for bit."""
    k, n = 74 * 2 * 32, 16
    leaf = _q4_leaf(k, n, 1, full=True)
    got = emulate_dma_only(leaf, 2, 74)
    want = lk.probe_plain("dma_only", leaf, 8, 32)[0].numpy()
    assert np.array_equal(got, want) and want[0] == 255 * k // 2
    with pytest.raises(AssertionError):  # without the flush a 16-bit lane carries
        _no_flush(leaf)


def _no_flush(leaf):
    """dma_only's lanes over all of K with no flush."""
    q4 = leaf["q4"].numpy().astype(np.uint32)
    lanes = np.zeros((4, q4.shape[1]), np.uint32)
    for kb in range(q4.shape[0] // 16):
        lanes += np.stack(_lane_rows(q4, kb)).sum(0)
        assert lanes.max() < 2**16


def test_decode_bitcast_bytes_are_the_plain_chain_bit_for_bit():
    """The chain per byte, each operation rounded on its own, is the plain
    version's to the bit: only the order of the column sums differs."""
    k, n = 256, 64
    leaf = _q4_leaf(k, n, 5)
    q4, s = leaf["q4"].numpy(), leaf["s"].float().numpy()
    p = torch.from_numpy(q4.astype(np.int32)).reshape(k // 32, 16, n)
    f_lo = (p & 0xF).to(torch.float32) + 8388608.0
    f_hi = ((p >> 4) & 0xF).to(torch.float32) + 8388608.0
    sb = torch.from_numpy(s)[:, None, :]
    bias = (-(8388608.0 + 8.0)) * sb
    plain = (((f_lo * sb + bias) + f_hi * sb) + bias).numpy()
    got = np.stack([_bitcast_bytes(q4, s, kb) for kb in range(k // 32)])
    assert np.array_equal(got.view(np.uint32), plain.view(np.uint32))
