"""K3, the int8 cache append, as one warp a row: its plan, the C entry
point and what the wrapper hands it, its argument checks, and a numpy
emulation of its lanes, against the plain version and the JAX kernel in
interpret mode.

On the card `cache_append_quant` (ops/cache_write.py) launches
`append_warp` (csrc/cache_append.cu) once and nothing else: the new rows are
read through their batch and head strides (v is a view of the fused wqkv
output on the serving path) and write_pos in its own dtype (int64 there).
One warp takes one (b, head, K or V) row; lane l owns values [l * vpl, (l +
1) * vpl) of it, vpl = hd / 32, read in loads of `vec` values; the absmax is
a butterfly of shuffles, the quotient x / s an IEEE division, and the lane's
int8 values are packed four to a little-endian word and stored in one go.
Here, without a card, the wrapper takes the plain version; the tests pin
the plan, the C signature, the checks, the launcher on meta tensors (no
other aten op), and the emulated lanes bit for bit against the plain
version and JAX's `_append_kernel`.
"""

import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from llamago_tpu.ops import kernels as jkernels
from llamago_tpu.ops.cache_write import cache_append_quant as jcache_append_quant
from llamago_tpu_torch.ops import _build, cache_write

torch.set_num_threads(1)

SRC = (pathlib.Path(__file__).resolve().parent.parent / "llamago_tpu_torch" / "csrc"
       / "cache_append.cu")
INV127 = np.float32(1.0) / np.float32(127.0)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    yield
    jkernels.FORCE_INTERPRET = old


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, round to nearest even (finite values)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _storage(x: torch.Tensor) -> np.ndarray:
    """x's whole storage as f32 values, addressed as the kernel addresses it."""
    flat = torch.tensor([], dtype=x.dtype).set_(x.untyped_storage())
    return flat.float().numpy()


def _store(mem: np.ndarray, dst: int, words: np.ndarray, vpl: int) -> None:
    """A lane's packed int8 values written as the kernel writes them: the
    widest store vpl allows, each aligned to its width, little-endian."""
    def put(at, width, value_bytes):
        assert at % width == 0
        mem[at:at + width] = value_bytes

    le = words.astype("<u4").view(np.uint8)  # byte i of the lane at le[i]
    if vpl % 16 == 0:
        for j in range(vpl // 16):
            put(dst + 16 * j, 16, le[16 * j:16 * j + 16])
    elif vpl % 8 == 0:
        for j in range(vpl // 8):
            put(dst + 8 * j, 8, le[8 * j:8 * j + 8])
    elif vpl % 4 == 0:
        for j in range(vpl // 4):
            put(dst + 4 * j, 4, le[4 * j:4 * j + 4])
    elif vpl % 2 == 0:
        for j in range(vpl // 2):
            half = (int(words[j >> 1]) >> (16 * (j & 1))) & 0xFFFF
            put(dst + 2 * j, 2, np.array([half], "<u2").view(np.uint8))
    else:
        for j in range(vpl):
            mem[dst + j] = (int(words[j >> 2]) >> (8 * (j & 3))) & 0xFF


def emulate_k3(k_l, v_l, ks_l, vs_l, k_new, v_new, pos) -> list[np.ndarray]:
    """csrc/cache_append.cu on the card, emulated in numpy over
    `append_plan`'s grid: warp w of block b takes row b * warps + w (K's
    rows, then V's), reads its lanes' values through the new rows' storage
    and strides (each load aligned to its `vec` values), takes the absmax by
    a butterfly, s = a * fl(1/127) (1 on a zero row), q = clamp(rint(x /
    s)) in f32, packs each lane's bytes into words (byte i at bits 8 (i %
    4) of word i / 4) and stores them at the clamped slot; lane 0 writes
    the scale (bf16 planes: rounded to nearest even). Returns the four
    planes after the call, as numpy arrays."""
    b, _, kv, hd = k_new.shape
    s_len = k_l.shape[2]
    blocks, warps, vpl, vec = cache_write.append_plan(b, kv, hd, k_new.dtype)
    mems = [k_l.numpy().reshape(-1).view(np.uint8).copy(),
            v_l.numpy().reshape(-1).view(np.uint8).copy()]
    bf16_planes = ks_l.dtype == torch.bfloat16
    scales = [(a.view(torch.int16).numpy().view(np.uint16) if bf16_planes else a.numpy())
              .reshape(-1).copy() for a in (ks_l, vs_l)]
    srcs = [(_storage(x), x.storage_offset(), x.stride(0), x.stride(2)) for x in (k_new, v_new)]
    seen = []
    for blk in range(blocks):
        for wi in range(warps):
            row = blk * warps + wi
            if row >= 2 * b * kv:
                continue
            seen.append(row)
            which = int(row >= b * kv)
            bh = row - which * b * kv
            bi, h = divmod(bh, kv)
            vals, off, sb, sh = srcs[which]
            start = off + bi * sb + h * sh
            idx = start + np.arange(32)[:, None] * vpl + np.arange(vpl)[None, :]
            assert (idx[:, ::vec] % vec == 0).all()  # every load aligned to its values
            x = vals[idx].astype(np.float32)  # [32 lanes, vpl]
            a = np.abs(x).max(axis=1)
            for o in (16, 8, 4, 2, 1):
                a = np.maximum(a, a[np.arange(32) ^ o])
            assert (a == a[0]).all()  # every lane holds the row's absmax
            s = np.float32(a[0] * INV127) if a[0] > 0 else np.float32(1.0)
            q = np.clip(np.rint(x / s), -127, 127).astype(np.int64)
            words = np.zeros((32, 8), np.uint32)
            for i in range(vpl):
                words[:, i >> 2] |= (q[:, i] & 0xFF).astype(np.uint32) << np.uint32(8 * (i & 3))
            p = int(pos[bi])
            p = min(max(p + s_len if p < 0 else p, 0), s_len - 1)
            slot = bh * s_len + p
            for lane in range(32):
                _store(mems[which], slot * hd + lane * vpl, words[lane], vpl)
            scales[which][slot] = bf16_bits(s) if bf16_planes else s
    assert sorted(seen) == list(range(2 * b * kv))  # every row once
    out = [m.view(np.int8).reshape(k_l.shape) for m in mems]
    return out + [(a.view(np.int16) if bf16_planes else a).reshape(ks_l.shape) for a in scales]


def _planes(seed, b, kv, s, hd, scale_dtype):
    rng = np.random.default_rng(seed)
    k8 = torch.from_numpy(rng.integers(-127, 128, (b, kv, s, hd)).astype(np.int8))
    v8 = torch.from_numpy(rng.integers(-127, 128, (b, kv, s, hd)).astype(np.int8))
    ks = torch.from_numpy(rng.random((b, kv, s)).astype(np.float32)).to(scale_dtype)
    vs = torch.from_numpy(rng.random((b, kv, s)).astype(np.float32)).to(scale_dtype)
    return [k8, v8, ks, vs]


def serving_rows(seed, b, kv, hd, dtype, q_dim=None):
    """k contiguous (the rope's output) and v a view of the fused [b, 1,
    q_dim + 2 kv_dim] projection, as models/llama.py hands them to K3; the
    projection's values, and a zero row in v."""
    q_dim = kv * hd if q_dim is None else q_dim
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy((rng.standard_normal((b, 1, q_dim + 2 * kv * hd)) * 2)
                           .astype(np.float32)).to(dtype)
    qkv[0, 0, q_dim + kv * hd + hd:q_dim + kv * hd + 2 * hd] = 0  # v's row (0, 1)
    k = qkv[..., q_dim:q_dim + kv * hd].reshape(b, 1, kv, hd).contiguous()
    v = qkv[..., q_dim + kv * hd:].reshape(b, 1, kv, hd)
    assert not v.is_contiguous() and v.stride(0) == q_dim + 2 * kv * hd
    return k, v


def _as_numpy(planes):
    return [a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
            for a in planes]


# ------------------------------------------------------------------ the plan

def test_plan_at_7b():
    """7B at batch 8: 512 rows, 64 blocks of 8 warps, 4 values a lane read
    as one load (8 bytes of bf16, 16 of f32)."""
    assert cache_write.append_plan(8, 32, 128, torch.bfloat16) == (64, 8, 4, 4)
    assert cache_write.append_plan(8, 32, 128, torch.float32) == (64, 8, 4, 4)
    assert cache_write.append_plan(4, 32, 128, torch.bfloat16) == (32, 8, 4, 4)


@pytest.mark.parametrize("hd,bf16,f32", [(32, 1, 1), (64, 2, 2), (96, 1, 1), (128, 4, 4),
                                         (160, 1, 1), (192, 2, 2), (256, 8, 4), (768, 8, 4),
                                         (1024, 8, 4)])
def test_plan_vector_loads(hd, bf16, f32):
    """The widest load that divides a lane's hd / 32 values, at most 16
    bytes: odd counts (hd 96, 160) one value at a time."""
    for dtype, vec in ((torch.bfloat16, bf16), (torch.float32, f32)):
        blocks, warps, per_lane, got = cache_write.append_plan(3, 5, hd, dtype)
        assert (per_lane, got) == (hd // 32, vec)
        assert got * dtype.itemsize <= 16 and per_lane % got == 0
        assert (blocks, warps) == (4, 8)  # 30 rows


@pytest.mark.parametrize("b,kv", [(1, 1), (1, 3), (2, 2), (8, 32), (5, 7)])
def test_plan_covers_every_row_once(b, kv, monkeypatch):
    for w in (4, 8, 16):
        monkeypatch.setattr(cache_write, "APPEND_WARPS", w)
        blocks, warps, _, _ = cache_write.append_plan(b, kv, 128, torch.bfloat16)
        rows = 2 * b * kv
        assert warps == min(w, rows) and blocks * warps >= rows > (blocks - 1) * warps


# ------------------------------------------------------------- the lanes

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inputs", ["contiguous, int32", "serving, int64"])
def test_lanes_equal_plain_and_jax_bit_for_bit(dtype, scale_dtype, inputs):
    """The emulated kernel, the plain version and JAX's `_append_kernel` (in
    interpret mode) write the same bits, on contiguous rows with int32
    positions and on the serving path's (a strided v, int64 positions)."""
    b, kv, s, hd = 4, 2, 128, 128
    tdt, sdt = getattr(torch, dtype), getattr(torch, scale_dtype)
    planes = _planes(1, b, kv, s, hd, sdt)
    pos = [0, s - 1, -3, 2 * s - 1]
    if inputs.startswith("serving"):
        k, v = serving_rows(2, b, kv, hd, tdt)
        tpos = torch.tensor(pos, dtype=torch.int64)
    else:
        rng = np.random.default_rng(3)
        k, v = (torch.from_numpy(rng.standard_normal((b, 1, kv, hd)).astype(np.float32))
                .to(tdt) for _ in range(2))
        v[0, 0, 1] = 0
        tpos = torch.tensor(pos, dtype=torch.int32)
    got = emulate_k3(*planes, k, v, tpos)
    plain = [a.clone() for a in planes]
    cache_write.cache_append_quant_plain(*plain, k, v, tpos)
    for g, w in zip(got, _as_numpy(plain)):
        np.testing.assert_array_equal(g, w)
    jplanes = [jnp.asarray(a.numpy()) for a in planes[:2]]
    jplanes += [jnp.asarray(a.float().numpy()).astype(scale_dtype) for a in planes[2:]]
    jnew = [jnp.asarray(x.float().numpy()).astype(dtype) for x in (k, v)]
    want = jcache_append_quant(*jplanes, *jnew, jnp.asarray(pos, jnp.int32))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g, w.view(np.int16) if w.dtype == jnp.bfloat16 else w)


@pytest.mark.parametrize("hd", [32, 64, 96, 160, 192, 256, 512, 768, 1024])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lanes_equal_plain_at_every_store_width(hd, dtype):
    """Every store the kernel has: one byte at a time (hd 32, 96, 160), two
    (64, 192), four (128), eight (256, 768: three stores) and sixteen (512,
    1024: two stores), with every placement: 0, S-1, negative, overrunning,
    far outside on both sides as int64."""
    b, kv, s = 6, 2, 64
    tdt = getattr(torch, dtype)
    planes = _planes(hd, b, kv, s, hd, torch.float32)
    k, v = serving_rows(hd + 1, b, kv, hd, tdt, q_dim=3 * hd)
    pos = torch.tensor([0, s - 1, -1, 2 * s + 5, -(2 ** 40), 2 ** 40], dtype=torch.int64)
    got = emulate_k3(*planes, k, v, pos)
    plain = [a.clone() for a in planes]
    cache_write.cache_append_quant_plain(*plain, k, v, pos)
    for g, w in zip(got, _as_numpy(plain)):
        np.testing.assert_array_equal(g, w)


def test_packing_puts_the_lowest_address_in_the_lowest_byte():
    """A lane's word holds its values i = 0..3 at bits 8i..8i+7, and the
    little-endian store lays them out in order: the int8 row reads back as
    q, lane after lane."""
    b, kv, s, hd = 1, 1, 8, 128
    planes = _planes(0, b, kv, s, hd, torch.float32)
    row = torch.arange(-64, 64, dtype=torch.float32) * (127.0 / 64.0)
    k = row.reshape(1, 1, 1, hd).clone()
    got = emulate_k3(*planes, k, k.clone(), torch.tensor([2]))
    q = np.clip(np.rint(row.numpy() / (np.float32(127.0) * INV127)), -127, 127)
    np.testing.assert_array_equal(got[0][0, 0, 2], q.astype(np.int8))
    np.testing.assert_array_equal(got[0][0, 0, 2][:4], [-127, -125, -123, -121])


def test_cpu_wrapper_takes_the_serving_path_inputs_as_jax_does():
    """On the CPU the wrapper takes the strided v and int64 positions as
    they come (the plain version), counts no launch, and equals JAX."""
    b, kv, s, hd = 4, 2, 128, 64
    k, v = serving_rows(5, b, kv, hd, torch.bfloat16)
    pos = [3, s - 1, -2, 2 * s - 1]
    planes = _planes(6, b, kv, s, hd, torch.float32)
    launches = cache_write.cache_append_quant.launches
    cache_write.cache_append_quant(*planes, k, v, torch.tensor(pos, dtype=torch.int64))
    assert cache_write.cache_append_quant.launches == launches
    before = _planes(6, b, kv, s, hd, torch.float32)
    want = jcache_append_quant(*(jnp.asarray(a.numpy()) for a in before),
                               *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                                 for x in (k, v)),
                               jnp.asarray(pos, jnp.int32))
    for g, w in zip(planes, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------- the C side

def test_entry_point_matches_the_argtypes(monkeypatch):
    class Lib:
        llamago_cache_append_quant = type("Fn", (), {})()

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    fn = cache_write._lib.__wrapped__()
    sig = re.search(r'extern "C" int llamago_cache_append_quant\(([^)]*)\)', SRC.read_text())
    params = [p.split() for p in sig.group(1).split(",")]
    assert [p[-1] for p in params] == [
        "k_new", "v_new", "k_sb", "k_sh", "v_sb", "v_sh", "k8", "v8", "ks", "vs", "pos", "B",
        "KV", "S", "hd", "is_bf16", "scale_bf16", "pos_i64", "vec", "warps", "stream"]
    types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    assert fn.argtypes == [types[" ".join(p[:-1])] for p in params]
    assert fn.restype is ctypes.c_int


def test_the_kernel_has_no_shared_memory_and_no_barrier():
    """The absmax is a butterfly of shuffles, the quotient IEEE, the row's
    slot clamped as write_rows places it; no __syncthreads, no __shared__."""
    src = SRC.read_text()
    body = src.split("__global__ void append_warp")[1].split("template <")[0]
    assert "__syncthreads" not in src and "__shared__" not in src
    assert "__shfl_xor_sync" in src and "__fdiv_rn(x[i], s)" in body
    assert "if (p < 0) p += a.S;" in body and "p > a.S - 1 ? a.S - 1 : p" in body
    assert "a.pos_i64 ? static_cast<const long long*>(a.pos)[b]" in body
    assert "if (nv > NV) return launch_nv<T, V, 2 * NV>" in src  # loops sized to the loads


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __call__(self, k_new, v_new, k_sb, k_sh, v_sb, v_sh, k8, v8, ks, vs, pos, b, kv, s,
                 hd, is_bf16, scale_bf16, pos_i64, vec, warps, stream):
        self.calls.append(dict(k_sb=k_sb, k_sh=k_sh, v_sb=v_sb, v_sh=v_sh, b=b, kv=kv, s=s,
                               hd=hd, is_bf16=is_bf16, scale_bf16=scale_bf16,
                               pos_i64=pos_i64, vec=vec, warps=warps))
        return 0


class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("pos_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_launcher_hands_the_strides_and_runs_no_other_op(monkeypatch, pos_dtype, scale_dtype):
    """The wrapper on meta tensors shaped as the 7B serving step's (v a
    view of the fused projection): one call of the entry point with the
    rows' strides, the positions' dtype and the plan, one launch counted,
    and not one aten op (no copy, no cast) on the way."""
    fake = _FakeLib()
    monkeypatch.setattr(cache_write, "_lib", lambda: fake)
    monkeypatch.setattr(cache_write, "_cuda_or_raise", lambda x: None)
    monkeypatch.setattr(cache_write, "_stream", lambda x: 0)
    monkeypatch.setattr(cache_write.cache_append_quant, "launches", 0)
    meta = torch.device("meta")
    b, kv, s, hd, q_dim = 8, 32, 1024, 128, 4096
    qkv = torch.empty((b, 1, q_dim + 2 * kv * hd), dtype=torch.bfloat16, device=meta)
    k = torch.empty((b, 1, kv, hd), dtype=torch.bfloat16, device=meta)
    v = qkv[..., q_dim + kv * hd:].reshape(b, 1, kv, hd)
    planes = [torch.empty((b, kv, s, hd), dtype=torch.int8, device=meta) for _ in range(2)]
    planes += [torch.empty((b, kv, s), dtype=scale_dtype, device=meta) for _ in range(2)]
    pos = torch.empty((b,), dtype=pos_dtype, device=meta)
    with _AtenOps() as seen:
        cache_write.cache_append_quant(*planes, k, v, pos)
    assert seen.ops == []
    assert fake.calls == [dict(k_sb=kv * hd, k_sh=hd, v_sb=q_dim + 2 * kv * hd, v_sh=hd, b=b,
                               kv=kv, s=s, hd=hd, is_bf16=1,
                               scale_bf16=int(scale_dtype == torch.bfloat16),
                               pos_i64=int(pos_dtype == torch.int64), vec=4, warps=8)]
    assert cache_write.cache_append_quant.launches == 1


def _args(b=2, kv=2, s=64, hd=128):
    k, v = serving_rows(0, b, kv, hd, torch.bfloat16)
    planes = _planes(0, b, kv, s, hd, torch.float32)
    return planes, k, v, torch.zeros(b, dtype=torch.int64)


@pytest.mark.parametrize("case", ["last_dim_strided", "overlapping_rows", "misaligned_start",
                                  "misaligned_stride", "pos_dtype", "pos_shape",
                                  "cache_misaligned", "cache_strided"])
def test_checks_raise_on_what_the_kernel_cannot_take(case):
    """The serving path's inputs pass; a layout the kernel cannot read
    raises (it is never copied)."""
    planes, k, v, pos = _args()
    cache_write._check_cuda_args(*planes, k, v, pos)
    cache_write._check_cuda_args(*planes, k, v, pos.int())
    b, _, kv, hd = k.shape
    base = torch.zeros(4 * b * kv * hd + 8, dtype=torch.bfloat16)
    if case == "last_dim_strided":
        v = base.as_strided((b, 1, kv, hd), (2 * kv * hd, 2 * kv * hd, 2 * hd, 2))
    elif case == "overlapping_rows":
        v = base.as_strided((b, 1, kv, hd), (kv * hd, kv * hd, 64, 1))
    elif case == "misaligned_start":
        v = base[1:1 + b * kv * hd].view(b, 1, kv, hd)
    elif case == "misaligned_stride":
        v = base.as_strided((b, 1, kv, hd), (kv * hd + 2, kv * hd + 2, hd, 1))
    elif case == "pos_dtype":
        pos = pos.to(torch.int16)
    elif case == "pos_shape":
        pos = torch.zeros(b + 1, dtype=torch.int64)
    elif case == "cache_misaligned":
        flat = torch.zeros(planes[0].numel() + 1, dtype=torch.int8)
        planes[0] = flat[1:].view(planes[0].shape)
    else:
        planes[1] = planes[1].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        cache_write._check_cuda_args(*planes, k, v, pos)
