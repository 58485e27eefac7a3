"""Port parity: the kernel lab (`llamago_tpu_torch.kernel_lab`) against the
JAX package's `scripts/kernel_lab.py` on the CPU.

Inputs are made with numpy from a seed (x rounded to bf16, w float32
through each package's own `quantize`, whose leaves agree bit for bit:
tests/test_torch_int4.py). Every JAX variant runs through the lab's own
`make_call(...)(*ops_of(...))` in interpret mode at K = N = 512, tk = tn =
256, m = 8; the port's side is the plain version under the same name and
tk (on a CPU tensor the wrapper takes it too). The hoisted operands are
made under `jax.jit`, as the lab's timed sweep makes them: compiled JAX
multiplies amax by fl(1/127) where the lab's eager correctness check
divides (one ulp of sx apart), and the port follows the compiled form.

Tolerances, of max|ref| unless said otherwise, none looser than the lab's
own 2e-2:
  L1, L4, L5   8e-3: the port runs them through K1 / K9, which round their
               output to bf16 (the lab's kernels give f32);
  L2, L3, L9, L12, L6 to L8, L10   1e-5: both decode a weight to the same
               bits (the bf16 roundings of L3, L9 and L12 included) and take
               exact integer dots of the same xq; f32 sums in another order;
  L11          the byte sums (`dma_only`, `dma_pure`) exact; `decode_only`
               1e-5 of K * 8 * max|s|; `decode_bitcast` K * max|s| absolute:
               every element of its chain is off by roundings of size
               2^23 * s * 2^-24 on their own, and compiled JAX may fuse the
               products into FMAs where the port rounds each step.
"""

import importlib.util
import inspect
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import quant as jquant
from llamago_tpu_torch import kernel_lab as lab
from llamago_tpu_torch.ops import lab_kernels as lk
from llamago_tpu_torch.ops import quant

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
K = N = 512
TM = 8

F32_TOL = 1e-5
BF16_OUT_TOL = 8e-3
ROW_TOL = {"L1": BF16_OUT_TOL, "L4": BF16_OUT_TOL, "L5": BF16_OUT_TOL,
           "L2": F32_TOL, "L3": F32_TOL, "L6": F32_TOL, "L7": F32_TOL, "L8": F32_TOL,
           "L9": F32_TOL, "L10": F32_TOL, "L12": F32_TOL}


def _load_jax_lab():
    spec = importlib.util.spec_from_file_location("jax_kernel_lab",
                                                  ROOT / "scripts" / "kernel_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jlab = _load_jax_lab()


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)


def inputs(seed=3):
    """x [8, K] (bf16 values) and w [K, N] as numpy float32."""
    x = torch.from_numpy(rnd((TM, K), seed)).to(torch.bfloat16).to(torch.float32).numpy()
    x[1, 32:64] = 0.0  # a zero block: sx = 1
    return x, rnd((K, N), seed + 1)


def jax_leaf(w, fmt):
    if fmt == "w16":
        return {"q16": jnp.asarray(w).astype(jnp.bfloat16),
                "s": jnp.ones((K // 32, N), jnp.bfloat16)}
    leaf = jquant.quantize(jnp.asarray(w), 8 if fmt == "q8" else 4)
    return jlab.to_i4(leaf) if fmt == "i4" else leaf


def jax_variant(name, x, w, tk):
    """The JAX lab's kernel `name` in interpret mode, f32 [8, N]."""
    kern, opts = jlab.VARIANTS[name]
    fmt = opts.get("fmt", "q4")
    qkey = {"q8": "q8", "w16": "q16"}.get(fmt, "q4")
    leaf = jax_leaf(w, fmt)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    if kern is None:  # xla_i4: the jnp expression of the lab's correctness()
        wf = (leaf["q4"].astype(jnp.float32).reshape(K // 32, 32, N)
              * leaf["s"].astype(jnp.float32)[:, None, :]).reshape(K, N)
        return np.asarray(xj.astype(jnp.float32) @ wf)
    call, ops_of = jlab.make_call(kern, opts, K, N, TM, tk, 256, fmt)
    ops = jax.jit(lambda a: ops_of(a, leaf, qkey))(xj)
    return np.asarray(call(*ops))


def port_variant(name, x, w, tk):
    """(plain version, wrapper on CPU tensors) of the port's `name`."""
    v = lab.VARIANTS[name]
    leaf = lab.make_leaf(torch.from_numpy(w), v.fmt)
    ops = lab.HOISTS[v.hoist](torch.from_numpy(x).to(torch.bfloat16), tk)
    return v.plain(ops, leaf, tk).numpy(), v.fn(ops, leaf, tk).numpy(), leaf


TK_DEPENDENT = [n for n, v in lab.VARIANTS.items() if v.row in ("L8", "L10")] + ["dma_pure"]
CASES = [(n, 256) for n in lab.VARIANTS] + [(n, 128) for n in TK_DEPENDENT]


@pytest.mark.parametrize("name,tk", CASES, ids=[f"{n}-tk{t}" for n, t in CASES])
def test_variant_plain_version_matches_the_jax_kernel(name, tk):
    x, w = inputs()
    want = jax_variant(name, x, w, tk)
    got, via_wrapper, leaf = port_variant(name, x, w, tk)
    assert got.shape == want.shape == (TM, N) and got.dtype == np.float32
    np.testing.assert_array_equal(via_wrapper, got)  # a CPU tensor takes the plain version
    row = lab.VARIANTS[name].row
    d = np.abs(got - want).max()
    if name in ("dma_only", "dma_pure"):
        np.testing.assert_array_equal(got, want)
    elif name == "decode_only":
        assert d <= F32_TOL * K * 8 * to_np(leaf["s"]).max()
    elif name == "decode_bitcast":
        assert d <= K * np.abs(to_np(leaf["s"])).max()
        assert np.abs(got).max() > 0
    else:
        assert d <= ROW_TOL[row] * np.abs(want).max(), (d, np.abs(want).max())


def test_decode_bitcast_is_lossy_within_its_chain_rounding():
    """The chain loses about |s| an element against the exact column sums
    (`decode_only`), and not more than its roundings allow."""
    x, w = inputs()
    exact, _, leaf = port_variant("decode_only", x, w, 256)
    lossy, _, _ = port_variant("decode_bitcast", x, w, 256)
    d = np.abs(lossy - exact).max()
    assert 0 < d <= K * np.abs(to_np(leaf["s"])).max()


@pytest.mark.parametrize("hoist,name", [("split", "split_h"), ("a8", "w4a8_h"),
                                        ("a8full", "w8a8_fulltk"),
                                        ("a8g128", "bitcast_i4_i8dot_g128"),
                                        ("splitfull", "w4a8_split_fulltk")])
@pytest.mark.parametrize("tk", [256, 128])
def test_hoisted_operands_match_ops_of(hoist, name, tk):
    """Bit for bit against `ops_of` under jit (the timed sweep's form); run
    op by op JAX divides by 127 where compiled JAX multiplies by fl(1/127):
    sx within one ulp, xq within one step at the few ties that flips."""
    x, w = inputs(seed=5)
    kern, opts = jlab.VARIANTS[name]
    assert opts.get("hoist") == hoist == lab.VARIANTS[name].hoist
    fmt = opts.get("fmt", "q4")
    leaf = jax_leaf(w, fmt)
    _, ops_of = jlab.make_call(kern, opts, K, N, TM, tk, 256, fmt)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    eager = ops_of(xj, leaf, fmt)
    jitted = jax.jit(lambda a: ops_of(a, leaf, fmt))(xj)
    # positions of the x-side operands in the kernel's signature
    idx = {"split": (0, 1), "a8": (0, 3), "a8full": (0, 1), "a8g128": (0, 1),
           "splitfull": (0, 1)}[hoist]
    got = lab.HOISTS[hoist](torch.from_numpy(x).to(torch.bfloat16), tk)
    assert len(got) == 2
    for g, i in zip(got, idx):
        assert str(g.dtype).split(".")[-1] == str(jitted[i].dtype)
        np.testing.assert_array_equal(to_np(g), to_np(jitted[i]))
        e = to_np(eager[i])
        if g.dtype == torch.int8:
            diff = np.abs(to_np(g).astype(np.int32) - e.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            np.testing.assert_allclose(to_np(g), e, rtol=1.2e-7, atol=0)


def test_join_split_inverts_hoist_split():
    x = torch.from_numpy(rnd((TM, K), 7)).to(torch.bfloat16)
    assert torch.equal(lk.join_split(*lk.hoist_split(x)), x)


def test_a8_hoist_shapes_ties_and_the_zero_block():
    x = torch.from_numpy(rnd((TM, K), 8)).to(torch.bfloat16)
    x[0, :32] = 0.0
    x[1, :32] = 0.01
    x[1, :5] = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0]).to(torch.bfloat16)
    xq, sx = lk.hoist_a8(x)
    assert xq.shape == (K // 32, TM, 32) and sx.shape == (K // 32, TM)
    assert sx[0, 0].item() == 1.0 and not xq[0, 0].any()  # amax 0: scale 1
    assert xq[0, 1, :5].tolist() == [0, 2, 2, 0, 127]  # ties to even
    assert xq.abs().max() <= 127


def test_to_i4_gives_the_jax_values():
    _, w = inputs(seed=9)
    w[:32, 0] = 0.0  # an all-zero block
    want = jlab.to_i4(jquant.quantize(jnp.asarray(w), 4))
    got = lk.to_i4(quant.quantize(torch.from_numpy(w), 4))
    assert got["i4"].dtype == torch.uint8 and got["i4"].shape == (K // 2, N)
    vals = quant.unpack_w4x8(got["i4"])
    assert vals.dtype == torch.int8 and vals.min() >= -8 and vals.max() <= 7
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want["q4"].astype(jnp.int8)))
    np.testing.assert_array_equal(to_np(got["s"]), to_np(want["s"]))
    # natural row order: row r of the values is row r of the dequantized weight
    np.testing.assert_array_equal(
        vals.numpy(), quant.unpack_q4(quant.quantize(torch.from_numpy(w), 4)["q4"]).numpy())


def test_unpack_w4x8_is_the_bitcast_decode():
    """The TPU's u8 -> int4 bitcast (the probe of tests/test_quant.py, run in
    interpret mode) on arbitrary bytes: what L9 and L10 read the Q4_0 bytes
    as, and the port's `unpack_w4x8`."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    packed = np.random.default_rng(10).integers(0, 256, (128, 128), dtype=np.uint8)

    def kern(q_ref, o_ref):
        o_ref[:] = pltpu.bitcast(q_ref[:], jnp.int4).astype(jnp.int32)

    want = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((256, 128), jnp.int32),
                          interpret=True)(jnp.asarray(packed))
    got = quant.unpack_w4x8(torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), np.asarray(want))


def test_variants_are_the_jax_labs_32_names_and_skip_list():
    assert list(lab.VARIANTS) == list(jlab.VARIANTS) and len(lab.VARIANTS) == 32
    for name, (kern, opts) in jlab.VARIANTS.items():
        v = lab.VARIANTS[name]
        assert v.fmt == opts.get("fmt", "q4") and v.hoist == opts.get("hoist"), name
        assert (v.counter is None) == (kern is None), name
    # the skip list lives in the source of the JAX lab's correctness()
    src = inspect.getsource(jlab.correctness)
    quoted = {name for name in jlab.VARIANTS if f'"{name}"' in src}
    assert quoted == set(lab.SKIP_CHECK) and len(lab.SKIP_CHECK) == 12
    assert "decode_bitcast" not in lab.SKIP_CHECK
    rows = {v.row for v in lab.VARIANTS.values()}
    assert rows == {f"L{i}" for i in range(1, 13)}


@pytest.mark.parametrize("name", list(lab.VARIANTS))
def test_correctness_passes_19_skips_12_and_drops_decode_bitcast(name, capsys):
    if name == "decode_bitcast":
        with pytest.raises(AssertionError, match="decode_bitcast"):
            lab.correctness(name, "cpu")
        assert "FAIL" in capsys.readouterr().out
    elif name in lab.SKIP_CHECK:
        assert lab.correctness(name, "cpu") is None
        assert capsys.readouterr().out == ""
    else:
        err = lab.correctness(name, "cpu")
        assert err < (5e-2 if "a8" in name else 2e-2)
        assert "OK" in capsys.readouterr().out


def test_correctness_counts():
    checked = [n for n in lab.VARIANTS if n not in lab.SKIP_CHECK and n != "decode_bitcast"]
    assert len(checked) == 19


def test_main_on_the_cpu_prints_a_line_per_name(monkeypatch, capsys):
    for key, val in (("LAB_K", "512"), ("LAB_N", "512"), ("LAB_LAYERS", "2"),
                     ("LAB_STEPS", "1"), ("LAB_REPS", "1")):
        monkeypatch.setenv(key, val)
    assert lab.main(["--device", "cpu", "base", "w4a8", "dma_pure", "decode_bitcast"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device=cpu dev=cpu"
    timed = [line for line in out if "s/sweep" in line]
    assert [line.split()[0] for line in timed] == ["base", "w4a8", "dma_pure"]
    assert all("k=512 n=512 tk=512 m=8" in line and "no device rate" in line
               for line in timed)
    assert any("decode_bitcast  SKIP (correctness failed" in line for line in out)


def test_run_variant_honours_tk_and_counts_no_launch_on_the_cpu():
    before = lk.fulltk_matmul.launches
    out = lab.run_variant("w8a8_fulltk", k=512, n=256, m=8, layers=2, steps=1, reps=1,
                          tk=128, device="cpu")
    assert out["tk"] == 128 and out["launches"] == 0 and out["device"] == "cpu"
    assert lk.fulltk_matmul.launches == before and "kernel_ms" not in out
    with pytest.raises(ValueError, match="k-tiles"):
        lab.run_variant("base", k=512, n=256, tk=384, device="cpu")


def test_main_needs_cuda_unless_cpu_is_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lab.main(["base"]) != 0
    err = capsys.readouterr().err
    assert "cuda" in err and "--device cpu" in err
    assert lab.main(["no_such_variant", "--device", "cpu"]) != 0


def test_module_entry_point_runs_on_the_cpu():
    env = {**os.environ, "LAB_K": "512", "LAB_N": "512", "LAB_LAYERS": "2", "LAB_STEPS": "1",
           "LAB_REPS": "1", "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-m", "llamago_tpu_torch.kernel_lab", "--device",
                          "cpu", "bf16dot"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "bf16dot  correctness rel-err" in run.stdout and "s/sweep" in run.stdout


@pytest.mark.parametrize("name,rate,by", [("base", "bf16", "bytes"),
                                          ("i4native", "bf16", "bytes"),
                                          ("xla_i4", "f32", "operations"),
                                          ("w4a8", "int8", "bytes"),
                                          ("bf16dot", "bf16", "bytes"),
                                          ("dma_pure", None, "bytes")])
def test_variant_bound_at_the_labs_shape(name, rate, by):
    """Q4_0 at K = 8192, N = 7168, m = 8: 0.94 GFLOP in f32 take 14.0 us at
    67 TFLOP/s, more than the 33 MB take at 3.35 TB/s (`xla_i4`, plain
    PyTorch in f32); in bf16 (the tensor-core decode forms of K1, which
    carry `base`, and of the lab's float rows, which carry `i4native`: its
    int4 values and bf16 x are exact bf16) the bytes bound."""
    assert lab.VARIANTS[name].rate == rate
    ms, bound_by = lab.variant_bound(name, 8192, 7168, 8, 1024)
    assert bound_by == by
    if rate == "f32":
        assert ms == pytest.approx(2 * 8 * 8192 * 7168 / 67e12 * 1e3)
    elif name == "dma_pure":
        assert ms == pytest.approx((8192 * 7168 / 2 + 4 * 8 * 7168) / 3.35e12 * 1e3)
    else:
        assert 8.8e-3 < ms < 10.2e-3


def test_variant_work_counts_the_bytes_the_function_reads():
    """The rate printed beside a variant divides these bytes, not the whole
    leaf: a byte probe reads no scale, a full-tile form one scale row a tile."""
    k, n, tm, tk = 8192, 7168, 8, 1024
    out = 4 * tm * n
    assert lab.variant_work("dma_only", k, n, tm, tk) == (k * n // 2 + out, 0.0)
    assert lab.variant_work("w16dot", k, n, tm, tk) == (
        2 * k * n + 2 * tm * k + out, 2.0 * tm * k * n)
    nbytes, ops = lab.variant_work("w4a8_split_fulltk", k, n, tm, tk)
    assert nbytes == k * n // 2 + 2 * (k // tk) * n + tm * k + out and ops == 2.0 * tm * k * n
    assert lab.variant_work("decode_only", k, n, tm, tk) == (
        k * n // 2 + 2 * (k // 32) * n + out, 2.0 * k * n)


def test_run_times_a_dropped_variant_only_when_asked(capsys):
    shape = dict(device="cpu", k=512, n=256, layers=2, steps=1, reps=1)
    res = lab.run(["decode_bitcast", "dma_only"], **shape)
    assert list(res["dropped"]) == ["decode_bitcast"] and res["skipped"] == ["dma_only"]
    assert [r["name"] for r in res["timed"]] == ["dma_only"]
    assert len(res["layers"]["q4"]) == 2
    res = lab.run(["decode_bitcast", "dma_only"], time_dropped=True, **shape)
    assert [r["name"] for r in res["timed"]] == ["decode_bitcast", "dma_only"]
    capsys.readouterr()


# ----------------------------------------------------- what the wrappers refuse

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda x, w: lk.i4_matmul(x, {"i4": w["q4"], "s": w["s"]}),
    lambda x, w: lk.bf16_dequant_matmul(x, w),
    lambda x, w: lk.bitcast_i4_matmul(x, w),
    lambda x, w: lk.w4a8_matmul(x, w),
    lambda x, w: lk.probe("dma_only", x, w, 256),
    lambda x, w: lk.w16_matmul(x, {"w16": _meta((K, N), torch.bfloat16), "s": w["s"]}),
    lambda x, w: lk.fulltk_matmul((_meta((TM, K // 2), torch.int8),) * 2, w, 256),
    lambda x, w: lk.bitcast_i4_i8dot((_meta((TM, K), torch.int8),
                                      _meta((K // 256, TM), torch.float32)), w, 256),
], ids=["i4", "bf16", "bitcast_i4", "w4a8", "probe", "w16", "fulltk", "i8dot"])
def test_wrappers_raise_on_a_device_that_is_neither_cpu_nor_cuda(call):
    x = _meta((TM, K), torch.bfloat16)
    w = {"q4": _meta((K // 2, N), torch.uint8), "s": _meta((K // 32, N), torch.bfloat16)}
    with pytest.raises(ValueError, match="unsupported device"):
        call(x, w)


@pytest.mark.parametrize("case", ["ok", "x_dtype", "q_rows", "s_dtype", "n_ragged",
                                  "k_ragged", "strided", "device"])
def test_operand_checks_before_a_launch(case):
    """The checks every wrapper runs before a launch (pure Python on shapes,
    dtypes and layout, so they run here on CPU tensors)."""
    k, n = 256, 64
    x = torch.zeros((TM, k), dtype=torch.bfloat16)
    q = torch.zeros((k // 2, n), dtype=torch.uint8)
    s = torch.zeros((k // 32, n), dtype=torch.bfloat16)
    dev = x.device
    if case == "x_dtype":
        x = x.to(torch.float32)
    elif case == "q_rows":
        q = q[:-1]
    elif case == "s_dtype":
        s = s.to(torch.float32)
    elif case == "n_ragged":
        n = 40
        q, s = q[:, :n].contiguous(), s[:, :n].contiguous()
    elif case == "k_ragged":
        k = 240
        x, q, s = x[:, :k].contiguous(), q[: k // 2], s[: k // 32]
    elif case == "strided":
        x = torch.zeros((TM, 2 * k), dtype=torch.bfloat16)[:, ::2]
    elif case == "device":
        dev = torch.device("meta")
    ops = {"x": (x, torch.bfloat16, (TM, k)), "w": (q, torch.uint8, (k // 2, n)),
           "s": (s, torch.bfloat16, (k // 32, n))}
    if case == "ok":
        lk._check("lab", dev, ops, k, n)
        lk._check_tm("lab", 16)
        return
    with pytest.raises(ValueError):
        lk._check("lab", dev, ops, k, n)


def test_row_count_and_probe_kind_are_checked():
    with pytest.raises(ValueError, match="multiple of 8"):
        lk._check_tm("lab", 12)
    with pytest.raises(ValueError, match="unknown kind"):
        lk.probe("dma_fast", torch.zeros((TM, 64)), {}, 32)
    with pytest.raises(ValueError, match="unknown kind"):
        lk.probe_plain("dma_fast", {"q4": torch.zeros((32, 16), dtype=torch.uint8),
                                    "s": torch.zeros((2, 16))}, TM, 32)
    assert lk.default_tk(8192) == 1024 and lk.default_tk(512) == 512
    assert lk.ksplit_for(8192, 512) == 16 and lk.ksplit_for(512, 1024) == 1
