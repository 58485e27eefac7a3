"""Port parity: K7 (ops/attention.py flash_attention on prefill windows), the
gate `can_fuse_attention`, and the model and Engine with the two opt-in
kernel routes on, against the JAX package on the CPU.

The JAX kernel `_flash_attention` runs in interpret mode; the port takes
K7's plain PyTorch version (the wrapper's CPU route). Inputs are made from
numpy seeds. Tolerances: attention 2e-5 absolute in f32, as the JAX
package's own kernel test uses, and 3e-2 in bf16 (outputs of size ~1 one
bf16 rounding apart, after probabilities one rounding apart); logits 1e-4
(other summation orders through two layers); greedy tokens equal.

In interpret mode the JAX gate skips its floors, so the routing table is
held against the JAX gate with `_on_tpu` patched to say yes (and interpret
mode off): nothing is launched there, the gate only reads shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint.params import host_parameters, unstack_layer_params
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.config import GenerateConfig as JGen
from llamago_tpu.models import llama as jllama
from llamago_tpu.ops import attention as jattention
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu.runtime.engine import Engine as JEngine
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu_torch.checkpoint.params import params_from_numpy, random_parameters
from llamago_tpu_torch.config import MODEL_PRESETS, GenerateConfig
from llamago_tpu_torch.models import llama
from llamago_tpu_torch.ops import attention, kernels
from llamago_tpu_torch.runtime.engine import Engine, JobStatus
from llamago_tpu_torch.runtime.kv_cache import KVCache
from llamago_tpu_torch.tokenizer import Vocab

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)

S = 768
GB = 1024 ** 3


@pytest.fixture(autouse=True)
def _interpret_kernels():
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = True
    yield
    jkernels.FORCE_INTERPRET = old


@pytest.fixture
def opt_in(monkeypatch):
    """Both packages with the prefill floor at 0 and the fused RMSNorm on.
    JAX reads its switches when it traces, so its compiled functions are
    dropped around the test."""
    monkeypatch.setattr(attention, "_MIN_PREFILL_SCORES", 0)
    monkeypatch.setattr(kernels, "USE_FUSED_NORM", True)
    monkeypatch.setattr(jattention, "_MIN_PREFILL_SCORES", 0)
    monkeypatch.setattr(jkernels, "USE_FUSED_NORM", True)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _inputs(b, t, h, kv, hd, s, pos0, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, hd)).astype(np.float32)
    pos = (np.asarray(pos0, np.int32)[:, None] + np.arange(t, dtype=np.int32)[None, :])
    return q, k, v, pos


def _jax_k7(q, k, v, pos, dtype=jnp.float32):
    """The TPU kernel itself, whatever the gate would say."""
    b, t, h, hd = q.shape
    kv = k.shape[1]
    q5 = jnp.asarray(q, dtype).reshape(b, t, kv, h // kv, hd)
    out = jattention._flash_attention(q5, jnp.asarray(k, dtype), jnp.asarray(v, dtype),
                                      jnp.asarray(pos[:, 0]), 1.0 / hd ** 0.5)
    return np.asarray(out.reshape(b, t, h * hd), np.float32)


def _launches():
    return (attention.flash_attention.launches, attention.flash_attention.launches_prefill,
            kernels.fused_rms_norm.launches)


# -------------------------------------------------------------------- K7


@pytest.mark.parametrize("t", [8, 16, 64])
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_k7_plain_matches_jax_kernel(t, h, kv):
    """pos0 = 0, mid-cache and the last window of the cache, in one batch."""
    q, k, v, pos = _inputs(3, t, h, kv, 16, S, [0, 300, S - t], seed=t + h)
    want = _jax_k7(q, k, v, pos)
    q5 = torch.from_numpy(q).reshape(3, t, kv, h // kv, 16)
    got = attention.flash_attention_prefill_plain(
        q5, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos[:, 0]))
    assert got.shape == q5.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.reshape(3, t, h * 16).numpy(), want, atol=2e-5)


@pytest.mark.parametrize("t,pos0", [(16, [5, 400]), (64, [0, 448])])
def test_k7_plain_bf16_matches_jax_kernel(t, pos0):
    q, k, v, pos = _inputs(2, t, 4, 2, 16, 512, pos0, seed=31 + t)
    want = _jax_k7(q, k, v, pos, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention.flash_attention_prefill_plain(tq.reshape(2, t, 2, 2, 16), tk, tv,
                                                  torch.from_numpy(pos[:, 0]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.reshape(2, t, 64).float().numpy(), want, atol=3e-2)


def test_flash_attention_takes_k7_for_long_windows():
    """t > 32: the wrapper's CPU route is K7's plain version, which is the
    JAX wrapper's `_flash_attention` route; no launch is counted."""
    q, k, v, pos = _inputs(2, 40, 4, 2, 16, 256, [0, 216], seed=4)
    jq, jk, jv, jp = map(jnp.asarray, (q, k, v, pos))
    assert jattention.can_fuse_attention(jq, jk)  # interpret mode skips the floors
    want = np.asarray(jattention.flash_attention(jq, jk, jv, jp))
    before = _launches()
    args = tuple(map(torch.from_numpy, (q, k, v, pos)))
    got = attention.flash_attention(*args)
    assert _launches() == before
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    plain = attention.flash_attention_prefill_plain(
        args[0].reshape(2, 40, 2, 2, 16), args[1], args[2], args[3][:, 0])
    assert torch.equal(got, plain.reshape(2, 40, 64))


def test_flash_attention_takes_k7_for_short_windows_without_lenaware(monkeypatch):
    """LLAMAGO_ATTN_LENAWARE=0: t <= 32 takes K7 in both packages."""
    monkeypatch.setattr(jattention, "_LENAWARE", False)
    monkeypatch.setattr(attention, "_LENAWARE", False)
    q, k, v, pos = _inputs(2, 16, 4, 2, 16, 256, [3, 240], seed=5)
    want = np.asarray(jattention.flash_attention(*map(jnp.asarray, (q, k, v, pos))))
    np.testing.assert_allclose(want, _jax_k7(q, k, v, pos), atol=0)  # JAX took K7
    args = tuple(map(torch.from_numpy, (q, k, v, pos)))
    got = attention.flash_attention(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    plain = attention.flash_attention_prefill_plain(
        args[0].reshape(2, 16, 2, 2, 16), args[1], args[2], args[3][:, 0])
    assert torch.equal(got, plain.reshape(2, 16, 64))
    assert not attention.quant_fits(16, 256)  # the int8 cache takes the math, as in JAX


def test_k7_plain_equals_attention_math_and_k2_plain():
    """One masked softmax over the row == the einsum math == K2's online
    softmax over S-blocks (finite mask), on contiguous windows."""
    q, k, v, pos = _inputs(2, 24, 4, 1, 16, 512, [0, 333], seed=6)
    args = tuple(map(torch.from_numpy, (q, k, v, pos)))
    q5 = args[0].reshape(2, 24, 1, 4, 16)
    k7 = attention.flash_attention_prefill_plain(q5, args[1], args[2], args[3][:, 0])
    k7 = k7.reshape(2, 24, 64).numpy()
    np.testing.assert_allclose(k7, attention.attention_math(*args).numpy(), atol=2e-5)
    np.testing.assert_allclose(k7, attention.flash_attention(*args).numpy(), atol=2e-5)


def test_k7_row_that_sees_nothing_is_nan_as_in_jax():
    """A negative start leaves row 0 without a visible slot: NaN in both,
    and the rows that do see slots are unharmed."""
    q, k, v, pos = _inputs(1, 8, 2, 2, 16, 64, [-1], seed=7)
    want = _jax_k7(q, k, v, pos)
    got = attention.flash_attention_prefill_plain(
        torch.from_numpy(q).reshape(1, 8, 2, 1, 16), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(pos[:, 0])).reshape(1, 8, 32).numpy()
    assert np.isnan(want[0, 0]).all() and np.isnan(got[0, 0]).all()
    np.testing.assert_allclose(got[0, 1:], want[0, 1:], atol=2e-5)


@pytest.mark.parametrize("case", ["long", "hd", "g", "dtype", "cache", "aligned"])
def test_k7_cuda_arg_checks(case):
    """What the CUDA wrapper hands the kernel: any t, g <= 8, hd 64 or 128."""
    b, t, kv, g, hd, s = 1, 256, 2, 2, 128, 300
    q5 = torch.zeros((b, t, kv, g, hd), dtype=torch.bfloat16)
    kc = torch.zeros((b, kv, s, hd), dtype=torch.bfloat16)
    pos0 = torch.zeros(b, dtype=torch.int32)
    attention._check_cuda_args(q5, kc, kc, pos0, max_t=None)  # well-formed
    if case == "long":
        with pytest.raises(ValueError):  # K2's check still refuses t > 32
            attention._check_cuda_args(q5, kc, kc, pos0)
        return
    if case == "hd":
        q5, kc = q5[..., :48].contiguous(), kc[..., :48].contiguous()
    elif case == "g":
        q5 = torch.zeros((b, t, kv, 9, hd), dtype=torch.bfloat16)
    elif case == "dtype":
        kc = kc.float()
    elif case == "cache":
        kc = torch.zeros((b, kv + 1, s, hd), dtype=torch.bfloat16)
    else:
        q5 = torch.zeros(q5.numel() + 1, dtype=torch.bfloat16)[1:].reshape(q5.shape)
    with pytest.raises(ValueError):
        attention._check_cuda_args(q5, kc, kc, pos0, max_t=None)


# -------------------------------------------------------------- the gate


def test_gate_defaults_are_the_jax_defaults():
    """The JAX package's switches and, on the CPU, its routing; the card
    ("meta") has a default of its own for windows of t > 32: with no floor
    in the environment (None) it sends them to K7."""
    assert attention._MIN_PREFILL_SCORES is None
    assert attention._JAX_PREFILL_SCORES == jattention._MIN_PREFILL_SCORES == 1024 * GB
    assert attention._MIN_DECODE_TRAFFIC == jattention._MIN_DECODE_TRAFFIC == 0
    assert attention._LENAWARE is jattention._LENAWARE is True
    q, kc = torch.zeros((1, 40, 4, 16)), torch.zeros((1, 2, 64, 16))
    assert not attention.can_fuse_attention(q, kc)  # prefill on the CPU: the einsum math
    assert attention.can_fuse_attention(q[:, :32], kc)  # t <= 32: K2
    q, kc = torch.empty((1, 40, 4, 128), device="meta"), torch.empty((1, 2, 64, 128),
                                                                      device="meta")
    assert attention.can_fuse_attention(q, kc)  # prefill on the card: K7
    assert attention.can_fuse_attention(q[:, :32], kc)  # t <= 32: K2


_B, _H, _KV, _HD, _S = 2, 4, 2, 128, 256
_CACHE_BYTES = 2 * _B * _KV * _S * _HD * 4  # f32 caches


def _score_bytes(t):
    return 4 * _B * _KV * (_H // _KV) * t * _S


@pytest.mark.parametrize("t,lenaware,prefill_floor,decode_floor", [
    (1, True, 1024 * GB, 0), (32, True, 1024 * GB, 0), (33, True, 1024 * GB, 0),
    (256, True, 1024 * GB, 0), (33, True, 0, 0), (256, True, 0, 0),
    (64, True, _score_bytes(64), 0), (64, True, _score_bytes(64) + 1, 0),
    (16, True, 0, _CACHE_BYTES), (16, True, 0, _CACHE_BYTES + 1),
    (16, False, 1024 * GB, 0), (16, False, 0, _CACHE_BYTES + 1), (64, False, 0, 0),
    (64, False, 1024 * GB, 0)])
def test_gate_routes_as_the_jax_gate(monkeypatch, t, lenaware, prefill_floor, decode_floor):
    for mod in (attention, jattention):
        monkeypatch.setattr(mod, "_LENAWARE", lenaware)
        monkeypatch.setattr(mod, "_MIN_PREFILL_SCORES", prefill_floor)
        monkeypatch.setattr(mod, "_MIN_DECODE_TRAFFIC", decode_floor)
    monkeypatch.setattr(jkernels, "FORCE_INTERPRET", False)
    monkeypatch.setattr(jkernels, "_on_tpu", lambda: True)
    want = jattention.can_fuse_attention(jnp.zeros((_B, t, _H, _HD), jnp.float32),
                                         jnp.zeros((_B, _KV, _S, _HD), jnp.float32))
    for dev in ("cpu", "meta"):  # "meta" stands for the card: the gate reads shapes only
        got = attention.can_fuse_attention(torch.empty((_B, t, _H, _HD), device=dev),
                                           torch.empty((_B, _KV, _S, _HD), device=dev))
        assert got == want, dev


@pytest.mark.parametrize("t", [8, 40])
def test_gate_with_floor_zero_agrees_with_jax_in_interpret_mode(monkeypatch, t):
    monkeypatch.setattr(attention, "_MIN_PREFILL_SCORES", 0)
    assert jattention.can_fuse_attention(jnp.zeros((1, t, 4, 16)), jnp.zeros((1, 2, 64, 16)))
    assert attention.can_fuse_attention(torch.zeros((1, t, 4, 16)), torch.zeros((1, 2, 64, 16)))


@pytest.mark.parametrize("case", ["hd", "g", "dtype", "mixed"])
def test_gate_refuses_on_the_card_what_the_kernels_do_not_take(monkeypatch, case):
    """Off the CPU an unsupported geometry goes to the math (no raise); the
    plain versions on the CPU take any."""
    monkeypatch.setattr(attention, "_MIN_PREFILL_SCORES", 0)
    shape = dict(hd=128, h=8, kv=2, qd=torch.bfloat16, cd=torch.bfloat16)
    shape.update({"hd": dict(hd=16), "g": dict(h=18), "dtype": dict(qd=torch.float16,
                                                                    cd=torch.float16),
                  "mixed": dict(cd=torch.float32)}[case])
    for t in (16, 64):
        for dev, want in (("meta", False), ("cpu", True)):
            q = torch.empty((1, t, shape["h"], shape["hd"]), dtype=shape["qd"], device=dev)
            kc = torch.empty((1, shape["kv"], 64, shape["hd"]), dtype=shape["cd"], device=dev)
            assert attention.can_fuse_attention(q, kc) == want
    ok = torch.empty((1, 64, 8, 128), dtype=torch.bfloat16, device="meta")
    assert attention.can_fuse_attention(ok, torch.empty((1, 2, 64, 128), dtype=torch.bfloat16,
                                                        device="meta"))


# The cells' geometry per batch row: Mistral-7B's 32 query heads over 8 KV
# heads of 128 (g = 4), a bf16 cache.
_CELL_H, _CELL_KV, _CELL_HD = 32, 8, 128


def _jax_gate_on_the_card(monkeypatch, t, s, dtype):
    """What the JAX gate says on a TPU at its default floor (nothing is
    launched: the gate reads shapes)."""
    monkeypatch.setattr(jkernels, "FORCE_INTERPRET", False)
    monkeypatch.setattr(jkernels, "_on_tpu", lambda: True)
    return jattention.can_fuse_attention(jnp.zeros((1, t, _CELL_H, _CELL_HD), dtype),
                                         jnp.zeros((1, _CELL_KV, s, _CELL_HD), dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("t,s", [(33, 2048), (256, 2048), (1024, 8192)])
def test_card_default_sends_long_windows_to_k7(monkeypatch, t, s, dtype):
    """No floor in the environment: the card takes K7 for every window of
    t > 32 over the dense bf16 or f32 cache, the CPU the einsum math as
    the JAX gate does at its default."""
    monkeypatch.setattr(attention, "_MIN_PREFILL_SCORES", None)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    assert not _jax_gate_on_the_card(monkeypatch, t, s, jdtype)
    for dev, want in (("meta", True), ("cpu", False)):
        q = torch.empty((1, t, _CELL_H, _CELL_HD), dtype=dtype, device=dev)
        kc = torch.empty((1, _CELL_KV, s, _CELL_HD), dtype=dtype, device=dev)
        assert attention.can_fuse_attention(q, kc) == want, dev
        assert attention.can_fuse_attention(q[:, :32], kc), dev  # t <= 32: K2 on both


_FLOOR_PROBE = """
import torch
from llamago_tpu_torch.ops import attention
out = []
for dev in ("cpu", "meta"):
    q = torch.empty((1, 64, 32, 128), dtype=torch.bfloat16, device=dev)
    kc = torch.empty((1, 8, 2048, 128), dtype=torch.bfloat16, device=dev)
    out.append(attention.can_fuse_attention(q, kc))
print(attention._MIN_PREFILL_SCORES, *out)
"""


@pytest.mark.parametrize("floor,want", [
    (None, "None False True"), ("0", "0 True True"),
    (str(1024 * GB), f"{1024 * GB} False False"),
    (str(4 * 8 * 4 * 64 * 2048), f"{4 * 8 * 4 * 64 * 2048} True True"),
    (str(4 * 8 * 4 * 64 * 2048 + 1), f"{4 * 8 * 4 * 64 * 2048 + 1} False False")],
    ids=["unset", "zero", "jax-default", "at-the-scores", "above-the-scores"])
def test_prefill_floor_in_the_environment_rules_on_both_devices(floor, want):
    """LLAMAGO_ATTN_PREFILL_FLOOR as the process reads it at import: where
    it is set, the CPU and the card ("meta") route a 64-row window over a
    2048-slot cache alike; unset, each device takes its own default."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "LLAMAGO_ATTN_PREFILL_FLOOR"}
    if floor is not None:
        env["LLAMAGO_ATTN_PREFILL_FLOOR"] = floor
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FLOOR_PROBE], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == want


def _route_calls(monkeypatch):
    """The model's two routes for the dense and the int8 cache, recorded
    and not run (meta tensors stand for the card's)."""
    calls = []
    monkeypatch.setattr(llama, "flash_attention", lambda *a: calls.append("k7"))
    monkeypatch.setattr(llama, "flash_attention_quant", lambda *a: calls.append("quant"))
    monkeypatch.setattr(llama, "attention_math", lambda *a: calls.append("math"))
    return calls


@pytest.mark.parametrize("case", ["bf16", "f32", "hd", "g", "f16", "mixed", "int8"])
def test_card_default_sends_refused_geometries_and_the_int8_cache_to_the_math(
        monkeypatch, case):
    """No floor in the environment, a 64-row window on the card: K7 where
    its geometry holds; a head size, group or dtype it does not take, and
    the int8 cache (there is no quantized K7), go to the einsum math."""
    monkeypatch.setattr(attention, "_MIN_PREFILL_SCORES", None)
    h, kv, hd, qd, cd = _CELL_H, _CELL_KV, _CELL_HD, torch.bfloat16, torch.bfloat16
    if case == "f32":
        qd = cd = torch.float32
    elif case == "hd":
        h, hd = 128, 32  # the quality gate's proxy: hd 32
    elif case == "g":
        h = 9 * kv
    elif case == "f16":
        qd = cd = torch.float16
    elif case in ("mixed", "int8"):
        cd = torch.float32 if case == "mixed" else torch.int8
    q = torch.empty((1, 64, h, hd), dtype=qd, device="meta")
    kc = torch.empty((1, kv, 2048, hd), dtype=cd, device="meta")
    scales = (torch.empty((1, kv, 2048), device="meta"),) * 2 if case == "int8" else (None,) * 2
    calls = _route_calls(monkeypatch)
    llama._attention(q, kc, kc, torch.empty((1, 64), dtype=torch.long, device="meta"), *scales)
    assert calls == (["k7"] if case in ("bf16", "f32") else ["math"])
    assert attention.can_fuse_attention(q, kc) == (case in ("bf16", "f32"))


# bf16 outputs of size ~1 (V's rows are unit normals): K7's plain version
# and the einsum math compute the same f32 scores and softmax and round the
# probabilities to bf16 alike; only the order of the f32 sums differs, so
# they stay within one bf16 rounding of the output (2^-8 relative)
_CELL_ATTN_TOL = 1e-2
# the model's logits in bf16 through two layers: the attention outputs above
# go on through bf16 matmuls and norms, where one rounding apart can become a
# few; x max|logit|
_CELL_LOGIT_TOL = 2e-2


def test_k7_route_matches_the_math_at_the_cells_geometry():
    """The cells' attention on the CPU, cut in length: 32 query heads over 8
    KV heads of 128, a bf16 cache of 512 slots, a 64-row window written at
    position 200. `flash_attention`'s K7 route (its plain version here)
    against `attention_math`."""
    q, k, v, pos = _inputs(1, 64, _CELL_H, _CELL_KV, _CELL_HD, 512, [200], seed=28)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tp = torch.from_numpy(pos)
    calls = []
    fn = attention.flash_attention_prefill_plain

    def counted(*args):
        calls.append(1)
        return fn(*args)

    attention.flash_attention_prefill_plain = counted
    try:
        got = attention.flash_attention(tq, tk, tv, tp)
    finally:
        attention.flash_attention_prefill_plain = fn
    assert calls == [1] and got.dtype == torch.bfloat16
    want = attention.attention_math(tq, tk, tv, tp)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _CELL_ATTN_TOL, err


def test_forward_through_the_k7_route_at_the_cells_geometry(monkeypatch):
    """Two layers of a bf16 model with the cells' head geometry (4 query
    heads over 1 KV head of 128, g = 4) and a bf16 cache of 256 slots: a
    40-token prefill, then a 64-token window at position 40, once through
    the card's route (the floor at 0 on the CPU: K7's plain version, a call
    a layer in each window) and once through the einsum math; the logits
    agree and the K7 route's calls rise in both windows."""
    cfg = MODEL_PRESETS["tiny-gqa"].replace(dim=512, n_heads=4, n_kv_heads=1, ffn_dim=256,
                                            dtype="bfloat16", weight_dtype="bfloat16",
                                            max_seq_len=256)
    params = random_parameters(cfg, seed=28, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(28).integers(1, 500, (1, 104)))
    logits = {}
    for route, floor in (("k7", 0), ("math", 1024 * GB)):
        monkeypatch.setattr(attention, "_MIN_PREFILL_SCORES", floor)
        k7 = _count_calls(monkeypatch, attention, "flash_attention_prefill_plain")
        cache = KVCache.create(cfg, batch=1, device="cpu")
        assert cache.k[0].dtype == torch.bfloat16
        seen = []
        for lo, hi in ((0, 40), (40, 104)):
            lg, cache = llama.forward_impl(params, toks[:, lo:hi], cache,
                                           torch.tensor([lo]), cfg, return_all_logits=True)
            seen.append(len(k7))
        logits[route] = lg.float()
        assert seen == ([cfg.n_layers, 2 * cfg.n_layers] if route == "k7" else [0, 0])
        monkeypatch.undo()
    scale = logits["math"].abs().max().item()
    err = (logits["k7"] - logits["math"]).abs().max().item() / scale
    assert err <= _CELL_LOGIT_TOL, err


# ------------------------------------------------------ model and engine


def _dense(name, seed=3, **over):
    jcfg = JPRESETS[name].replace(dtype="float32", weight_dtype="float32", **over)
    host = host_parameters(jcfg, random_ggjt_tensors(jcfg, seed=seed))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), host)
    cfg = MODEL_PRESETS[name].replace(dtype="float32", weight_dtype="float32", **over)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_forward_with_k7_and_k10_on_matches_jax(opt_in, monkeypatch, name):
    """A 40-token prefill (K7), then greedy decode steps (K2), every norm
    through K10, in both packages."""
    jcfg, jp, cfg, tp = _dense(name)
    jp = unstack_layer_params(jp, jcfg.n_layers)
    jk7 = _count_calls(monkeypatch, jattention, "_flash_attention")
    jk10 = _count_calls(monkeypatch, jkernels, "fused_rms_norm")
    k7 = _count_calls(monkeypatch, attention, "flash_attention_prefill_plain")
    k10 = _count_calls(monkeypatch, kernels, "fused_rms_norm_plain")
    toks = np.random.default_rng(0).integers(1, 500, (2, 40)).astype(np.int32)
    jcache = JKVCache.create(jcfg, batch=2, layered=True)
    cache = KVCache.create(cfg, batch=2, device="cpu")
    before = _launches()
    jl, jcache = jllama.forward(jp, jnp.asarray(toks), jcache, jnp.zeros(2, jnp.int32), jcfg)
    tl, cache = llama.forward_impl(tp, torch.from_numpy(toks), cache,
                                   torch.zeros(2, dtype=torch.long), cfg)
    n_norms = 2 * cfg.n_layers + 1
    assert (len(jk7), len(jk10)) == (cfg.n_layers, n_norms)  # traced once per call site
    assert (len(k7), len(k10)) == (cfg.n_layers, n_norms)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for i in range(4):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        assert tt.tolist() == np.asarray(jt).tolist()
        pos = 40 + i
        jl, jcache = jllama.forward(jp, jt[:, None], jcache, jnp.full((2,), pos, jnp.int32),
                                    jcfg)
        tl, cache = llama.forward_impl(tp, tt[:, None], cache, torch.full((2,), pos), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert len(k7) == cfg.n_layers and len(k10) == 5 * n_norms  # decode: K2, not K7
    assert _launches() == before  # plain versions on the CPU
    for layer in range(cfg.n_layers):
        np.testing.assert_allclose(cache.k[layer].numpy(), np.asarray(jcache.k[layer]),
                                   rtol=1e-4, atol=1e-5)


def test_forward_default_routes_use_neither_k7_nor_k10(monkeypatch):
    _, _, cfg, tp = _dense("tiny")
    k7 = _count_calls(monkeypatch, attention, "flash_attention_prefill_plain")
    k10 = _count_calls(monkeypatch, kernels, "fused_rms_norm_plain")
    math = _count_calls(monkeypatch, llama, "attention_math")
    toks = torch.from_numpy(np.random.default_rng(1).integers(1, 500, (1, 40)))
    llama.forward_impl(tp, toks, KVCache.create(cfg, batch=1, device="cpu"),
                       torch.zeros(1, dtype=torch.long), cfg)
    assert not k7 and not k10 and len(math) == cfg.n_layers


def test_int8_cache_prefill_keeps_the_math_with_the_floor_at_zero(opt_in, monkeypatch):
    """The JAX package has no quantized K7: t > 32 over the int8 cache takes
    the scale-folded math in both."""
    jcfg, jp, cfg, tp = _dense("tiny", kv_dtype="int8")
    jp = unstack_layer_params(jp, jcfg.n_layers)
    k7 = _count_calls(monkeypatch, attention, "flash_attention_prefill_plain")
    math = _count_calls(monkeypatch, llama, "attention_math")
    toks = np.random.default_rng(2).integers(1, 500, (1, 40)).astype(np.int32)
    jl, _ = jllama.forward(jp, jnp.asarray(toks), JKVCache.create(jcfg, batch=1, layered=True),
                           jnp.zeros(1, jnp.int32), jcfg)
    tl, _ = llama.forward_impl(tp, torch.from_numpy(toks),
                               KVCache.create(cfg, batch=1, device="cpu"),
                               torch.zeros(1, dtype=torch.long), cfg)
    assert not k7 and len(math) == cfg.n_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [1, 4])
def test_engine_greedy_tokens_with_k7_and_k10_on_match_jax(opt_in, monkeypatch, chunk):
    """A prompt of more than 32 tokens (a 64-token bucket through K7), then
    decode; the warm-up runs one prefill per bucket through the same gate."""
    jcfg, jp, cfg, tp = _dense("tiny", max_seq_len=128)
    k7 = _count_calls(monkeypatch, attention, "flash_attention_prefill_plain")
    k10 = _count_calls(monkeypatch, kernels, "fused_rms_norm_plain")
    prompt = "hello world " * 20
    buckets = (16, 32, 64)
    jeng = JEngine(jcfg, jp, make_test_vocab(), slots=2, buckets=buckets,
                   decode_chunk_size=chunk)
    want = jeng.generate(prompt, JGen(max_tokens=8, ctx_size=128, temp=0.0))
    eng = Engine(cfg, tp, Vocab(list(make_test_vocab().tokens)), slots=2, buckets=buckets,
                 decode_chunk_size=chunk, device="cpu")
    before = _launches()
    job = eng.generate(prompt, GenerateConfig(max_tokens=8, ctx_size=128, temp=0.0))
    assert job.status == JobStatus.FINISHED and 32 < job.prompt_tokens <= 64
    assert job.prompt_tokens == want.prompt_tokens
    assert job.output_tokens == want.output_tokens and len(job.output_tokens) == 8
    assert len(k7) == cfg.n_layers and k10
    n = len(k7)
    eng.warmup(include_embed=False)
    assert len(k7) == n + cfg.n_layers  # the 64 bucket, not the 16 and 32 ones
    assert _launches() == before
