"""Port parity of the quantizers and the `quantize` tool (checkpoint/
quant_file.py, native/, ops/quant.py:quantize_ggjt_tensors) and of the
dense parameter builders (checkpoint/params.py: export_ggjt_tensors,
random_parameters).

The same inputs, made from a seed with numpy, go through the JAX function
and the port's; blocks, files and leaves must be equal bit for bit, on the
native (g++) path and on the numpy path.
"""

import filecmp
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from llamago_tpu import native as jnative
from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.checkpoint import quant_file as jq
from llamago_tpu.checkpoint.ggjt import write_ggjt as jwrite_ggjt
from llamago_tpu.checkpoint.ggjt import write_meta_sidecar as jwrite_meta_sidecar
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.ops import quant as jquant
from llamago_tpu_torch import native
from llamago_tpu_torch.checkpoint import params
from llamago_tpu_torch.checkpoint import quant_file as pq
from llamago_tpu_torch.checkpoint.ggjt import read_ggjt, write_ggjt, write_meta_sidecar
from llamago_tpu_torch.config import MODEL_PRESETS
from llamago_tpu_torch.ops import quant
from llamago_tpu_torch.tokenizer import Vocab
from llamago_tpu_torch.tokenizer_bpe import BPEVocab, bytes_to_unicode

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KINDS = ("q8_0", "q4_0", "q4_1")
NUMPY_Q = {"q8_0": pq.quantize_rows_q8_0, "q4_0": pq.quantize_rows_q4_0,
           "q4_1": pq.quantize_rows_q4_1}
JNUMPY_Q = {"q8_0": jq.quantize_rows_q8_0, "q4_0": jq.quantize_rows_q4_0,
            "q4_1": jq.quantize_rows_q4_1}


def _rows(seed: int, out: int, k: int) -> np.ndarray:
    """Random rows with the blocks that decide a quantizer's edge cases: an
    all-zero block, a constant block, ties at half steps, a negative signed
    extreme, a huge and a tiny block."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((out, k)) * 0.05).astype(np.float32)
    x[0, :32] = 0
    if out > 1:
        x[1, :32] = 0.25
        x[1, 32:64] = np.arange(32, dtype=np.float32) - 15.5
    if out > 2:
        x[2, :32] *= 1e4
        x[2, 5] = -3e4
        x[2, 32:64] *= 1e-6
    return x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(3, 64), (5, 160), (1, 32)])
def test_numpy_quantizers_match_jax_bit_for_bit(kind, shape):
    x = _rows(sum(shape), *shape)
    np.testing.assert_array_equal(NUMPY_Q[kind](x), JNUMPY_Q[kind](x))
    np.testing.assert_array_equal(NUMPY_Q[kind](x.astype(np.float16)),
                                  JNUMPY_Q[kind](x.astype(np.float16)))


@pytest.mark.parametrize("kind", ("q8_0", "q4_0"))
def test_native_quantizers_match_jax_numpy(kind):
    assert native.available()
    x = _rows(11, 7, 256)
    np.testing.assert_array_equal(native.quantize_rows(kind)(x), JNUMPY_Q[kind](x))
    assert native.quantize_rows("q4_1") is None  # numpy-only kind


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_quantize_array_matches_jax(kind, path, monkeypatch):
    """quantize_array on either path gives the JAX package's blocks (the
    JAX side on its own native-or-numpy path)."""
    if path == "numpy":
        monkeypatch.setattr(native, "quantize_rows", lambda kind: None)
    x = _rows(3, 6, 96)
    got, want = pq.quantize_array(x, kind), jq.quantize_array(x, kind)
    assert got.kind == want.kind and got.shape == want.shape == (6, 96)
    np.testing.assert_array_equal(got.raw, want.raw)
    np.testing.assert_array_equal(pq.dequantize_rows(got), jq.dequantize_rows(want))


def test_native_fp16_widening_and_transpose_match_jax():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 1 << 16, 4096, dtype=np.uint16)  # every kind of half
    h = bits.view(np.float16)
    got, want = native.fp16_to_fp32(h), jnative.fp16_to_fp32(h)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), h.astype(np.float32).view(np.uint32))
    m = rng.standard_normal((37, 53)).astype(np.float32)
    np.testing.assert_array_equal(native.transpose_f32(m), m.T)


def test_native_library_builds_into_build_not_beside_its_source():
    assert native.build()
    lib = pathlib.Path(native.lib_path())
    assert lib.exists() and lib.parent == ROOT / "build"
    assert not list((ROOT / "llamago_tpu_torch" / "native").glob("*.so"))


@pytest.mark.parametrize("kind", KINDS)
def test_to_device_leaf_matches_jax(kind):
    qt = pq.quantize_array(_rows(5, 8, 128), kind)
    jleaf = jq.to_device_leaf(jq.QuantTensor(kind, qt.raw, qt.shape))
    leaf = pq.to_device_leaf(qt, "cpu")
    assert sorted(leaf) == sorted(jleaf)
    for key, v in leaf.items():
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(jleaf[key]))


@pytest.fixture(scope="module")
def f32_files(tmp_path_factory):
    """The same tiny-gqa f32 model written by each package, with an FFN
    width (48) that leaves w2's in-dim no multiple of 32."""
    d = tmp_path_factory.mktemp("quant")
    cfg = MODEL_PRESETS["tiny-gqa"].replace(ffn_dim=48, rope_theta=500000.0)
    jcfg = JPRESETS["tiny-gqa"].replace(ffn_dim=48, rope_theta=500000.0)
    tensors = random_ggjt_tensors(cfg, seed=21)
    write_ggjt(str(d / "p.bin"), cfg, Vocab(make_test_vocab().tokens), tensors)
    write_meta_sidecar(str(d / "p.bin"), cfg)
    jwrite_ggjt(str(d / "j.bin"), jcfg, make_test_vocab(), tensors)
    jwrite_meta_sidecar(str(d / "j.bin"), jcfg)
    assert filecmp.cmp(d / "p.bin", d / "j.bin", shallow=False)
    return d


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ext", [".bin", ".gguf"])
def test_quantize_ggjt_writes_the_jax_packages_bytes(f32_files, kind, ext):
    """quantize_ggjt to ggjt (with its sidecar) and to GGUF: the port's
    file equals the JAX package's; w2 (in-dim 48) stays dense."""
    d = f32_files
    got = pq.quantize_ggjt(str(d / "p.bin"), str(d / f"p-{kind}{ext}"), kind)
    want = jq.quantize_ggjt(str(d / "j.bin"), str(d / f"j-{kind}{ext}"), kind)
    assert filecmp.cmp(got, want, shallow=False)
    if ext == ".bin":
        assert filecmp.cmp(got + ".meta.json", want + ".meta.json", shallow=False)
        ck = read_ggjt(got)
        assert ck.ftype == {"q8_0": 7, "q4_0": 2, "q4_1": 3}[kind]
        assert ck.config.rope_theta == 500000.0
        w2 = ck.tensors["layers.0.feed_forward.w2.weight"]
        assert isinstance(w2, np.ndarray) and w2.dtype == np.float32
        assert isinstance(ck.tensors["layers.0.feed_forward.w1.weight"], pq.QuantTensor)


def test_quantize_ggjt_of_a_bpe_model_needs_gguf(tmp_path):
    from llamago_tpu_torch.checkpoint.gguf import write_gguf

    b2u = bytes_to_unicode()
    vocab = BPEVocab(tokens=["<s>", "</s>"] + [b2u[b] for b in range(256)], merges={},
                     bos_id=0, eos_id=1)
    cfg = MODEL_PRESETS["tiny-gqa"].replace(vocab_size=len(vocab))
    path = str(tmp_path / "bpe.gguf")
    write_gguf(path, cfg, vocab, random_ggjt_tensors(cfg, seed=2))
    with pytest.raises(ValueError, match=r"\.gguf"):
        pq.quantize_ggjt(path, str(tmp_path / "bpe-q8.bin"), "q8_0")
    out = pq.quantize_ggjt(path, str(tmp_path / "bpe-q8.gguf"), "q8_0")
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_ggjt_tensors_matches_jax(bits):
    tensors = random_ggjt_tensors(MODEL_PRESETS["tiny-gqa"], seed=9)
    got = quant.quantize_ggjt_tensors(tensors, bits)
    want = jquant.quantize_ggjt_tensors(tensors, bits)
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        if isinstance(leaf, dict):
            assert sorted(leaf) == sorted(want[name]), name
            for key, v in leaf.items():
                w = np.asarray(want[name][key])
                assert str(v.dtype).split(".")[-1] == w.dtype.name, (name, key)
                np.testing.assert_array_equal(v.float().numpy(), w.astype(np.float32))
        else:
            np.testing.assert_array_equal(leaf, want[name])


@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_export_ggjt_tensors_inverts_params_from_numpy(layered, dtype):
    """file tensors -> host_parameters -> params_from_numpy (torch, [in,
    out]) -> export_ggjt_tensors gives the file tensors back, bit for bit;
    the JAX exporter agrees on the same tree."""
    cfg = MODEL_PRESETS["tiny-gqa"]
    tensors = {k: v.astype(dtype) for k, v in random_ggjt_tensors(cfg, seed=12).items()}
    host = params.host_parameters(cfg, tensors)
    tree = params.params_from_numpy(host, device="cpu")
    if layered:
        tree = params.unstack_layer_params(tree, cfg.n_layers)
    back = params.export_ggjt_tensors(cfg, tree)
    jback = jparams.export_ggjt_tensors(JPRESETS["tiny-gqa"], jax.tree.map(np.asarray, host))
    assert list(back) == list(jback)
    for name, arr in back.items():
        assert arr.dtype == tensors[name].dtype and arr.flags.c_contiguous, name
        np.testing.assert_array_equal(arr, tensors[name], err_msg=name)
        np.testing.assert_array_equal(arr, jback[name], err_msg=name)


def test_export_ggjt_tensors_widens_bf16_and_refuses_quantized():
    cfg = MODEL_PRESETS["tiny"].replace(weight_dtype="bfloat16")
    tree = params.random_parameters(cfg, seed=1, device="cpu")
    out = params.export_ggjt_tensors(cfg, tree)
    assert out["layers.1.attention.wq.weight"].dtype == np.float32
    np.testing.assert_array_equal(out["output.weight"],
                                  tree["output"].float().numpy().T)
    q = params.random_parameters(cfg.replace(weight_dtype="int8"), device="cpu")
    with pytest.raises(ValueError, match="dense"):
        params.export_ggjt_tensors(cfg, q)


def _layout(tree) -> dict:
    """path -> (shape, dtype name) of every leaf, dicts flattened."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        else:
            out[prefix] = (tuple(x.shape), str(x.dtype).split(".")[-1])

    walk("", tree)
    return out


@pytest.mark.parametrize("weight_dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("preset", ["tiny", "tiny-gqa"])
def test_random_parameters_has_the_jax_functions_layout(weight_dtype, preset, monkeypatch):
    """Shapes, dtypes and quantized leaf layouts equal the JAX function's
    (int4 in the Q4_0 exec format on both sides)."""
    monkeypatch.setenv("LLAMAGO_INT4_EXEC", "q4_0")
    cfg = MODEL_PRESETS[preset].replace(weight_dtype=weight_dtype)
    got = params.random_parameters(cfg, seed=3, device="cpu")
    want = jparams.random_parameters(JPRESETS[preset].replace(weight_dtype=weight_dtype),
                                     seed=3)
    assert _layout(got) == _layout(jax.tree.map(np.asarray, want))
    again = params.random_parameters(cfg, seed=3, device="cpu")
    assert torch.equal(got["tok_embeddings"], again["tok_embeddings"])
    assert torch.equal(got["norm"], torch.ones_like(got["norm"]))


def test_random_parameters_w4x8_and_padded_head():
    """int4 under the w4x8 exec format re-lays leaves whose K is a multiple
    of 128; the int8 head of a 32000-wide vocab is column-padded."""
    cfg = MODEL_PRESETS["tiny"].replace(dim=128, n_heads=2, ffn_dim=256,
                                        weight_dtype="int4", vocab_size=600)
    os.environ["LLAMAGO_INT4_EXEC"] = "w4x8"
    try:
        tree = params.random_parameters(cfg, device="cpu")
    finally:
        del os.environ["LLAMAGO_INT4_EXEC"]
    assert "q4x" in tree["layers"]["wq"] and tree["layers"]["wq"]["s"].shape == (2, 2, 128)
    assert "q4x" in tree["layers"]["w2"]
    head = params.random_parameters(cfg.replace(weight_dtype="int8", vocab_size=32000,
                                                n_layers=1), device="cpu")["output"]
    assert head["q8"].shape == (128, 32768)


@pytest.mark.parametrize("kind", KINDS)
def test_host_parameters_of_a_quantized_file_match_jax(kind):
    """Every 2-D tensor quantized, the embedding table too: the port splits
    and transposes the blocks (and dequantizes the table) with torch on the
    load's device; the leaves equal the JAX package's numpy ones bit for
    bit."""
    cfg = MODEL_PRESETS["tiny-gqa"]
    tensors = {k: (pq.quantize_array(v, kind) if v.ndim == 2 else v)
               for k, v in random_ggjt_tensors(cfg, seed=14).items()}
    jtensors = {k: (jq.QuantTensor(v.kind, v.raw, v.shape) if isinstance(v, pq.QuantTensor)
                    else v) for k, v in tensors.items()}
    host = params.host_parameters(cfg, tensors)
    jhost = jparams.host_parameters(JPRESETS["tiny-gqa"], jtensors)
    flat, jflat = jax.tree_util.tree_flatten_with_path(host)[0], \
        jax.tree_util.tree_flatten_with_path(jhost)[0]
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    for (path, a), (_, b) in zip(flat, jflat):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
