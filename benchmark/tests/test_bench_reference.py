"""The reference against the port at a tiny size on the CPU, and the control
against the limit.

The port is fed the benchmark's checkpoint the way a run feeds it
(`kinds/serve.py`: load_parameters, then the fused leaves); the reference
draws the same blocks again and works everything out itself. In f32 the
two agree to rounding; in bf16 the widest gap of the port's first choices
stays under the tiny cell's limit while the fp8 control's goes over it."""

import ast
import os

import pytest
import torch

from benchmark.reference.dims import load_dims
from benchmark.tests.conftest import ROOT
from benchmark.tests.tiny import TINY_LIMIT, make_root, run_tiny


def _dims(tmp_path, kv_cache, n_kv, compute):
    root = make_root(tmp_path, kv_cache=kv_cache, n_kv_heads=n_kv)
    d = load_dims(os.path.join(root, "benchmark", "configs", "tiny.json"))
    return d.__class__(**{**d.__dict__, "compute": compute})


def _port_logits(dims, seed, ids, context=64):
    """The port's logits at every position of `ids`, from the checkpoint a
    run hands it."""
    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        load_parameters,
        unstack_layer_params,
    )
    from llamago_tpu_torch.models.llama import forward_impl
    from llamago_tpu_torch.runtime.kv_cache import KVCache

    from benchmark.kinds import serve

    config = serve._model_config(dims, {"context": context})
    params = load_parameters(config, serve.checkpoint_tensors(dims, seed, "cpu"), device="cpu")
    params = fuse_layer_weights(unstack_layer_params(params, config.n_layers))
    cache = KVCache.create(config, batch=1, device="cpu")
    logits, _ = forward_impl(params, torch.tensor([ids]), cache, torch.zeros(1, dtype=torch.long),
                             config, return_all_logits=True)
    return logits[0]


@pytest.mark.parametrize("kv_cache,n_kv", [("bfloat16", 2), ("int8", 4)])
def test_port_matches_reference_in_f32(tmp_path, kv_cache, n_kv):
    from benchmark.reference.model import logits_at

    dims = _dims(tmp_path, "float32" if kv_cache == "bfloat16" else kv_cache, n_kv, "float32")
    ids = [1, 35] + [100 + (7 * i) % 26 for i in range(40)]
    port = _port_logits(dims, 12345, ids)
    ref = logits_at(dims, 12345, [ids], [list(range(len(ids)))], "cpu")[0]
    scale = ref.abs().max()
    # the int8 cache rounds rows the two sides computed in another order
    tol = 1e-5 if kv_cache != "int8" else 2e-2
    assert (port - ref).abs().max() <= tol * scale


def test_port_in_bf16_is_close_to_reference(tmp_path):
    from benchmark.reference.model import logits_at

    dims = _dims(tmp_path, "bfloat16", 2, "bfloat16")
    ids = [1, 35] + [100 + (5 * i) % 26 for i in range(40)]
    port = _port_logits(dims, 7, ids)
    ref = logits_at(dims, 7, [ids], [list(range(len(ids)))], "cpu")[0]
    err = (port - ref).abs().max() / ref.abs().max()
    assert 1e-4 < err < 5e-2  # bf16: not exact, not far


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2**31 + 5])
def test_control_fails_and_the_program_passes(tmp_path, seed):
    """With the control in the program's place, the run's own comparison
    comes out not correct; the program's gap of the same run is within."""
    line = run_tiny(make_root(tmp_path), seed=seed, seconds=2.0, control=True)
    assert line["correct"] is False
    assert line["check"]["max_logit_gap"]["value"] > TINY_LIMIT
    assert line["check"]["max_logit_gap"]["limit"] == TINY_LIMIT
    assert line["control"]["program_max_logit_gap"] <= TINY_LIMIT


def test_fp8_round_is_coarser_than_bf16():
    from benchmark.reference.model import fp8_round

    x = torch.randn(4, 256)
    e8 = ((fp8_round(x) - x).abs().max(dim=-1).values / x.abs().max(dim=-1).values).max()
    e16 = ((x.bfloat16().float() - x).abs().max(dim=-1).values / x.abs().max(dim=-1).values).max()
    assert e8 > 4 * e16 and e8 < 0.07


def test_int8_rows_round_to_the_scale():
    from benchmark.reference.model import int8_rows

    x = torch.tensor([[1.0, -0.5, 0.25, 0.0], [0.0, 0.0, 0.0, 0.0]])
    y = int8_rows(x)
    s = 1.0 / 127
    assert torch.allclose(y[0], torch.round(x[0] / s) * s)
    assert torch.equal(y[1], x[1])


def test_reference_imports_nothing_of_the_program():
    bad = {"jax", "jaxlib", "flax", "llamago_tpu", "llamago_tpu_torch"}
    ref = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in bad, (name, m)
                if m.split(".")[0] == "benchmark":
                    assert m.startswith("benchmark.reference"), (name, m)
