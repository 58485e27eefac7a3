"""The port's dry run (llamago_tpu_torch/dryrun.py) against the JAX
package's `__graft_entry__.py`.

`entry()`: the flagship forward (LLaMA-2-70B-style GQA, int8 weights, bf16
compute) on the JAX package's parameters carried across, against JAX's
`entry()` function on them: logits within 2e-2 of max|logit| (bf16
activations round in another order). `dryrun_multichip(n)` on n gloo CPU
ranks (tests/torch_ranks.py) for n = 2 (tp 2) and n = 4 (dp 2 x tp 2): its
bf16 train step's loss, from the parameters JAX's dry run draws on its
mesh (carried across), within 1e-2 of the loss of JAX's train step there,
with the mesh and the interpret mode JAX's dry run sets; then its int8,
int8-cache and w4x8 forwards run to finite logits of the right shape on
every rank. `python -m llamago_tpu_torch.dryrun --device cpu` exits 0.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from llamago_tpu.checkpoint.params import random_parameters as jrandom_parameters
from llamago_tpu.models import training as jtraining
from llamago_tpu.parallel import make_mesh as jmake_mesh
from llamago_tpu.parallel import param_shardings as jparam_shardings
from llamago_tpu_torch import dryrun
from llamago_tpu_torch.checkpoint.params import params_from_numpy

from test_torch_parallel_train import _np_tree
from test_torch_tp_kernels import jax_mesh
from torch_ranks import ROOT, load, run_ranks, save


def test_flagship_config_is_the_jax_one():
    assert dryrun.flagship_config(64).__dict__ == jentry._flagship_config(64).__dict__
    for n, shape in ((1, (1, 1, 1)), (2, (2, 1, 1)), (4, (2, 2, 1)), (8, (2, 2, 2))):
        assert dryrun.mesh_shape(n) == shape


def test_entry_matches_jax_entry():
    fn, (jp, tokens, cache, pos) = jentry.entry()
    want = np.asarray(jax.jit(fn)(jp, tokens, cache, pos), np.float32)
    pfn, (_, ptok, pcache, ppos) = dryrun.entry(device="cpu")
    got = pfn(params_from_numpy(_np_tree(jp), "cpu"), ptok, pcache, ppos).float().numpy()
    assert got.shape == want.shape == (1, 512)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _jax_train_loss(n):
    """The train step of JAX's dryrun_multichip(n): its parameters (numpy,
    before the step) and loss."""
    tp, dp, sp = dryrun.mesh_shape(n)
    mesh = jmake_mesh(tp=tp, dp=dp, sp=sp)
    config = jentry._flagship_config(max_seq_len=32).replace(weight_dtype="bfloat16")
    with jax_mesh(mesh, interpret=True):
        params = jrandom_parameters(config, seed=0, shardings=jparam_shardings(config, mesh))
        host = _np_tree(params)
        tokens = jax.device_put(
            np.random.default_rng(0).integers(0, config.vocab_size, (dp * 2, 16)).astype(
                np.int32),
            jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp", None)))
        opt = jtraining.make_optimizer().init(params)
        ctx = jax.sharding.use_mesh(mesh) if hasattr(jax.sharding, "use_mesh") else mesh
        with ctx:
            _, _, loss = jtraining.train_step(params, opt, tokens, config)
        return host, float(loss)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_matches_jax(tmp_path, n):
    host, want = _jax_train_loss(n)
    save(tmp_path, "dry.pkl", host)
    run_ranks("dryrun", n, tmp_path, n=n, timeout=180)
    for r in range(n):
        got = load(tmp_path, f"dry.rank{r}.pkl")
        assert abs(got["loss"] - want) <= 1e-2, (r, got["loss"], want)
        tp, dp, sp = dryrun.mesh_shape(n)
        assert got["mesh"] == {"dp": dp, "sp": sp, "tp": tp}
        assert got["logits"] == (dp * 2, 512)


def test_dryrun_command_runs_on_cpu_ranks():
    out = subprocess.run([sys.executable, "-m", "llamago_tpu_torch.dryrun", "--n", "2",
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=180, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "entry OK: (1, 512)" in out.stdout
    assert "dryrun_multichip OK: mesh dp=1 sp=1 tp=2, train loss " in out.stdout


def test_dryrun_needs_cuda_unless_cpu_is_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.main(["--n", "2"]) == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("hd,g,takes", [(16, 2, False), (128, 2, True), (64, 8, True),
                                        (128, 16, False)])
def test_int8_cache_route_refuses_geometries_the_card_kernels_do_not_take(hd, g, takes):
    """The dry run's flagship config (dim 128, 8 heads: hd = 16) over the
    int8 cache: on the card K4 / K8 take hd 64 and 128 and up to 8 query
    heads a kv head, and the window takes the scale-folded math elsewhere,
    as the dense cache's gate does (meta tensors stand for the card's); the
    CPU's plain versions take any geometry."""
    from llamago_tpu_torch.ops import attention

    kv = 2
    for dev, want in (("meta", takes), ("cpu", True)):
        q = torch.empty((1, 4, kv * g, hd), dtype=torch.bfloat16, device=dev)
        k = torch.empty((1, kv, 32, hd), dtype=torch.int8, device=dev)
        assert attention.quant_takes(q, k) == want
    q = torch.empty((1, 64, kv * g, hd), dtype=torch.bfloat16, device="cpu")
    assert not attention.quant_takes(q, torch.empty((1, kv, 64, hd), dtype=torch.int8))
