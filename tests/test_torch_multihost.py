"""Lockstep serving of the port on gloo CPU ranks (mirrors
tests/test_multihost.py), and the Engine on a mesh against the JAX
package's meshed Engine (mirrors tests/test_tp_kernels.py's).

Each test starts its ranks with its own timeout (tests/torch_ranks.py).
Rank 0 owns the HTTP front end; every rank runs
parallel/multihost.py:serve_lockstep; the tests read back what each rank
ran and hold the ranks to each other and to the JAX package's engine on
the same checkpoint tensors.
"""

import contextlib

import jax
import numpy as np
import pytest

from llamago_tpu.checkpoint.params import load_parameters as jload_parameters
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.config import GenerateConfig as JGenerateConfig
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu.parallel import make_mesh as jmake_mesh
from llamago_tpu.parallel import param_shardings as jparam_shardings
from llamago_tpu.runtime.engine import Engine as JEngine
from llamago_tpu.runtime.engine import JobStatus as JJobStatus

from conftest import make_test_vocab, random_ggjt_tensors
from torch_ranks import _free_port, load, run_ranks, save


def _engine_inputs(tmp_path, weight_dtype="int8", temp=0.0, max_tokens=6, seed=13):
    """engine.pkl for the ranks: tiny with the test vocab, f32 compute."""
    vocab = make_test_vocab()
    jcfg = JPRESETS["tiny"].replace(vocab_size=len(vocab), dtype="float32",
                                    weight_dtype=weight_dtype, max_seq_len=64)
    tensors = random_ggjt_tensors(jcfg, seed=seed)
    gen = {"max_tokens": max_tokens, "ctx_size": 64, "temp": temp, "seed": -1}
    prompts = ["hello world", "hi there"]
    save(tmp_path, "engine.pkl", {"config": jcfg.__dict__, "tensors": tensors,
                                  "vocab": vocab.tokens, "gen": gen, "prompts": prompts})
    return jcfg, tensors, vocab, gen, prompts


@contextlib.contextmanager
def _jax_mesh(mesh):
    jax.clear_caches()
    jkernels.ACTIVE_MESH, jkernels.FORCE_INTERPRET = mesh, mesh is not None
    try:
        yield mesh
    finally:
        jkernels.ACTIVE_MESH, jkernels.FORCE_INTERPRET = None, False
        jax.clear_caches()


def _jax_greedy(jcfg, tensors, vocab, gen, prompts, mesh=None):
    """The JAX package's Engine (meshed, with its kernels in interpret
    mode, when `mesh`): each prompt's greedy tokens."""
    with _jax_mesh(mesh):
        shardings = None if mesh is None else jparam_shardings(jcfg, mesh)
        engine = JEngine(jcfg, jload_parameters(jcfg, tensors, shardings=shardings), vocab,
                         slots=2, decode_chunk_size=1)
        jobs = [engine.submit(p, JGenerateConfig(**gen)) for p in prompts]
        for _ in range(400):
            engine.step()
            if all(j.status in (JJobStatus.FINISHED, JJobStatus.FAILED) for j in jobs):
                break
        assert all(j.status == JJobStatus.FINISHED for j in jobs)
        return [j.output_tokens for j in jobs], engine


def test_two_process_agreement_and_collective(tmp_path):
    """agree() resolves seed -1 on rank 0 and gives every rank its
    submissions; broadcast_pytree carries rank 0's object; a tp group's
    all_reduce sums over both ranks."""
    run_ranks("agreement", 2, tmp_path, timeout=60)
    got = [load(tmp_path, f"agree.rank{r}.pkl") for r in range(2)]
    assert got[0]["subs"] == got[1]["subs"]
    assert got[0]["subs"][0]["id"] == "j1" and got[0]["subs"][0]["gen"]["seed"] >= 0
    assert got[0]["echo"] == got[1]["echo"] == {"from": 0}
    assert got[0]["sum"] == got[1]["sum"] == [3.0, 3.0, 3.0]


@pytest.mark.parametrize("tp,sp", [(2, 1), (2, 2)])
def test_engine_on_a_mesh_matches_jax_meshed_engine(tmp_path, tp, sp):
    """The Engine on Q8_0 weights cut by load_parameters, warmed (the wipe
    keeps the rank's cache block), serving two greedy jobs: every rank's
    tokens equal the JAX package's Engine on its (tp, sp) mesh."""
    jcfg, tensors, vocab, gen, prompts = _engine_inputs(tmp_path)
    want, _ = _jax_greedy(jcfg, tensors, vocab, gen, prompts, jmake_mesh(tp=tp, sp=sp))
    run_ranks("engine_greedy", tp * sp, tmp_path, tp=tp, sp=sp)
    for r in range(tp * sp):
        got = load(tmp_path, f"engine.rank{r}.pkl")
        assert got["status"] == ["finished"] * 2, got["errors"]
        assert got["tokens"] == want, f"rank {r}"
        assert got["cache"] == [2, jcfg.kv_heads // tp, 64 // sp, jcfg.head_dim]


def _serve(tmp_path, **kw):
    run_ranks("lockstep_serve", 2, tmp_path, timeout=120, http_port=_free_port(), **kw)
    return [load(tmp_path, f"serve.rank{r}.pkl") for r in range(2)]


def test_two_process_sharded_rest_serving(tmp_path):
    """tp = 2 over two processes: sampled jobs (temp 0.8, seed -1, resolved
    on rank 0) posted to rank 0's REST API; both ranks admit the same jobs
    with the same seeds and emit the same tokens; /v1/embeddings goes
    through embed_routed (the forward runs on both ranks) and equals the JAX
    package's embedding."""
    jcfg, tensors, vocab, gen, prompts = _engine_inputs(tmp_path, temp=0.8, max_tokens=8)
    ranks = _serve(tmp_path, tp=2, embed=True)
    jobs0, jobs1 = ranks[0]["jobs"], ranks[1]["jobs"]
    assert set(jobs0) == set(jobs1) and len(jobs0) == 2
    for jid, job in jobs0.items():
        assert job["status"] == "finished" and job["seed"] >= 0, job
        assert job == jobs1[jid]
    served = ranks[0]["result"]["jobs"]
    assert [j["status"] for j in served] == ["finished"] * 2
    emb = np.asarray(ranks[0]["result"]["embedding"]["data"][0]["embedding"], np.float32)
    with _jax_mesh(None):
        engine = JEngine(jcfg, jload_parameters(jcfg, tensors), vocab, slots=2)
        want, _ = engine.embed("hello")
    assert emb.shape == (jcfg.dim,)
    np.testing.assert_allclose(emb, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_two_process_lockstep_rest_serving_matches_jax_engine(tmp_path):
    """dp = 2 over two processes (one slot a rank): greedy jobs over REST,
    the tokens of both ranks equal the JAX package's one-process Engine on
    the same checkpoint."""
    jcfg, tensors, vocab, gen, prompts = _engine_inputs(tmp_path, seed=17)
    want, _ = _jax_greedy(jcfg, tensors, vocab, gen, prompts)
    ranks = _serve(tmp_path, dp=2)
    served = ranks[0]["result"]["jobs"]
    assert [j["status"] for j in served] == ["finished"] * 2
    by_prompt = [{j["prompt"]: j["tokens"] for j in r["jobs"].values()} for r in ranks]
    for r in range(2):
        assert [by_prompt[r][p] for p in prompts] == want, f"rank {r}"


def test_expiry_is_decided_on_rank_zero(tmp_path):
    """A job past its deadline fails on both ranks; only rank 0 reads its
    clock (the other rank's expired_job_ids raises if called)."""
    _engine_inputs(tmp_path, temp=0.8)
    ranks = _serve(tmp_path, tp=2, deadline=True)
    expired = [[j for j in r["jobs"].values() if j["prompt"] == "a deadline"] for r in ranks]
    assert len(expired[0]) == len(expired[1]) == 1
    for (job,) in expired:
        assert job["status"] == "failed" and "deadline exceeded" in job["error"]
    assert expired[0][0]["tokens"] == expired[1][0]["tokens"]


def test_stop_flag_ends_every_rank(tmp_path):
    """Rank 0's stop_when ends serve_lockstep on both ranks at the same
    tick, with nothing served."""
    _engine_inputs(tmp_path)
    run_ranks("lockstep_stop", 2, tmp_path, timeout=60)
    ticks = [load(tmp_path, f"stop.rank{r}.pkl")["ticks"] for r in range(2)]
    assert ticks == [3, 3]
