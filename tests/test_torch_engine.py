"""Port parity: the Engine (runtime/engine.py) against the JAX Engine.

Both engines serve the same tiny f32 model (dense weights carried across
with params_from_numpy) with 2 slots, and the same script of greedy jobs:
two concurrent jobs, one prompt that reuses the prefix a finished job
left in its slot, and one job that runs past its context and swaps. The
emitted tokens must be identical, at decode chunk 1 and 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint.params import host_parameters
from llamago_tpu.config import MODEL_PRESETS as JPRESETS
from llamago_tpu.config import GenerateConfig as JGen
from llamago_tpu.runtime.engine import Engine as JEngine
from llamago_tpu_torch.checkpoint.params import params_from_numpy
from llamago_tpu_torch.config import MODEL_PRESETS, GenerateConfig
from llamago_tpu_torch.runtime.engine import Engine, JobStatus
from llamago_tpu_torch.tokenizer import Vocab

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)

BUCKETS = (16, 32, 64)
# (prompt, max_tokens, ctx_size, keep_count); jobs 0 and 1 run together,
# job 2 shares job 0's prompt prefix, job 3 overruns its 32-token context
SCRIPT = [("hello world", 10, 64, 0), ("world hello world", 8, 64, 0),
          ("hello world hello", 6, 64, 0), ("hello", 40, 32, 4)]


@pytest.fixture(scope="module")
def model():
    jcfg = JPRESETS["tiny"].replace(dtype="float32", weight_dtype="float32", max_seq_len=64)
    host = host_parameters(jcfg, random_ggjt_tensors(jcfg, seed=3))
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), host)
    cfg = MODEL_PRESETS["tiny"].replace(dtype="float32", weight_dtype="float32",
                                        max_seq_len=64)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


def _drive(eng, gen_cls):
    """Run SCRIPT; returns [(status, tokens, reused)] per job."""
    gens = [gen_cls(max_tokens=n, ctx_size=c, temp=0.0, keep_count=k)
            for _, n, c, k in SCRIPT]
    jobs = [eng.submit(SCRIPT[0][0], gens[0]), eng.submit(SCRIPT[1][0], gens[1])]
    while any(j.status in ("queued", "processing") for j in jobs):
        eng.step()
    for (prompt, *_), gen in zip(SCRIPT[2:], gens[2:]):
        jobs.append(eng.generate(prompt, gen))
    return [(j.status.value, j.output_tokens, j.reused_tokens) for j in jobs]


_JAX_RESULTS = {}


def _jax_results(model, chunk):
    if chunk not in _JAX_RESULTS:
        jcfg, jp, _, _ = model
        eng = JEngine(jcfg, jp, make_test_vocab(), slots=2, buckets=BUCKETS,
                      decode_chunk_size=chunk)
        _JAX_RESULTS[chunk] = _drive(eng, JGen)
    return _JAX_RESULTS[chunk]


def _port_vocab() -> Vocab:
    return Vocab(list(make_test_vocab().tokens))


@pytest.mark.parametrize("chunk", [1, 4])
def test_greedy_jobs_token_identical_to_jax(model, chunk):
    _, _, cfg, tp = model
    eng = Engine(cfg, tp, _port_vocab(), slots=2, buckets=BUCKETS,
                 decode_chunk_size=chunk, device="cpu")
    got = _drive(eng, GenerateConfig)
    want = _jax_results(model, chunk)
    assert [g[0] for g in got] == ["finished"] * len(SCRIPT)
    assert got[2][2] > 0  # the third prompt reused a cached prefix
    assert len(got[3][1]) == 40  # generated past its 32-token context
    assert got == want


def test_prompt_too_long_error_identical(model):
    jcfg, jp, cfg, tp = model
    jeng = JEngine(jcfg, jp, make_test_vocab(), slots=1, buckets=BUCKETS)
    eng = Engine(cfg, tp, _port_vocab(), slots=1, buckets=BUCKETS, device="cpu")
    jjob = jeng.generate("hello " * 200, JGen(max_tokens=5, ctx_size=32))
    job = eng.generate("hello " * 200, GenerateConfig(max_tokens=5, ctx_size=32))
    assert job.status == JobStatus.FAILED
    assert job.error == jjob.error and "too long" in job.error


def test_sampled_seeded_jobs_repeat(model):
    _, _, cfg, tp = model
    eng = Engine(cfg, tp, _port_vocab(), slots=2, buckets=BUCKETS,
                 decode_chunk_size=4, device="cpu")
    gen = GenerateConfig(max_tokens=12, ctx_size=64, temp=0.8, seed=11)
    a = eng.generate("hello world", gen).output_tokens
    b = eng.generate("hello world", gen).output_tokens
    assert a == b and len(a) == 12


def test_warmup_leaves_clean_state_and_embed(model):
    _, _, cfg, tp = model
    eng = Engine(cfg, tp, _port_vocab(), slots=2, buckets=BUCKETS,
                 decode_chunk_size=4, device="cpu")
    assert eng.warmup() >= 0
    assert all(s.free and s.pos == 0 and not s.history for s in eng.slots)
    assert not eng.cache.k[0].any() and not eng.logits.any()
    emb, n = eng.embed("hello world")
    assert emb.shape == (cfg.dim,) and n > 0 and np.isfinite(emb).all()


def test_deadline_expiry_fails_the_job(model):
    _, _, cfg, tp = model
    eng = Engine(cfg, tp, _port_vocab(), slots=1, buckets=BUCKETS, device="cpu")
    job = eng.submit("hello world", GenerateConfig(max_tokens=50, ctx_size=64,
                                                   temp=0.0, deadline_s=1e-6))
    eng.step()
    assert job.status == JobStatus.PROCESSING
    eng._expire_deadlines()
    assert job.status == JobStatus.FAILED and job.error == "deadline exceeded (0s)"
    assert eng.slots[0].free
