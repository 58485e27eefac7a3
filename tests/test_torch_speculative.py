"""Port parity: prompt-lookup speculative decoding (runtime/speculative.py
and the Engine's `speculative` path) against the JAX package on the CPU.

Weights are made with numpy from a seed, loaded (and quantized) by the
JAX package and carried across with params_from_numpy: dense f32, Q8_0,
Q4_0 and w4x8 (a model of dim 128 whose attention and w1/w3 leaves take
w4x8 and whose w2 keeps Q4_0), and the int8 KV cache. Where the JAX
function reaches a Pallas kernel whose CPU fallback is another function
(K5's activation rounding under w4x8; K4's requantized probabilities over
the int8 cache), the JAX kernels run in interpret mode (`FORCE_INTERPRET`).
Compute is f32 in both packages. Token streams, accepted counts,
positions, histories and history lengths must be equal; the speculative
stream must also equal plain greedy decode wherever both take the same
function (dense and Q8_0: under w4x8 a verify window of more than 16 rows
takes K6, an exact dequant, where a decode step takes K5's rounding).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.checkpoint import params as jparams
from llamago_tpu.config import GenerateConfig as JGen
from llamago_tpu.config import ModelConfig as JModelConfig
from llamago_tpu.models import llama as jllama
from llamago_tpu.ops import kernels as jkernels
from llamago_tpu.runtime import speculative as jspec
from llamago_tpu.runtime.engine import Engine as JEngine
from llamago_tpu.runtime.engine import Job as JJob
from llamago_tpu.runtime.kv_cache import KVCache as JKVCache
from llamago_tpu_torch.checkpoint import params
from llamago_tpu_torch.config import GenerateConfig, ModelConfig
from llamago_tpu_torch.models import llama
from llamago_tpu_torch.runtime import speculative as spec
from llamago_tpu_torch.runtime.decode_loop import decode_chunk
from llamago_tpu_torch.runtime.engine import Engine, Job, JobStatus
from llamago_tpu_torch.runtime.kv_cache import KVCache
from llamago_tpu_torch.tokenizer import Vocab

from conftest import make_test_vocab, random_ggjt_tensors

torch.set_num_threads(1)

DRAFT = 5
# (weight_dtype, LLAMAGO_INT4_EXEC, kv_dtype, JAX kernels in interpret mode)
KINDS = {
    "dense": ("float32", None, "auto", False),
    "q8_0": ("int8", None, "auto", False),
    "q4_0": ("int4", "q4_0", "auto", False),
    "w4x8": ("int4", "w4x8", "auto", True),
    "int8_cache": ("float32", None, "int8", True),
}


def _config(cls, weight_dtype, kv_dtype):
    """dim 128 with every output width a multiple of 128 (the JAX w4x8
    launcher's tile planner refuses other widths)."""
    return cls(vocab_size=512, dim=128, n_layers=2, n_heads=4, ffn_dim=320,
               max_seq_len=128, dtype="float32", weight_dtype=weight_dtype,
               kv_dtype=kv_dtype)


_MODELS = {}


def _model(kind):
    """(JAX config, JAX params, port config, port params): loaded by the
    JAX package, layered and fused, carried across."""
    if kind not in _MODELS:
        wdt, exec_format, kv, _ = KINDS[kind]
        with _int4_exec(exec_format):
            jcfg = _config(JModelConfig, wdt, kv)
            jp = jparams.load_parameters(jcfg, random_ggjt_tensors(jcfg, seed=41))
            jp = jparams.fuse_layer_weights(jparams.unstack_layer_params(jp, jcfg.n_layers))
        tp = params.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[kind] = (jcfg, jp, _config(ModelConfig, wdt, kv), tp)
    return _MODELS[kind]


@contextlib.contextmanager
def _int4_exec(exec_format):
    mp = pytest.MonkeyPatch()
    if exec_format is not None:
        mp.setenv("LLAMAGO_INT4_EXEC", exec_format)
    try:
        yield
    finally:
        mp.undo()


@contextlib.contextmanager
def _jax_kernels(kind):
    """The JAX kernels in interpret mode where the kind needs them, and the
    int4 exec format both packages read."""
    old = jkernels.FORCE_INTERPRET
    jkernels.FORCE_INTERPRET = KINDS[kind][3]
    try:
        with _int4_exec(KINDS[kind][1]):
            yield
    finally:
        jkernels.FORCE_INTERPRET = old


# ------------------------------------------------------------- _propose


def _histories(seed, b, h, vocab):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, vocab, (b, h)).astype(np.int32)
    hlen = rng.integers(1, h + 1, b).astype(np.int32)
    return hist, hlen


def _propose_both(hist, hlen, ngram, draft=DRAFT):
    rows = np.arange(hist.shape[0])
    t_last = hist[rows, np.maximum(hlen - 1, 0)]
    t_prev = hist[rows, np.maximum(hlen - 2, 0)]
    want = jax.vmap(lambda h, l, a, p: jspec._propose(h, l, a, p, draft, ngram))(
        jnp.asarray(hist), jnp.asarray(hlen), jnp.asarray(t_last), jnp.asarray(t_prev))
    got = spec._propose(torch.from_numpy(hist).long(), torch.from_numpy(hlen).long(),
                        torch.from_numpy(t_last).long(), torch.from_numpy(t_prev).long(),
                        draft, ngram)
    return got.numpy(), np.asarray(want)


def _edge_histories():
    """No match; a match right before the tail; several matches (the most
    recent must win); a match whose draft runs past the buffer end (start
    clamped to H - draft); hlen at 1, 2 and H."""
    h = 24
    hist = np.zeros((7, h), np.int32)
    hlen = np.array([10, 10, 16, 24, 1, 2, 24], np.int32)
    hist[0, :10] = np.arange(100, 110)                        # no match
    hist[1, :10] = [5, 6, 7, 8, 9, 1, 2, 3, 2, 3]              # match just before the tail
    hist[2, :16] = [1, 2, 9, 9, 1, 2, 8, 8, 1, 2, 7, 7, 4, 4, 1, 2]  # three matches
    hist[3] = np.arange(100, 124)
    hist[3, 19:21] = hist[3, 22:24] = [7, 8]                   # match near the end
    hist[4, 0] = 3                                             # hlen 1
    hist[5, :2] = [3, 3]                                       # hlen 2
    hist[6] = [4, 5] * 12                                      # hlen H, every pair matches
    return hist, hlen


@pytest.mark.parametrize("ngram", [1, 2])
@pytest.mark.parametrize("case", ["random", "small_vocab", "edges"])
def test_propose_matches_jax(ngram, case):
    if case == "edges":
        hist, hlen = _edge_histories()
    else:
        hist, hlen = _histories(ngram, 16, 40, 512 if case == "random" else 3)
    got, want = _propose_both(hist, hlen, ngram)
    np.testing.assert_array_equal(got, want)
    if case == "edges" and ngram == 2:
        # the most recent of three matches of (1, 2) is at 8..9: draft from 10
        np.testing.assert_array_equal(got[2], hist[2, 10:10 + DRAFT])
        np.testing.assert_array_equal(got[0], hist[0, :DRAFT])  # no match: start 0


def test_argmax_takes_the_first_of_equal_maxima_like_jax():
    """The n-gram search takes the most recent match as the first True of
    the reversed mask: torch.argmax must break ties as jnp.argmax does."""
    m = np.array([[0, 1, 0, 1, 1, 0], [0, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1]], np.int32)
    got = torch.argmax(torch.from_numpy(m), dim=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(jnp.asarray(m), axis=1)))
    np.testing.assert_array_equal(got, [1, 0, 0])
    hist = np.array([[7, 1, 7, 2, 7, 3, 7, 4, 9, 9, 9, 7]], np.int32)
    got, want = _propose_both(hist, np.array([12], np.int32), ngram=1, draft=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [4, 9])  # after the most recent 7 (index 6)


# ------------------------------------------------ speculative_decode_chunk


def _prefill_and_spec(pkg, kind, prompts, starts, n_steps):
    """Prefill each row's prompt at its start, take the greedy token, then
    n_steps speculative steps. Returns every output as numpy, with the
    prefill's logits and token."""
    jcfg, jp, cfg, tp = _model(kind)
    b, plen = prompts.shape
    hist = np.zeros((b, cfg.max_seq_len), np.int32)
    hist[:, :plen] = prompts
    if pkg == "jax":
        cache = JKVCache.create(jcfg, batch=b, layered=True)
        logits, cache = jllama.forward(jp, jnp.asarray(prompts), cache, jnp.asarray(starts),
                                       jcfg)
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        hist[:, plen] = tok
        out = jspec.speculative_decode_chunk(
            jp, jnp.asarray(tok), cache, jnp.asarray(starts + plen), jnp.asarray(hist),
            jnp.full((b,), plen + 1, jnp.int32), jcfg, n_steps=n_steps, draft_len=DRAFT)
    else:
        cache = KVCache.create(cfg, batch=b, device="cpu")
        logits, cache = llama.forward_impl(tp, torch.from_numpy(prompts), cache,
                                           torch.from_numpy(starts).long(), cfg)
        tok = torch.argmax(logits, -1).numpy().astype(np.int32)
        hist[:, plen] = tok
        out = spec.speculative_decode_chunk(
            tp, torch.from_numpy(tok), cache, torch.from_numpy(starts + plen),
            torch.from_numpy(hist), torch.full((b,), plen + 1), cfg, n_steps=n_steps,
            draft_len=DRAFT)
    toks, counts, _, pos, hist_out, hlen = out
    return {"logits": np.asarray(logits), "tok": tok,
            **{k: np.asarray(v).astype(np.int64) for k, v in (
                ("tokens", toks), ("counts", counts), ("positions", pos),
                ("history", hist_out), ("hist_len", hlen))}}


LOOPY = [5, 11, 23, 5, 11, 23, 5, 11, 23, 5, 11, 23]


@pytest.mark.parametrize("kind,batch", [("dense", 1), ("dense", 2), ("q8_0", 2),
                                        ("q4_0", 2), ("w4x8", 2), ("int8_cache", 2)])
def test_speculative_chunk_matches_jax(kind, batch):
    """At batch 2 the rows sit at different positions (starts 0 and 5) and
    one prompt repeats itself while the other does not."""
    prompts = np.array([LOOPY, [3, 9, 2, 7, 9, 2, 7, 5, 14, 3, 9, 2]][:batch], np.int32)
    starts = np.array([0, 5][:batch], np.int32)
    with _jax_kernels(kind):
        want = _prefill_and_spec("jax", kind, prompts, starts, n_steps=10)
        got = _prefill_and_spec("port", kind, prompts, starts, n_steps=10)
    # f32 sums in another order; over the int8 cache a K/V element on a
    # rounding boundary may also land one int8 step apart (1/127 of its
    # row's absmax), which moves the logits by about 2e-4 here
    tol = 1e-3 if KINDS[kind][2] == "int8" else 1e-4
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=tol, atol=tol)
    assert got["tok"].tolist() == want["tok"].tolist()
    for key in ("tokens", "counts", "positions", "history", "hist_len"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["tokens"].shape == (batch, 10, DRAFT + 1)
    np.testing.assert_array_equal(got["positions"], starts + prompts.shape[1]
                                  + got["counts"].sum(1))
    assert (got["counts"] >= 1).all() and got["counts"].max() > 1  # drafts were accepted


@pytest.mark.parametrize("kind", ["dense", "q8_0"])
def test_speculative_stream_equals_plain_greedy(kind):
    """Lossless: the emitted stream is the port's plain greedy decode's."""
    _, _, cfg, tp = _model(kind)
    prompts = np.array([LOOPY, [3, 9, 2, 7, 9, 2, 7, 5, 14, 3, 9, 2]], np.int32)
    starts = np.array([0, 5], np.int32)
    got = _prefill_and_spec("port", kind, prompts, starts, n_steps=10)
    cache = KVCache.create(cfg, batch=2, device="cpu")
    logits, cache = llama.forward_impl(tp, torch.from_numpy(prompts), cache,
                                       torch.from_numpy(starts).long(), cfg)
    tok = torch.argmax(logits, -1)
    # as many steps as the speculative run can have emitted tokens
    toks, *_ = decode_chunk(tp, tok, cache, torch.from_numpy(starts + 12), cfg,
                            10 * (DRAFT + 1))
    for row in range(2):
        emitted = [int(got["tok"][row])] + spec.assemble_tokens(got["tokens"][row],
                                                                got["counts"][row])
        assert len(emitted) == 1 + got["counts"][row].sum()
        assert emitted == ([int(tok[row])] + toks[row].tolist())[:len(emitted)]


def test_assemble_tokens_matches_jax():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (6, DRAFT + 1))
    counts = rng.integers(1, DRAFT + 2, 6)
    for limit in (None, 1, 7, 100):
        want = jspec.assemble_tokens(jnp.asarray(toks), jnp.asarray(counts), limit=limit)
        assert spec.assemble_tokens(torch.from_numpy(toks), torch.from_numpy(counts),
                                    limit=limit) == want
        assert spec.assemble_tokens(toks, counts, limit=limit) == want


# ------------------------------------------------------------------ engine

BUCKETS = (16, 32, 64)


def _engines(kind, **kw):
    jcfg, jp, cfg, tp = _model(kind)
    vocab = make_test_vocab()
    return (JEngine(jcfg, jp, vocab, slots=2, buckets=BUCKETS, **kw),
            Engine(cfg, tp, Vocab(list(vocab.tokens)), slots=2, buckets=BUCKETS,
                   device="cpu", **kw))


# (prompt, max_tokens, ctx_size): a loopy prompt, a plain one, and one that
# runs past its 32-token context and swaps
ENGINE_SCRIPT = [("hello hello hello hello hello", 24, 128), ("world hello", 12, 128),
                 ("hello world", 40, 32)]


def _drive(eng, gen_cls):
    out = []
    for prompt, n, ctx in ENGINE_SCRIPT:
        job = eng.generate(prompt, gen_cls(max_tokens=n, ctx_size=ctx, temp=0.0))
        out.append((job.status.value, job.output_tokens))
    return out


@pytest.mark.parametrize("kind", ["dense", "q8_0"])
def test_engine_speculative_equals_plain_and_jax(kind):
    jeng, eng = _engines(kind, speculative=True, draft_len=DRAFT, decode_chunk_size=4)
    _, plain = _engines(kind, decode_chunk_size=4)
    want = _drive(jeng, JGen)
    got = _drive(eng, GenerateConfig)
    assert got == want
    assert got == _drive(plain, GenerateConfig)
    assert [s for s, _ in got] == ["finished"] * 3
    assert [len(t) for _, t in got] == [n for _, n, _ in ENGINE_SCRIPT]
    assert eng.slots[0].swap_point is not None  # the third job swapped
    np.testing.assert_array_equal(eng.spec_accept_ema, jeng.spec_accept_ema)
    assert eng.spec_accept_ema[0] != DRAFT  # speculative chunks fed the EMA


def test_engine_speculative_concurrent_jobs_match_jax():
    """Two greedy jobs at once on 2 slots: the batch speculates together."""
    jeng, eng = _engines("dense", speculative=True, draft_len=DRAFT, decode_chunk_size=8)
    out = []
    for e, gen_cls in ((jeng, JGen), (eng, GenerateConfig)):
        jobs = [e.submit(p, gen_cls(max_tokens=24, ctx_size=128, temp=0.0))
                for p in ("hello hello hello hello", "world world hello")]
        while any(j.status.value in ("queued", "processing") for j in jobs):
            e.step()
        out.append([(j.status.value, j.output_tokens) for j in jobs])
    assert out[1] == out[0]
    np.testing.assert_array_equal(eng.spec_accept_ema, jeng.spec_accept_ema)


def test_engine_speculative_skips_sampled_jobs():
    _, spec_eng = _engines("dense", speculative=True, decode_chunk_size=4)
    _, plain = _engines("dense", decode_chunk_size=4)
    calls = []
    spec_eng._decode_speculative = lambda *a: calls.append(a)
    gen = GenerateConfig(max_tokens=10, ctx_size=128, temp=0.8, seed=3)
    a = spec_eng.generate("hello", gen)
    b = plain.generate("hello", gen)
    assert a.status == JobStatus.FINISHED and not calls
    assert a.output_tokens == b.output_tokens


def _gate_states(eng, job_cls, gen_cls):
    for i in range(2):
        eng.slots[i].job = job_cls(id=str(i), prompt="x",
                                   gen=gen_cls(max_tokens=64, ctx_size=128, temp=0.0))
        eng.slots[i].history = [1, 2, 3]
        eng.slots[i].pos = 3
        eng.slots[i].remaining = 64


def _gate_trace(eng):
    """_spec_steps over the states of tests/test_speculative.py's gate tests
    and a few more (one active slot, low headroom, small budgets)."""
    active, temp = np.array([True, True]), np.zeros(2, np.float32)
    out = []
    eng.spec_accept_ema[:] = 3.0
    out.append(eng._spec_steps(active, temp))
    eng.spec_accept_ema[:] = 0.2
    out += [eng._spec_steps(active, temp) for _ in range(eng.spec_probe_interval + 2)]
    eng.spec_accept_ema[0] = 3.0
    out.append(eng._spec_steps(active, temp))
    out.append(eng._spec_steps(np.array([True, False]), temp))
    eng.spec_accept_ema[:] = 1.2
    out.append(eng._spec_steps(np.array([True, False]), temp))  # the 1.5 floor
    out.append(eng._spec_steps(active, np.array([0.0, 0.5], np.float32)))  # sampled slot
    eng.spec_accept_ema[:] = 5.0
    for remaining, pos in ((64, 3), (10, 3), (3, 3), (64, 100), (64, 120)):
        for s in eng.slots:
            s.remaining, s.pos = remaining, pos
        out.append(eng._spec_steps(active, temp))
    eng.slots[1].pending = [1]
    out.append(eng._spec_steps(active, temp))  # a prefill in flight
    return out


@pytest.mark.parametrize("chunk,draft", [(4, 5), (32, 7), (6, 1)])
def test_spec_steps_and_rungs_match_jax(chunk, draft):
    jeng, eng = _engines("dense", speculative=True, draft_len=draft, decode_chunk_size=chunk)
    assert eng._halving_rungs() == jeng._halving_rungs()
    _gate_states(jeng, JJob, JGen)
    _gate_states(eng, Job, GenerateConfig)
    got, want = _gate_trace(eng), _gate_trace(jeng)
    assert got == want
    if (chunk, draft) == (4, 5):  # tests/test_speculative.py's expectations
        assert got[:12] == [4, 1] + [0] * 8 + [1, 4]


def test_spec_gate_yields_to_a_queued_job_with_a_free_slot():
    jeng, eng = _engines("dense", speculative=True, decode_chunk_size=4)
    for e, job_cls, gen_cls in ((jeng, JJob, JGen), (eng, Job, GenerateConfig)):
        _gate_states(e, job_cls, gen_cls)
        active = np.array([True, False])
        e.slots[1].job = None
        e.submit("queued", gen_cls(max_tokens=4, ctx_size=128))
        assert e._spec_steps(active, np.zeros(2, np.float32)) == 0


def test_new_tenant_inherits_the_slot_ema():
    _, eng = _engines("dense", speculative=True, draft_len=DRAFT, decode_chunk_size=4)
    assert eng.spec_accept_ema[0] == DRAFT
    eng.spec_accept_ema[0] = 0.25
    seen = []
    admit = eng._admit

    def spy(slot_idx, job):
        admit(slot_idx, job)
        seen.append(float(eng.spec_accept_ema[slot_idx]))

    eng._admit = spy
    eng.generate("something else", GenerateConfig(max_tokens=6, ctx_size=128, temp=0.0))
    assert seen == [0.25]


def test_warmup_runs_one_spec_step_and_leaves_clean_state():
    _, eng = _engines("dense", speculative=True, draft_len=DRAFT, decode_chunk_size=4)
    rungs = []
    real = spec.speculative_decode_chunk

    def spy(*a, n_steps, **kw):
        rungs.append(n_steps)
        return real(*a, n_steps=n_steps, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(spec, "speculative_decode_chunk", spy)
    try:
        eng.warmup(include_embed=False)
    finally:
        mp.undo()
    assert rungs == [1] and eng._halving_rungs() == [4, 2, 1]
    assert all(s.free and s.pos == 0 and not s.history for s in eng.slots)
    assert not eng.cache.k[0].any() and not eng.logits.any()

