"""Port parity: the sampler (ops/sampling.py) against the JAX package.

JAX's threefry and torch's Philox draw different numbers from one seed,
so draws are never compared. What is compared: the filtered
probabilities (to f32 rounding, 1e-6) and the candidate ids (exactly)
from `sample(..., return_probs=True)`, greedy tokens, and the ring/count
state after push_tokens/reset_slots (exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamago_tpu.ops import sampling as jsampling
from llamago_tpu_torch.ops import sampling

torch.set_num_threads(1)

B, V, N = 3, 300, 16


def _state_pair(seed=0):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, V, (B, 10)).astype(np.int32)
    hist[1, 7:] = -1  # padding is skipped
    active = np.array([True, True, False])
    js = jsampling.push_tokens(jsampling.SamplerState.create(B, N, V),
                               jnp.asarray(hist), jnp.asarray(active))
    ts = sampling.push_tokens(sampling.SamplerState.create(B, N, V),
                              torch.from_numpy(hist), torch.from_numpy(active))
    return js, ts


def _assert_state_equal(ts, js):
    for f in ("ring", "counts", "ptr", "window"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_filtered_probs_and_candidates_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    temp = np.array([0.8, 0.5, 1.3], np.float32)
    top_k = np.array([40, 7, 128], np.int32)
    top_p = np.array([0.95, 0.5, 0.3], np.float32)
    rp = np.array([1.1, 1.3, 1.0], np.float32)
    js, ts = _state_pair(seed)
    _, (jprobs, jidx) = jsampling.sample_impl(
        jax.random.PRNGKey(0), jnp.asarray(logits), js, jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(rp), return_probs=True)
    gens = [torch.Generator().manual_seed(i) for i in range(B)]
    toks, (probs, idx) = sampling.sample(
        torch.from_numpy(logits), ts, torch.from_numpy(temp), torch.from_numpy(top_k),
        torch.from_numpy(top_p), torch.from_numpy(rp), gens, return_probs=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-7)
    # every draw is a kept candidate
    for b in range(B):
        kept = set(idx[b][probs[b] > 0].tolist())
        assert int(toks[b]) in kept


def test_greedy_matches_jax_argmax():
    logits = np.random.default_rng(3).standard_normal((B, V)).astype(np.float32)
    js, ts = _state_pair()
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    jt = jsampling.sample_impl(jax.random.PRNGKey(1), jnp.asarray(logits), js,
                               jnp.asarray(zeros), jnp.full(B, 40), jnp.asarray(ones),
                               jnp.asarray(ones))
    gens = [torch.Generator().manual_seed(0) for _ in range(B)]
    tt = sampling.sample(torch.from_numpy(logits), ts, torch.zeros(B), torch.full((B,), 40),
                         torch.ones(B), torch.ones(B), gens)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt.tolist() == np.argmax(logits, axis=-1).tolist()


def test_seeded_draws_repeat():
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal((B, V)).astype(np.float32))
    _, ts = _state_pair()
    args = (torch.ones(B), torch.full((B,), 100), torch.full((B,), 0.99), torch.ones(B))

    def draws(seed):
        gens = [torch.Generator().manual_seed(seed + i) for i in range(B)]
        return [sampling.sample(logits, ts, *args, gens).tolist() for _ in range(5)]

    assert draws(7) == draws(7)
    assert draws(7) != draws(8)


def test_push_and_reset_state_match_jax():
    js, ts = _state_pair(2)
    _assert_state_equal(ts, js)
    # window wrap: push more tokens than the window holds
    more = np.random.default_rng(5).integers(0, V, (B, 25)).astype(np.int32)
    active = np.array([True, False, True])
    js = jsampling.push_tokens(js, jnp.asarray(more), jnp.asarray(active))
    ts = sampling.push_tokens(ts, torch.from_numpy(more), torch.from_numpy(active))
    _assert_state_equal(ts, js)
    # per-slot window reset, then a push that wraps the short window
    mask = np.array([False, True, True])
    win = np.array([4, 5, 20], np.int32)
    js = jsampling.reset_slots(js, jnp.asarray(mask), jnp.asarray(win))
    ts = sampling.reset_slots(ts, torch.from_numpy(mask), torch.from_numpy(win))
    _assert_state_equal(ts, js)
    js = jsampling.push_tokens(js, jnp.asarray(more[:, :9]), jnp.ones(B, bool))
    ts = sampling.push_tokens(ts, torch.from_numpy(more[:, :9]), torch.ones(B, dtype=torch.bool))
    _assert_state_equal(ts, js)
