"""The traffic generator repeats exactly from the seed, and every seed gets
the same set of sizes."""

import json
import os

import pytest

from benchmark.tests.conftest import ROOT
from benchmark.traffic import Traffic, load_mix, quantiles

MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark", "traffic")))


def _mix(name):
    return load_mix(os.path.join(ROOT, "benchmark", "traffic", f"{name}.json"))


def _first(t: Traffic, n: int = 3):
    return [t.next_for(c) for _ in range(n) for c in range(t.clients)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    seed = 2**31 + 4099  # more than 32 signed bits hold
    a, b = _first(Traffic(_mix(mix), seed)), _first(Traffic(_mix(mix), seed))
    assert a == b


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_share_the_sizes(mix):
    m = _mix(mix)
    a, b = Traffic(m, 1), Traffic(m, 2)
    assert sorted(r.prompt_tokens for r in a.pool) == sorted(r.prompt_tokens for r in b.pool)
    assert sorted(r.max_tokens for r in a.pool) == sorted(r.max_tokens for r in b.pool)
    assert sum(r.greedy for r in a.pool) == sum(r.greedy for r in b.pool)
    assert [r.text for r in a.pool[:4]] != [r.text for r in b.pool[:4]]


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_are_exact_and_clipped(mix):
    m = _mix(mix)
    t = Traffic(m, 11)
    for r in t.pool[:200]:
        ids = r.prompt_ids()
        assert len(ids) == r.prompt_tokens
        assert ids[:2] == [1, ord(" ") + 3]
        assert m["prompt_tokens"]["min"] <= r.prompt_tokens <= m["prompt_tokens"]["max"]
        assert m["output_tokens"]["min"] <= r.max_tokens <= m["output_tokens"]["max"]
        # nothing the cell cannot hold
        assert r.prompt_tokens + r.max_tokens < m["context"]


@pytest.mark.parametrize("mix", MIXES)
def test_every_round_has_the_same_sizes(mix):
    t = Traffic(_mix(mix), 2**31 + 8)
    n = t.clients
    rounds = [t.pool[k * n:(k + 1) * n] for k in range(3)]
    for key in ("prompt_tokens", "max_tokens", "greedy"):
        first = sorted(getattr(r, key) for r in rounds[0])
        assert all(sorted(getattr(r, key) for r in rd) == first for rd in rounds[1:])
    assert [r.prompt_tokens for r in rounds[0]] != [r.prompt_tokens for r in rounds[1]]


def test_clients_take_turns_and_wrap():
    from benchmark.traffic import ROUNDS

    t = Traffic(dict(_mix(MIXES[0]), clients=2), 5)
    assert [t.next_for(0).index for _ in range(3)] == [0, 2, 4]
    assert t.next_for(1).index == 1
    for _ in range(ROUNDS - 3):
        t.next_for(0)
    assert t.next_for(0).index == 0


def test_quantiles_of_the_lognormal():
    q = quantiles({"dist": "lognormal", "median": 100, "sigma": 0.5, "min": 1,
                   "max": 10**6}, 101)
    assert q[50] == 100 and q[0] < 100 < q[-1]
    u = quantiles({"dist": "uniform", "min": 16, "max": 64}, 4)
    assert list(u) == [22, 34, 46, 58]


def test_prompt_tokens_match_the_port_tokenizer():
    """The benchmark's own prompt ids are the ids the port's tokenizer gives
    the same text under the byte vocabulary."""
    from llamago_tpu_torch.tokenizer import Vocab, tokenize

    from benchmark.vocab import byte_pieces

    v = Vocab(byte_pieces(32768))
    for r in Traffic(_mix(MIXES[0]), 3).pool[:20]:
        assert tokenize(v, " " + r.text, bos=True) == r.prompt_ids()


def test_mix_files_are_json_with_a_why():
    for name in MIXES:
        with open(os.path.join(ROOT, "benchmark", "traffic", f"{name}.json")) as f:
            m = json.load(f)
        assert m["kind"] and 0 < len(m["why"]) <= 200
