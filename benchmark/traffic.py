"""The one traffic generator: a mix's data file in, each client's requests out.

A mix (`benchmark/traffic/<mix>.json`) gives lengths as distributions
({"dist": "lognormal", "median", "sigma", "min", "max"} or {"dist":
"uniform", "min", "max"}), the share of greedy requests and the sampling
settings. The generator deals the requests in rounds, one request a
client a round: every round's prompt lengths are the
prompt distribution's quantiles at (i + 0.5) / clients, its output lengths
the output distribution's, and round(clients * greedy_share) of its
requests are greedy, for ROUNDS rounds. So every seed, and every round of a seed, has the
same set of sizes; the seed only deals them out (which client gets which
prompt length, output length and greedy flag), and draws the prompts' text
and the requests' sampling seeds. Client c's k-th request is round k's
c-th, wrapping around after the last round.

Prompts are text over the 26 lowercase letters and the space, one token a
byte in the benchmark's byte vocabulary (vocab.py), so a prompt of n tokens
(BOS and the leading space included) is n - 2 characters, and two prompts
share nothing beyond those two tokens except by chance.
"""

from __future__ import annotations

import json
import statistics
from dataclasses import dataclass

import numpy as np

ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", dtype=np.uint8)
BOS = 1
ROUNDS = 64  # requests a client, before its requests wrap around
BYTE_OFFSET = 3  # token id of byte b is b + 3


@dataclass(frozen=True)
class Request:
    index: int  # position in the pool
    text: str
    prompt_tokens: int  # BOS + leading space + one token per character
    max_tokens: int
    greedy: bool
    seed: int  # the request's sampling seed

    def prompt_ids(self) -> list[int]:
        """The prompt's token ids, worked out by the benchmark itself."""
        return [BOS] + [b + BYTE_OFFSET for b in (" " + self.text).encode()]


def load_mix(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n whole numbers: the distribution's quantiles at (i + 0.5) / n, clipped."""
    lo, hi = int(spec["min"]), int(spec["max"])
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(p)) for p in u])
        v = float(spec["median"]) * np.exp(float(spec["sigma"]) * z)
    elif spec["dist"] == "uniform":
        v = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


class Traffic:
    """The requests of one run: `next_for(client)` gives a client's next one."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.clients = int(mix["clients"])
        rounds = ROUNDS
        n = self.clients
        rng = np.random.default_rng([int(seed) & (2**63 - 1), 0x62656e63])
        p_sizes = quantiles(mix["prompt_tokens"], n)
        o_sizes = quantiles(mix["output_tokens"], n)
        g_flags = np.arange(n) < int(round(n * float(mix.get("greedy_share", 0.0))))
        prompts = np.concatenate([rng.permutation(p_sizes) for _ in range(rounds)])
        outputs = np.concatenate([rng.permutation(o_sizes) for _ in range(rounds)])
        greedy = np.concatenate([rng.permutation(g_flags) for _ in range(rounds)])
        seeds = rng.integers(0, 2**31 - 1, size=n * rounds)
        text_len = prompts - 2
        chars = ALPHABET[rng.integers(0, len(ALPHABET), size=int(text_len.sum()))].tobytes()
        ends = np.cumsum(text_len)
        self.pool = [
            Request(i, chars[e - k:e].decode(), int(p), int(o), bool(g), int(s))
            for i, (e, k, p, o, g, s) in enumerate(zip(ends, text_len, prompts, outputs,
                                                       greedy, seeds))]
        self._taken = [0] * self.clients

    def next_for(self, client: int) -> Request:
        k = self._taken[client]
        self._taken[client] += 1
        return self.pool[(client + k * self.clients) % len(self.pool)]

