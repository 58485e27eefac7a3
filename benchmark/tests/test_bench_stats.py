"""Rates and the censored 95th percentile on hand-made timelines."""

import pytest

from benchmark.stats import first_token_waits, percentile


def test_nearest_rank_percentile():
    v = list(range(1, 101))
    assert percentile(v, 95) == 95
    assert percentile(v, 50) == 50
    assert percentile([3.0], 95) == 3.0
    assert percentile([5, 1, 4, 2, 3], 95) == 5  # ceil(4.75) = 5th value
    with pytest.raises(ValueError):
        percentile([], 50)


def test_censored_waits_rank_above_every_served_one():
    # created, first token, failed; the window ended at t = 10
    timeline = [(0.0, 1.0, False), (0.0, 2.0, False), (1.0, 4.0, False),
                (9.5, None, False), (2.0, None, True)]
    w = first_token_waits(timeline, end=10.0)
    assert w[:3] == [1.0, 2.0, 3.0]
    # the unserved one waited at least 0.5 s, but ranks above the 3 s one
    assert w[3] == 3.0 and w[4] == 8.0
    assert percentile(w, 95) == 8.0


def test_p95_of_a_timeline_with_a_tail():
    # 200 requests: 190 wait 0.1 s, 10 wait 2 s; one of those failed
    timeline = [(float(i), i + 0.1, False) for i in range(190)]
    timeline += [(float(i), i + 2.0, False) for i in range(190, 199)]
    timeline += [(199.0, None, True)]
    w = first_token_waits(timeline, end=199.5)
    assert len(w) == 200
    assert percentile(w, 95) == pytest.approx(0.1)  # rank 190
    assert percentile(w, 96) == pytest.approx(2.0)
    assert max(w) == pytest.approx(2.0)  # the failed one: at least the longest


def test_rate_over_the_window():
    from benchmark.kinds.serve import Served
    from benchmark.tests.conftest import ROOT  # noqa: F401
    import importlib.util
    import os

    def reader(name):
        path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    run = Served(dims=None, mix={}, window_s=2.5, output_tokens=1000, prompt_tokens=5120)
    assert reader("output_tok_s")(run) == 400.0
    assert reader("prompt_tok_s")(run) == 2048.0
    assert reader("output_tok_s")(Served(dims=None, mix={})) is None
