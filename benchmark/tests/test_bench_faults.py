"""A run with the timed path broken underneath comes out not correct.

The harness is driven as a run drives it (the test-only entry skips only
its look for a card), with one fault planted in the port for the run:

  * a step that returns its state unchanged: the forward writes no new
    rows into the KV cache;
  * half of the batch left out: a decode step's logits of the second half
    of the slots are the first half's;
  * a token altered where it is produced: the sampler's greedy token is
    the next id.

The fourth fault of a run, an exchange between chips left out, cannot
happen in these one-chip cells.
"""

import pytest

from benchmark.tests.tiny import TINY_MIX, make_root, run_tiny

# more greedy requests checked than a run checks, so that every slot's are
MIX = dict(TINY_MIX, check={"max_requests": 16, "target_tokens": 400, "min_tokens": 10})


def _unwritten_cache(monkeypatch):
    from llamago_tpu_torch.models import llama

    monkeypatch.setattr(llama, "_write_cache",
                        lambda k_layer, v_layer, ks_l, vs_l, k, v, write_pos: (k_layer, v_layer))


def _half_batch(monkeypatch):
    from llamago_tpu_torch.runtime import engine

    real = engine.forward_impl

    def forward(params, tokens, cache, write_pos, config, **kw):
        out = real(params, tokens, cache, write_pos, config, **kw)
        b = tokens.shape[0]
        if b > 1:  # a decode step over the slots
            logits = out[0].clone()
            logits[b // 2:] = logits[:b - b // 2]
            out = (logits,) + tuple(out[1:])
        return out

    monkeypatch.setattr(engine, "forward_impl", forward)


def _altered_token(monkeypatch):
    from llamago_tpu_torch.runtime import decode_loop, engine

    real = engine.sample

    def sample(logits, *a, **kw):
        tok = real(logits, *a, **kw)
        return (tok + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "sample", sample)
    monkeypatch.setattr(decode_loop, "sample", sample)


@pytest.mark.parametrize("fault", [_unwritten_cache, _half_batch, _altered_token])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault):
    root = make_root(tmp_path, mix=MIX)
    assert run_tiny(root, seed=21, seconds=1.0)["correct"] is True
    fault(monkeypatch)
    line = run_tiny(root, seed=21, seconds=1.0)
    assert line["correct"] is False
    assert line["check"]["max_logit_gap"]["value"] > line["check"]["max_logit_gap"]["limit"]


def test_no_checked_request_is_not_correct(tmp_path):
    """A run that finished no greedy request has nothing to compare."""
    root = make_root(tmp_path, mix=dict(MIX, greedy_share=0.0))
    line = run_tiny(root, seed=4, seconds=0.5)
    assert line["correct"] is False and line["check"]["checked_tokens"]["value"] == 0

