"""Prompt-lookup speculative decoding (greedy, lossless, on the device).

Counterpart of the JAX package's `runtime/speculative.py`. A decode step
streams every weight to emit one token per slot; a forward over T = K+1
tokens streams the same weights, so verifying K drafted tokens per step
can emit several tokens for the weight traffic of one. Drafts come from
the sequence's own history (prompt lookup / n-gram matching): no draft
model, and greedy acceptance emits exactly the tokens greedy decode of
the same logits would.

One step:
  1. propose: the most recent history position whose n-gram matches the
     current tail; the DRAFT_LEN tokens after it are the draft;
  2. verify: one forward over [t_last, d_1..d_K] at positions p..p+K with
     per-position logits; greedy preds g_0..g_K;
  3. accept: the longest prefix with d_j == g_{j-1}; the emitted tokens
     are preds[0..m] (m accepted drafts and one bonus token);
  4. cache: slots p..p+K were written by the verify forward; rejected
     slots hold stale rows, and every later query position overwrites
     them before it attends to them (the invariant the engine's context
     swap relies on too).

JAX runs the n steps as one `lax.scan`; here they are a Python loop whose
tensors stay on the device (as `runtime/decode_loop.py`): the caller syncs
once when it reads the returned tokens, counts and positions.
"""

from __future__ import annotations

import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.models.llama import forward_impl
from llamago_tpu_torch.runtime.kv_cache import KVCache


def _propose(hist: torch.Tensor, hlen: torch.Tensor, t_last: torch.Tensor,
             t_prev: torch.Tensor, draft_len: int, ngram: int) -> torch.Tensor:
    """Most recent n-gram match in each row's hist[0:hlen] -> the draft_len
    tokens after it. hist [B, H], hlen / t_last / t_prev [B]; returns
    [B, draft_len] (garbage where nothing matches: verification rejects it
    at no cost to correctness)."""
    b, h = hist.shape
    idx = torch.arange(h, device=hist.device)
    m = (hist == t_last[:, None]) & (idx[None, :] < hlen[:, None] - 1)
    if ngram >= 2:
        prev = torch.roll(hist, 1, dims=1)
        prev[:, 0] = -1
        m &= (prev == t_prev[:, None]) & (idx[None, :] >= 1)
    # the most recent match is the first True of the reversed row:
    # torch.argmax, like jnp.argmax, takes the first of equal maxima
    i = h - 1 - torch.argmax(m.flip(1).to(torch.int32), dim=1)
    start = torch.where(m.any(dim=1), i + 1, torch.zeros_like(i))
    start = torch.clamp(start, max=h - draft_len)
    return torch.gather(hist, 1, start[:, None] + torch.arange(draft_len, device=hist.device))


def speculative_decode_chunk(
    params,
    last_tokens: torch.Tensor,  # [B] — pending token (not yet in the cache)
    cache: KVCache,
    positions: torch.Tensor,  # [B] — cache slot for last_tokens
    history: torch.Tensor,  # [B, H] — prompt + emitted (incl. last_tokens)
    hist_len: torch.Tensor,  # [B] — valid prefix length of history
    config: ModelConfig,
    n_steps: int,
    draft_len: int = 7,
    ngram: int = 2,
):
    """n_steps speculative greedy steps.

    Returns (tokens [B, n_steps, draft_len+1], counts [B, n_steps], cache,
    positions, history, hist_len): per step, the first counts[b, i] tokens
    of tokens[b, i] are the emitted ones, and positions advance by counts.
    The caller must keep positions + n_steps*(draft_len+1) <= max_seq."""
    dev = cache.k[0].device
    t_last = last_tokens.to(device=dev, dtype=torch.long)
    pos = positions.to(device=dev, dtype=torch.long)
    hist = history.to(device=dev, dtype=torch.long).clone()
    hlen = hist_len.to(device=dev, dtype=torch.long)
    b, h_cap = hist.shape
    rows = torch.arange(b, device=dev)
    window = torch.arange(draft_len + 1, device=dev)
    toks, counts = [], []
    for _ in range(n_steps):
        t_prev = hist[rows, torch.clamp(hlen - 2, min=0)]
        draft = _propose(hist, hlen, t_last, t_prev, draft_len, ngram)  # [B, K]
        seq = torch.cat([t_last[:, None], draft], dim=1)  # [B, K+1]
        logits, cache = forward_impl(params, seq, cache, pos, config,
                                     return_all_logits=True)
        preds = torch.argmax(logits, dim=-1)  # [B, K+1]
        # accepted drafts = index of the first rejected one
        n_acc = (draft == preds[:, :-1]).to(torch.long).cumprod(dim=1).sum(dim=1)
        n_emit = n_acc + 1  # accepted drafts + the bonus token
        # the emitted tokens are preds[:, :n_emit]; the history write starts
        # at hlen, clamped as dynamic_update_slice clamps it, so that
        # hist[0:hlen] stays self-consistent near the buffer's end (the
        # engine reserves headroom so the clamp never fires in serving)
        start = torch.clamp(hlen, min=0, max=h_cap - (draft_len + 1))
        hist.scatter_(1, start[:, None] + window[None, :], preds)
        hlen = torch.minimum(hlen + n_emit, start + n_emit)
        pos = pos + n_emit
        t_last = torch.gather(preds, 1, n_acc[:, None])[:, 0]
        toks.append(preds)
        counts.append(n_emit)
    return (torch.stack(toks, dim=1), torch.stack(counts, dim=1), cache, pos, hist,
            hlen)


def assemble_tokens(toks, counts, limit: int | None = None) -> list[int]:
    """Host helper: flatten (tokens, counts) of one batch row into the
    emitted token list (truncated to `limit` tokens if given)."""
    toks = torch.as_tensor(toks).cpu().numpy()
    counts = torch.as_tensor(counts).cpu().numpy()
    out: list[int] = []
    for step in range(toks.shape[0]):
        out.extend(int(t) for t in toks[step, : int(counts[step])])
        if limit is not None and len(out) >= limit:
            return out[:limit]
    return out
