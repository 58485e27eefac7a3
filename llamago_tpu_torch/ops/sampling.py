"""Batched sampling on the device: temperature, repeat penalty, top-k, top-p.

Counterpart of the JAX package's `ops/sampling.py`, in the reference
sampler's order (SampleTopPTopK, pkg/llama/llama.go:455-707):

  1. scale logits by 1/temp, with the sign-aware repeat penalty for
     tokens present in the last-N window: negative logits are multiplied
     by the penalty, positive ones divided (llama.go:516-526);
  2. take a static top-K by value and mask ranks >= the slot's top_k;
  3. softmax over the survivors;
  4. nucleus cut: keep rank i while the cumulative probability before it
     is below top_p (inclusive of the crossing token; rank 0 always
     kept), then renormalize;
  5. draw, from each slot's own torch.Generator; greedy argmax at
     temp <= 0.

The draws differ from JAX's threefry; the filtered probabilities and the
candidate ids are the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = float("-inf")


@dataclass
class SamplerState:
    """Per-slot last-N token window plus presence counts. Each slot wraps
    its ring at its own `window[b]` (the request's repeat_last_n), so
    ring entries past it stay empty (-1). The functions below update the
    tensors in place and return the state."""

    ring: torch.Tensor  # [B, N] int64, -1 = empty
    counts: torch.Tensor  # [B, V] int32, occurrences of each token in the window
    ptr: torch.Tensor  # [B] int64, next ring slot to overwrite
    window: torch.Tensor  # [B] int64 in [1, N]

    @staticmethod
    def create(batch: int, window: int, vocab_size: int, device="cpu") -> "SamplerState":
        return SamplerState(
            ring=torch.full((batch, window), -1, dtype=torch.long, device=device),
            counts=torch.zeros((batch, vocab_size), dtype=torch.int32, device=device),
            ptr=torch.zeros(batch, dtype=torch.long, device=device),
            window=torch.full((batch,), window, dtype=torch.long, device=device),
        )


def reset_slots(state: SamplerState, reset_mask: torch.Tensor,
                window: torch.Tensor | None = None) -> SamplerState:
    """Clear the window of slots where reset_mask[b] (job admission);
    `window` optionally sets those slots' repeat_last_n."""
    m = reset_mask.to(device=state.ring.device, dtype=torch.bool)
    if window is not None:
        w = torch.clamp(window.to(state.window), 1, state.ring.shape[1])
        state.window = torch.where(m, w, state.window)
    state.ring = torch.where(m[:, None], torch.full_like(state.ring, -1), state.ring)
    state.counts = torch.where(m[:, None], torch.zeros_like(state.counts), state.counts)
    state.ptr = torch.where(m, torch.zeros_like(state.ptr), state.ptr)
    return state


def push_one(state: SamplerState, tokens: torch.Tensor, active: torch.Tensor) -> SamplerState:
    """Push one token per slot into the ring (active slots only)."""
    b = state.ring.shape[0]
    rows = torch.arange(b, device=state.ring.device)
    tokens = tokens.to(state.ring)
    evicted = state.ring[rows, state.ptr]
    dec_ok = (evicted >= 0) & active
    state.counts[rows, torch.where(dec_ok, evicted, 0)] -= dec_ok.to(state.counts.dtype)
    inc_ok = active & (tokens >= 0)
    state.counts[rows, torch.where(inc_ok, tokens, 0)] += inc_ok.to(state.counts.dtype)
    state.ring[rows, state.ptr] = torch.where(active, tokens, evicted)
    state.ptr = torch.where(active, (state.ptr + 1) % state.window, state.ptr)
    return state


def push_tokens(state: SamplerState, tokens: torch.Tensor,
                active: torch.Tensor) -> SamplerState:
    """Push tokens [B, T] column by column; -1 entries are skipped. Prompt
    tokens go through here too (the reference's window includes the
    prompt, server.go:187-198)."""
    tokens = tokens.to(state.ring)
    active = active.to(device=state.ring.device, dtype=torch.bool)
    for col in tokens.T:
        push_one(state, col, active & (col >= 0))
    return state


def sample(
    logits: torch.Tensor,  # [B, V] float32
    state: SamplerState,
    temp: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int (1 <= top_k <= max_top_k)
    top_p: torch.Tensor,  # [B]
    repeat_penalty: torch.Tensor,  # [B]
    generators: list | None = None,  # one torch.Generator per slot
    max_top_k: int = 128,
    return_probs: bool = False,
):
    """Next token per slot: tokens [B] int64 on the logits' device (and,
    with return_probs, the post-top-p probabilities and candidate ids
    over the top max_top_k). `generators` may be None only when every
    slot is greedy (temp <= 0)."""
    v = logits.shape[-1]
    max_top_k = min(max_top_k, v)
    dev = logits.device
    temp = temp.to(device=dev, dtype=logits.dtype)
    top_k = top_k.to(dev)
    top_p = top_p.to(device=dev, dtype=logits.dtype)
    rp = repeat_penalty.to(device=dev, dtype=logits.dtype)[:, None]

    safe_temp = torch.where(temp > 0, temp, torch.ones_like(temp))
    scaled = logits * (1.0 / safe_temp)[:, None]
    penalized = torch.where(logits < 0.0, scaled * rp, scaled / rp)
    x = torch.where(state.counts > 0, penalized, scaled)

    vals, idx = torch.topk(x, max_top_k, dim=-1)
    rank = torch.arange(max_top_k, device=dev)[None, :]
    vals = torch.where(rank < top_k[:, None], vals, torch.full_like(vals, NEG_INF))

    probs = torch.softmax(vals, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = ((csum - probs) < top_p[:, None]) | (rank == 0)
    probs = torch.where(keep, probs, torch.zeros_like(probs))
    probs = probs / probs.sum(dim=-1, keepdim=True)

    greedy = torch.argmax(logits, dim=-1)
    if generators is None:
        tokens = greedy
    else:
        # inverse-CDF draw from one uniform per slot, each from that slot's
        # own generator: a job's draws do not depend on its co-tenants
        u = torch.cat([torch.rand(1, generator=g, device=dev) for g in generators])
        cdf = torch.cumsum(probs, dim=-1)
        draw = (cdf < (u * cdf[:, -1])[:, None]).sum(dim=-1).clamp(max=max_top_k - 1)
        drawn = idx.gather(1, draw[:, None])[:, 0]
        tokens = torch.where(temp <= 0, greedy, drawn)
    if return_probs:
        return tokens, (probs, idx)
    return tokens
