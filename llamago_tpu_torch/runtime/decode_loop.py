"""Multi-token decode on the device with one host sync per chunk.

Counterpart of the JAX package's `runtime/decode_loop.py`: where JAX runs
the n steps as one `lax.scan` program, this is a Python loop of
`forward_impl` plus the sampler whose tensors never leave the device;
the caller syncs once when it reads the returned tokens. (A CUDA graph of
the step is later work.)
"""

from __future__ import annotations

import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.models.llama import forward_impl
from llamago_tpu_torch.ops.sampling import SamplerState, push_one, sample
from llamago_tpu_torch.runtime.kv_cache import KVCache


def decode_chunk(
    params,
    last_tokens: torch.Tensor,  # [B] — token to feed first
    cache: KVCache,
    positions: torch.Tensor,  # [B] — cache slot for last_tokens
    config: ModelConfig,
    n_steps: int,
    generators: list | None = None,  # per-slot torch.Generator (None => greedy)
    state: SamplerState | None = None,
    temp: torch.Tensor | None = None,
    top_k: torch.Tensor | None = None,
    top_p: torch.Tensor | None = None,
    repeat_penalty: torch.Tensor | None = None,
    greedy: bool = True,
    return_final_logits: bool = False,
    max_top_k: int = 128,
):
    """Run n_steps decode iterations.

    Returns (tokens [B, n_steps], cache, positions, state[, logits]). With
    return_final_logits the LAST sampled token is also fed through one
    more forward, so the returned logits follow the full emitted history
    (the engine's pending-logits invariant)."""
    dev = cache.k[0].device
    tok = last_tokens.to(device=dev, dtype=torch.long)
    pos = positions.to(device=dev, dtype=torch.long)
    all_active = torch.ones(tok.shape[0], dtype=torch.bool, device=dev)
    out = []
    for _ in range(n_steps):
        logits, cache = forward_impl(params, tok[:, None], cache, pos, config)
        if greedy:
            tok = torch.argmax(logits, dim=-1)
        else:
            tok = sample(logits, state, temp, top_k, top_p, repeat_penalty,
                         generators, max_top_k=max_top_k)
            push_one(state, tok, all_active)
        out.append(tok)
        pos = pos + 1
    toks = torch.stack(out, dim=1)
    if return_final_logits:
        logits, cache = forward_impl(params, tok[:, None], cache, pos, config)
        return toks, cache, pos + 1, state, logits
    return toks, cache, pos, state
