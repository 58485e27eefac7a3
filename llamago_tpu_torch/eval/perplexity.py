"""Perplexity harness: the quantization-quality oracle.

Counterpart of the JAX package's `eval/perplexity.py` (the reference has
no evaluation harness; BASELINE.md makes WikiText-2 perplexity the
quality gate for quantization), in llama.cpp's methodology:

  * the text is tokenized once and split into non-overlapping windows of
    `ctx` tokens;
  * each window runs one full-attention forward with per-position logits
    on a fresh batch-1 cache;
  * the NLL is averaged over every predicted position except the first
    `min_context` of each window (they predict with little context and
    would bias the perplexity upward);
  * ppl = exp(mean NLL).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.models.llama import forward_impl
from llamago_tpu_torch.parallel.tp_kernels import active_mesh
from llamago_tpu_torch.runtime.kv_cache import KVCache
from llamago_tpu_torch.tokenizer import Vocab, tokenize


def _window_nll(params, tokens: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Next-token NLL at every position of one [1, T] window: [T-1] f32 on
    the parameters' device (the min_context mask is applied by the
    caller). Under the active mesh (parallel/) the cache is the rank's
    block, and every rank gets the whole window's NLL."""
    dev = params["tok_embeddings"].device
    b, t = tokens.shape
    cache = KVCache.create(config, batch=b, max_seq=t, device=dev, mesh=active_mesh())
    tokens = tokens.to(device=dev, dtype=torch.long)
    logits, _ = forward_impl(params, tokens, cache, torch.zeros(b, dtype=torch.long, device=dev),
                             config, return_all_logits=True)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    return nll[0]


def perplexity(
    params,
    config: ModelConfig,
    token_ids: list[int] | np.ndarray,
    ctx: int = 512,
    min_context: int = 32,
    max_windows: int | None = None,
) -> dict:
    """Perplexity over a token stream. Returns {ppl, nll, n_tokens, n_windows}."""
    ids = np.asarray(token_ids, np.int64)
    n_windows = len(ids) // ctx
    if max_windows is not None:
        n_windows = min(n_windows, max_windows)
    if n_windows == 0:
        raise ValueError(f"need at least {ctx} tokens, got {len(ids)}")

    total_nll = 0.0
    total_count = 0
    for w in range(n_windows):
        window = torch.from_numpy(ids[w * ctx:(w + 1) * ctx][None, :])
        nll = _window_nll(params, window, config).cpu().numpy()
        # every window, the first included, skips its first min_context
        # positions
        start = min(min_context, len(nll) - 1)
        total_nll += float(nll[start:].sum())
        total_count += len(nll) - start
    mean_nll = total_nll / total_count
    return {
        "ppl": math.exp(mean_nll),
        "nll": mean_nll,
        "n_tokens": total_count,
        "n_windows": n_windows,
    }


def perplexity_of_text(params, config: ModelConfig, vocab: Vocab, text: str, **kw) -> dict:
    ids = tokenize(vocab, " " + text, bos=True)
    return perplexity(params, config, ids, **kw)
