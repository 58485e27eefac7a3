"""Training step: next-token cross-entropy + AdamW.

Counterpart of the JAX package's `models/training.py`: a real train step
over the same forward (models/llama.py), on one device. The gradients of
the kernels' calls come from their autograd Functions
(ops/kernels.py:FrozenQuantMatmul, ops/attention.py:FlashAttention), whose
backwards are the JAX package's custom VJPs in plain PyTorch. The
optimizer is torch.optim.AdamW with optax.adamw's defaults (b1 0.9, b2
0.999, eps 1e-8, weight decay 1e-4 on every trained leaf), and the train
state is saved with torch.save where the JAX package uses orbax.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.models.llama import forward_impl
from llamago_tpu_torch.runtime.kv_cache import KVCache
from llamago_tpu_torch.utils.device import torch_dtype

# optax.adamw's defaults; torch.optim.AdamW's own weight decay is 1e-2
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def loss_fn(params, tokens: torch.Tensor, config: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy over [B, T] token batches, in f32."""
    b, t = tokens.shape
    dev = params["tok_embeddings"].device
    # training always uses a dense cache: quantize_kv_rows rounds, which
    # would zero the K/V gradients (kv_dtype="int8" is inference-only)
    cache = KVCache.create(config.replace(kv_dtype="auto"), batch=b, max_seq=t,
                           dtype=torch_dtype(config.dtype), device=dev)
    tokens = tokens.to(device=dev, dtype=torch.long)
    logits, _ = forward_impl(params, tokens, cache, torch.zeros(b, dtype=torch.long, device=dev),
                             config, return_all_logits=True, remat=remat)
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].to(torch.float32).reshape(-1, v),
                           tokens[:, 1:].reshape(-1))


def trainable(tree) -> list[torch.Tensor]:
    """The floating-point tensors of a parameter tree, in tree order
    (quantized leaves' integers and scales are never trained)."""
    if isinstance(tree, dict):
        from llamago_tpu_torch.ops.quant import is_quantized

        if is_quantized(tree):
            return []
        return [t for v in tree.values() for t in trainable(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in trainable(v)]
    return [tree] if isinstance(tree, torch.Tensor) and tree.is_floating_point() else []


def make_optimizer(tensors, lr: float = 1e-4) -> torch.optim.AdamW:
    """AdamW as optax.adamw(lr) computes it, over `tensors` (a parameter
    tree or a list), which it marks as requiring grad."""
    ts = trainable(tensors)
    for t in ts:
        t.requires_grad_(True)
    return torch.optim.AdamW(ts, lr=lr, **ADAMW)


def _step(opt: torch.optim.Optimizer, loss_of) -> torch.Tensor:
    """One optimizer step on loss_of(); each tensor's `.grad` keeps this
    step's gradient afterwards."""
    opt.zero_grad(set_to_none=True)
    loss = loss_of()
    loss.backward()
    opt.step()
    return loss.detach()


def train_step(params, opt_state: torch.optim.Optimizer, tokens: torch.Tensor,
               config: ModelConfig):
    """One training step: loss, grads, AdamW update of every tensor
    `make_optimizer` was given (in place). Returns (params, opt_state,
    loss), as the JAX step does."""
    loss = _step(opt_state, lambda: loss_fn(params, tokens, config))
    return params, opt_state, loss


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return tree.detach()


def save_train_state(path: str, params, opt_state: torch.optim.Optimizer, step: int) -> None:
    """Checkpoint params + optimizer state + step with torch.save (the JAX
    package uses orbax). The inference-side export is
    checkpoint/params.py:export_ggjt_tensors."""
    torch.save({"params": _tensors(params), "opt_state": opt_state.state_dict(),
                "step": step}, os.path.abspath(path))


def load_train_state(path: str, params_like, opt_state_like: torch.optim.Optimizer):
    """Restore a train state into `params_like` (the same tree; its
    tensors are overwritten in place, so an optimizer over them stays
    bound) and `opt_state_like`. Returns (params, opt_state, step)."""
    state = torch.load(os.path.abspath(path), weights_only=True, map_location="cpu")

    def restore(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                restore(dst[k], src[k])
        elif isinstance(dst, (list, tuple)):
            for d, s in zip(dst, src, strict=True):
                restore(d, s)
        else:
            with torch.no_grad():
                dst.copy_(src)

    restore(params_like, state["params"])
    opt_state_like.load_state_dict(state["opt_state"])
    return params_like, opt_state_like, int(state["step"])
