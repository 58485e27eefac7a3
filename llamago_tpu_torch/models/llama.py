"""LLaMA transformer as a plain function over a parameter tree.

Counterpart of the JAX package's `models/llama.py` on its unrolled,
layered path (reference: Eval, pkg/llama/llama.go:211-426). Per layer:

  x += wo @ attn(rope(q), rope(k), v)  over RMSNorm(x)*attention_norm
  x += w2 @ (silu(w1 h) * (w3 h))      over RMSNorm(x)*ffn_norm
final: logits = output @ (RMSNorm(x)*norm)   (llama.go:374-384)

Parameter tree (checkpoint/params.py): {"tok_embeddings" [V, D], "norm"
[D], "output" [D, V] or a quantized leaf, "layers": a tuple of per-layer dicts,
or one dict of [L, ...] stacked leaves}, with fused "wqkv"/"w13" leaves or
separate "wq"/"wk"/"wv"/"w1"/"w3", or LoRA leaves over them
(models/lora.py). Rotated K is cached once; the KV cache is updated in
place (runtime/kv_cache.py), or, where autograd tracks the new rows
(training), through copies that the cache then holds.

Attention routing follows the JAX package (ops/attention.py
can_fuse_attention): windows of t <= 32 query rows (decode steps, prefill
buckets of 16 and 32) take K2 through `flash_attention`; longer windows
take the einsum math by default, and K7, the flash prefill kernel, also
through `flash_attention`, once their f32 scores reach
LLAMAGO_ATTN_PREFILL_FLOOR bytes (0: every prefill). RMSNorm is the plain
one unless ops.kernels.USE_FUSED_NORM is set, then K10 (ops/basic.py).
On the int8 cache (runtime/kv_cache.py, `cache.quantized`) a decode step
writes its new rows through K3 (ops/cache_write.py) and a prefill window
through quantize_kv_rows + write_rows / write_scale_rows; windows of
t <= 32 whose S has an S-block of the TPU kernels take K4/K8
(flash_attention_quant), the rest the scale-folded einsum math.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.ops.attention import (
    attention_math,
    can_fuse_attention,
    flash_attention,
    flash_attention_quant,
    quant_fits,
)
from llamago_tpu_torch.ops.basic import linear, rms_norm, rope_tables, rotate, swiglu
from llamago_tpu_torch.ops.cache_write import cache_append_quant
from llamago_tpu_torch.ops.quant import lm_head_padded_cols
from llamago_tpu_torch.runtime.kv_cache import (
    KVCache,
    quantize_kv_rows,
    write_rows,
    write_scale_rows,
)
from llamago_tpu_torch.utils.device import torch_dtype


def _attention(q, k_cache, v_cache, positions, k_scale=None, v_scale=None):
    """Causal attention of q [B, T, H, hd] against the cache; slot j is
    visible to a query at position p iff j <= p (the cache slot j always
    holds the token at absolute position j). k_scale / v_scale are the
    int8 cache's row scales, None for the dense cache."""
    if k_scale is not None:
        if quant_fits(q.shape[1], k_cache.shape[2]):
            return flash_attention_quant(q, k_cache, v_cache, positions, k_scale, v_scale)
        return attention_math(q, k_cache, v_cache, positions, k_scale, v_scale)
    if can_fuse_attention(q, k_cache):
        return flash_attention(q, k_cache, v_cache, positions)
    return attention_math(q, k_cache, v_cache, positions)


def _write_cache(k_layer, v_layer, ks_l, vs_l, k, v, write_pos):
    """Write the new rows k / v [B, T, KV, hd] into one layer of the cache
    and return the layer's (k, v). On the int8 cache a decode step takes
    K3; a prefill window is quantized and written by plain PyTorch, as the
    JAX package does (it has no kernel for t > 1). The writes are in place,
    except where autograd tracks k or v (training, dense cache only): then
    they go into copies, so that neither the backward nor a recomputed
    layer finds a saved tensor overwritten."""
    if ks_l is None:
        if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad):
            k_layer, v_layer = k_layer.clone(), v_layer.clone()
        write_rows(k_layer, k, write_pos)
        write_rows(v_layer, v, write_pos)
    elif k.shape[1] == 1:
        cache_append_quant(k_layer, v_layer, ks_l, vs_l, k, v, write_pos)
    else:
        kq, ks_new = quantize_kv_rows(k)
        vq, vs_new = quantize_kv_rows(v)
        write_rows(k_layer, kq, write_pos)
        write_rows(v_layer, vq, write_pos)
        write_scale_rows(ks_l, ks_new, write_pos)
        write_scale_rows(vs_l, vs_new, write_pos)
    return k_layer, v_layer


def _layer_list(layers, n_layers: int) -> list[dict]:
    """Per-layer dicts from a tuple/list, or views of a stacked dict."""
    if isinstance(layers, (list, tuple)):
        return list(layers)

    def at(v, i):
        return {k: a[i] for k, a in v.items()} if isinstance(v, dict) else v[i]

    return [{k: at(v, i) for k, v in layers.items()} for i in range(n_layers)]


def _block(x, lp, k_layer, v_layer, ks_l, vs_l, write_pos, positions, cos, sin,
           config: ModelConfig):
    """One transformer layer over x [B, T, D]: attention over the cache
    layer (written first) and the FFN, each added to the residual. Returns
    (x, k_layer, v_layer): the cache layer's tensors after the write."""
    b, t = x.shape[:2]
    q_dim = config.n_heads * config.head_dim
    kv_dim = config.kv_heads * config.head_dim
    hidden = config.ffn_hidden
    h = rms_norm(x, lp["attention_norm"], config.norm_eps)
    if "wqkv" in lp:
        qkv = linear(h, lp["wqkv"])
        q = qkv[..., :q_dim]
        k = qkv[..., q_dim:q_dim + kv_dim]
        v = qkv[..., q_dim + kv_dim:]
    else:
        q, k, v = linear(h, lp["wq"]), linear(h, lp["wk"]), linear(h, lp["wv"])
    q = rotate(q.reshape(b, t, config.n_heads, config.head_dim), cos, sin)
    k = rotate(k.reshape(b, t, config.kv_heads, config.head_dim), cos, sin)
    v = v.reshape(b, t, config.kv_heads, config.head_dim)

    k_layer, v_layer = _write_cache(k_layer, v_layer, ks_l, vs_l, k, v, write_pos)
    attn = _attention(q, k_layer, v_layer, positions, ks_l, vs_l)
    x = x + linear(attn, lp["wo"])

    h = rms_norm(x, lp["ffn_norm"], config.norm_eps)
    if "w13" in lp:
        h13 = linear(h, lp["w13"])
        gate = F.silu(h13[..., :hidden].to(torch.float32)).to(h.dtype)
        x = x + linear(gate * h13[..., hidden:], lp["w2"])
    else:
        x = x + swiglu(h, lp["w1"], lp["w2"], lp["w3"])
    return x, k_layer, v_layer


def forward_impl(
    params,
    tokens: torch.Tensor,  # [B, T] integer
    cache: KVCache,
    write_pos: torch.Tensor,  # [B] — first cache slot to write
    config: ModelConfig,
    return_all_logits: bool = False,
    logit_index: torch.Tensor | None = None,  # [B] per-batch position
    return_embedding: bool = False,
    remat: bool = False,  # recompute each layer's activations in the backward
):
    """One transformer step (prefill when T>1, decode when T=1).

    Returns (logits, cache): logits [B, T, V] f32 if return_all_logits,
    else [B, V] at `logit_index` (right-padded bucketed prefill) or the
    last position. With return_embedding a third element [B, D] f32 is
    appended: the final-RMSNorm'd hidden state at that position. With
    remat (training) each layer runs under torch.utils.checkpoint, so the
    backward recomputes its activations instead of keeping them, as
    jax.checkpoint does in the JAX package."""
    b, t = tokens.shape
    dtype = torch_dtype(config.dtype)
    dev = cache.k[0].device
    write_pos = write_pos.to(device=dev, dtype=torch.long)
    positions = write_pos[:, None] + torch.arange(t, device=dev)[None, :]  # [B, T]
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta, dtype)

    x = params["tok_embeddings"][tokens.to(device=dev, dtype=torch.long)].to(dtype)

    no_scales = [None] * config.n_layers
    layers = _layer_list(params["layers"], config.n_layers)
    for i, (lp, ks_l, vs_l) in enumerate(zip(layers, cache.ks or no_scales,
                                             cache.vs or no_scales)):
        args = (x, lp, cache.k[i], cache.v[i], ks_l, vs_l, write_pos, positions, cos, sin,
                config)
        if remat:
            x, cache.k[i], cache.v[i] = checkpoint(_block, *args, use_reentrant=False)
        else:
            x, cache.k[i], cache.v[i] = _block(*args)

    x = rms_norm(x, params["norm"], config.norm_eps)
    if not return_all_logits:
        if logit_index is None:
            x = x[:, -1, :]
        else:
            idx = logit_index.to(device=dev, dtype=torch.long)
            x = x[torch.arange(b, device=dev), idx]
    logits = linear(x, params["output"], compute_dtype=dtype).to(torch.float32)
    # The int8 lm head may be column-padded (ops/quant.py:pad_lm_head).
    # Slice BEFORE anything consumes logits: the pad columns dequantize to
    # exactly 0, which would beat negative real logits under argmax. Slice
    # ONLY the width pad_lm_head produces; wider heads of converted
    # checkpoints keep their extra logits.
    if (logits.shape[-1] != config.vocab_size
            and logits.shape[-1] == lm_head_padded_cols(config.vocab_size)):
        logits = logits[..., :config.vocab_size]

    if return_embedding:
        emb = (x[:, -1, :] if return_all_logits else x).to(torch.float32)
        return logits, cache, emb
    return logits, cache


def prefill_into_slot(
    params,
    tokens: torch.Tensor,  # [1, T] (right-padded to a bucket)
    cache: KVCache,  # full engine cache, batch = n_slots
    slot: int,
    write_pos: torch.Tensor,  # [1]
    logit_index: torch.Tensor,  # [1] — last REAL prompt position
    config: ModelConfig,
):
    """Prefill one decode slot of a multi-slot cache at batch 1. The
    forward pass writes through views of the slot's rows, so the full
    cache is updated in place. Returns (logits [V], cache)."""
    logits, _ = forward_impl(params, tokens, cache.slot(slot), write_pos, config,
                             logit_index=logit_index)
    return logits[0], cache
