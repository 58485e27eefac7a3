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

Attention routing follows the JAX package's gate (ops/attention.py
can_fuse_attention): windows of t <= 32 query rows (decode steps, prefill
buckets of 16 and 32) take K2 through `flash_attention`; longer windows
take K7, the flash prefill kernel, also through `flash_attention`, on the
card wherever its geometry is one K7 takes (else the einsum math), and the
einsum math on the CPU, as the JAX package's default does; a
LLAMAGO_ATTN_PREFILL_FLOOR in the environment rules on both devices (K7
once a window's f32 scores reach that many bytes; 0: every prefill).
RMSNorm is the plain one unless ops.kernels.USE_FUSED_NORM is set, then
K10 (ops/basic.py).
On the int8 cache (runtime/kv_cache.py, `cache.quantized`) a decode step
writes its new rows through K3 (ops/cache_write.py) and a prefill window
through quantize_kv_rows + write_rows / write_scale_rows; windows of
t <= 32 whose S has an S-block of the TPU kernels take K4/K8
(flash_attention_quant; on the card where its geometry is one the CUDA
kernels take, `quant_takes`), the rest the scale-folded einsum math.

Under an active mesh (parallel/tp_kernels.py:activate_mesh) each rank runs
this forward on its blocks of the weights and of the cache and calls the
collectives the JAX package leaves to GSPMD (`_Shards`): a leaf's shape
tells whether it is this rank's block (parallel/sharding.py); column
blocks give the local heads or FFN columns, row blocks are all-reduced
over tp (ops/basic.py:linear), activations are sliced or all-gathered over
tp where a leaf wants the other layout, the vocab-split head's logits are
gathered over tp; the forward takes its rows of the batch where the cache's
slots are split over dp and gathers the logits over dp; under sp the
attention is attention_math_sp and the cache writes go to the rank's
positions (K3 stays off there, as the JAX package's under any mesh).
Weights stay unfused under tp (the JAX package's choice under a mesh).
Under grad (training, parallel/mesh.py) every collective is the
differentiable form: activations enter column blocks through copy_to,
row blocks and the sp softmax sums reduce through reduce_from, the tp
slices and gathers carry their gradients back, and the new K/V rows enter
the sp ranks' positions through copy_to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.ops.attention import (
    attention_math,
    attention_math_sp,
    can_fuse_attention,
    flash_attention,
    flash_attention_quant,
    quant_takes,
)
from llamago_tpu_torch.ops.basic import linear, rms_norm, rope_tables, rotate, swiglu
from llamago_tpu_torch.ops.cache_write import cache_append_quant
from llamago_tpu_torch.ops.quant import lm_head_padded_cols
from llamago_tpu_torch.parallel.mesh import (
    all_gather,
    broadcast,
    copy_to,
    gather_from,
    tp_slice,
)
from llamago_tpu_torch.parallel.sharding import block_kind
from llamago_tpu_torch.parallel.tp_kernels import active_mesh
from llamago_tpu_torch.runtime.kv_cache import (
    KVCache,
    quantize_kv_rows,
    sp_starts,
    write_rows,
    write_rows_sp,
    write_scale_rows,
)
from llamago_tpu_torch.utils.device import torch_dtype


def _attention(q, k_cache, v_cache, positions, k_scale=None, v_scale=None):
    """Causal attention of q [B, T, H, hd] against the cache; slot j is
    visible to a query at position p iff j <= p (the cache slot j always
    holds the token at absolute position j). k_scale / v_scale are the
    int8 cache's row scales, None for the dense cache."""
    if k_scale is not None:
        if quant_takes(q, k_cache):
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


class _Shards:
    """One rank's side of a forward under the mesh: which leaves are this
    rank's blocks, the tp slicing and gathering of activations, and, where
    the cache's positions are split over sp, this rank's first position
    (`offset`) and the window's global write starts (`starts`, host).
    Under grad the slicing and gathering are the differentiable forms of
    parallel/mesh.py."""

    def __init__(self, mesh, config: ModelConfig, cache: KVCache, write_pos, t: int):
        self.mesh = mesh
        self.config = config
        self.tp = mesh.shape["tp"]
        self.seq_split = cache.seq_split > 1
        self.starts = self.offset = None
        if self.seq_split:
            s_l = cache.max_seq
            self.offset = mesh.coord("sp") * s_l
            self.starts = sp_starts(write_pos, s_l * cache.seq_split, t)

    def linear(self, x, x_split: bool, w, key: str):
        """(x @ w, whether the output is this rank's column block), for x
        whole or this rank's block of its features (`x_split`). Where the
        loader cut the leaf `key` (parallel/sharding.py:block_kind), a row
        block takes this rank's slice of x and its product is all-reduced
        over tp, a column block gives this rank's columns; a whole leaf
        takes x whole (gathered over tp)."""
        kind = block_kind(key, w, self.config, self.mesh)
        if kind == "row":
            return linear(self.split(x, x_split), w, tp_kind="row"), False
        x = self.full(x, x_split)
        if kind == "col":
            return linear(x, w, tp_kind="col"), True
        return linear(x, w), False

    def split(self, x, is_split: bool):
        return x if is_split or self.tp == 1 else tp_slice(x, self.mesh)

    def full(self, x, is_split: bool):
        return gather_from(x, self.mesh, "tp", dim=-1) if is_split else x


def _block_sharded(x, lp, k_layer, v_layer, ks_l, vs_l, write_pos, positions, cos, sin,
                   config: ModelConfig, sh: _Shards):
    """`_block` on this rank's blocks: attention on the cache's local kv
    heads (the local query heads; all heads where tp does not divide the
    kv heads, as the JAX package then attends over the whole cache), row
    blocks all-reduced over tp."""
    b, t = x.shape[:2]
    hd, h_all, kv_all, f = config.head_dim, config.n_heads, config.kv_heads, config.ffn_hidden
    h = rms_norm(x, lp["attention_norm"], config.norm_eps)
    if "wqkv" in lp:  # fused leaves are whole: tp = 1
        qkv = linear(h, lp["wqkv"])
        q, k, v = qkv.split([h_all * hd, kv_all * hd, kv_all * hd], dim=-1)
        q_split = k_split = v_split = False
    else:
        q, q_split = sh.linear(h, False, lp["wq"], "wq")
        k, k_split = sh.linear(h, False, lp["wk"], "wk")
        v, v_split = sh.linear(h, False, lp["wv"], "wv")
    heads_split = sh.tp > 1 and k_layer.shape[1] * sh.tp == kv_all
    conv = sh.split if heads_split else sh.full
    q, k, v = conv(q, q_split), conv(k, k_split), conv(v, v_split)
    q = rotate(q.reshape(b, t, q.shape[-1] // hd, hd), cos, sin)
    k = rotate(k.reshape(b, t, k.shape[-1] // hd, hd), cos, sin)
    v = v.reshape(b, t, v.shape[-1] // hd, hd)

    if sh.seq_split:
        if ks_l is None:
            # under grad the new rows enter each rank's positions through
            # copy_to (their gradient is summed over sp) and go into copies
            # of the cache layer, as _write_cache writes them on one card
            k, v = copy_to(k, sh.mesh, "sp"), copy_to(v, sh.mesh, "sp")
            if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad):
                k_layer, v_layer = k_layer.clone(), v_layer.clone()
            write_rows_sp(k_layer, k, sh.starts, sh.offset)
            write_rows_sp(v_layer, v, sh.starts, sh.offset)
        else:
            kq, ks_new = quantize_kv_rows(k)
            vq, vs_new = quantize_kv_rows(v)
            for layer, new in ((k_layer, kq), (v_layer, vq), (ks_l, ks_new), (vs_l, vs_new)):
                write_rows_sp(layer, new, sh.starts, sh.offset)
    else:
        k_layer, v_layer = _write_cache(k_layer, v_layer, ks_l, vs_l, k, v, write_pos)
    if sh.seq_split:
        attn = attention_math_sp(q, k_layer, v_layer, positions, sh.mesh, ks_l, vs_l)
    else:
        attn = _attention(q, k_layer, v_layer, positions, ks_l, vs_l)
    o, _ = sh.linear(attn, heads_split, lp["wo"], "wo")
    x = x + o

    h = rms_norm(x, lp["ffn_norm"], config.norm_eps)
    if "w13" in lp:
        g1, g3 = linear(h, lp["w13"]).split([f, f], dim=-1)
        s1 = s3 = False
    else:
        g1, s1 = sh.linear(h, False, lp["w1"], "w1")
        g3, s3 = sh.linear(h, False, lp["w3"], "w3")
    if s1 != s3:
        g1, g3, s1 = sh.full(g1, s1), sh.full(g3, s3), False
    gate = F.silu(g1.to(torch.float32)).to(h.dtype)
    o, _ = sh.linear(gate * g3, s1, lp["w2"], "w2")
    return x + o, k_layer, v_layer


def _block(x, lp, k_layer, v_layer, ks_l, vs_l, write_pos, positions, cos, sin,
           config: ModelConfig, sh: _Shards | None = None):
    """One transformer layer over x [B, T, D]: attention over the cache
    layer (written first) and the FFN, each added to the residual. Returns
    (x, k_layer, v_layer): the cache layer's tensors after the write."""
    if sh is not None:
        return _block_sharded(x, lp, k_layer, v_layer, ks_l, vs_l, write_pos, positions,
                              cos, sin, config, sh)
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
    gather_dp: bool = True,  # gather the logits rows over dp (False: training)
):
    """One transformer step (prefill when T>1, decode when T=1).

    Returns (logits, cache): logits [B, T, V] f32 if return_all_logits,
    else [B, V] at `logit_index` (right-padded bucketed prefill) or the
    last position. With return_embedding a third element [B, D] f32 is
    appended: the final-RMSNorm'd hidden state at that position. With
    remat (training) each layer runs under torch.utils.checkpoint, so the
    backward recomputes its activations instead of keeping them, as
    jax.checkpoint does in the JAX package; under a mesh the recomputation
    re-runs the layer's collectives, so it never stops early (every rank
    recomputes the same ops in the same order). Where the cache's slots
    are split over dp, the logits (and embeddings) of this rank's rows are
    gathered over dp unless `gather_dp` is False: training keeps each dp
    rank's loss over its own rows (models/training.py)."""
    mesh = active_mesh()
    dp_rows = mesh is not None and cache.batch_split > 1
    if dp_rows:  # this rank's rows of the batch: its slots of the cache
        rows = slice(mesh.coord("dp") * cache.batch, (mesh.coord("dp") + 1) * cache.batch)
        tokens, write_pos = tokens[rows], write_pos[rows]
        if logit_index is not None:
            logit_index = logit_index[rows]
    b, t = tokens.shape
    dtype = torch_dtype(config.dtype)
    dev = cache.k[0].device
    write_pos = write_pos.to(device=dev, dtype=torch.long)
    sh = None if mesh is None or mesh.world == 1 else _Shards(mesh, config, cache, write_pos, t)
    positions = write_pos[:, None] + torch.arange(t, device=dev)[None, :]  # [B, T]
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta, dtype)

    x = params["tok_embeddings"][tokens.to(device=dev, dtype=torch.long)].to(dtype)

    no_scales = [None] * config.n_layers
    layers = _layer_list(params["layers"], config.n_layers)
    for i, (lp, ks_l, vs_l) in enumerate(zip(layers, cache.ks or no_scales,
                                             cache.vs or no_scales)):
        args = (x, lp, cache.k[i], cache.v[i], ks_l, vs_l, write_pos, positions, cos, sin,
                config, sh)
        if remat:
            with set_checkpoint_early_stop(False):
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
    if sh is not None and block_kind("output", params["output"], config, mesh) == "col":
        logits = gather_from(linear(x, params["output"], compute_dtype=dtype, tp_kind="col"),
                             mesh, "tp", dim=-1).to(torch.float32)
    else:
        logits = linear(x, params["output"], compute_dtype=dtype).to(torch.float32)
    # The int8 lm head may be column-padded (ops/quant.py:pad_lm_head).
    # Slice BEFORE anything consumes logits: the pad columns dequantize to
    # exactly 0, which would beat negative real logits under argmax. Slice
    # ONLY the width pad_lm_head produces; wider heads of converted
    # checkpoints keep their extra logits.
    if (logits.shape[-1] != config.vocab_size
            and logits.shape[-1] == lm_head_padded_cols(config.vocab_size)):
        logits = logits[..., :config.vocab_size]

    if dp_rows and gather_dp:
        logits = all_gather(logits, mesh, "dp", dim=0)
    if return_embedding:
        emb = (x[:, -1, :] if return_all_logits else x).to(torch.float32)
        if dp_rows and gather_dp:
            emb = all_gather(emb, mesh, "dp", dim=0)
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
    cache is updated in place. Where the slots are split over dp, the
    ranks that hold the slot run it and send its logits to the rest of
    their dp group. Returns (logits [V], cache)."""
    if cache.batch_split == 1:
        logits, _ = forward_impl(params, tokens, cache.slot(slot), write_pos, config,
                                 logit_index=logit_index)
        return logits[0], cache
    mesh = active_mesh()
    owner, local = divmod(slot, cache.batch)
    if mesh.coord("dp") == owner:
        logits = forward_impl(params, tokens, cache.slot(local), write_pos, config,
                              logit_index=logit_index)[0][0]
    else:
        logits = torch.empty(config.vocab_size, dtype=torch.float32, device=cache.k[0].device)
    return broadcast(logits, mesh, "dp", owner), cache
