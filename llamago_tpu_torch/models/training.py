"""Training step: next-token cross-entropy + AdamW.

Counterpart of the JAX package's `models/training.py`: a real train step
over the same forward (models/llama.py), on one device. The gradients of
the kernels' calls come from their autograd Functions
(ops/kernels.py:FrozenQuantMatmul, ops/attention.py:FlashAttention), whose
backwards are the JAX package's custom VJPs in plain PyTorch. The
optimizer is torch.optim.AdamW with optax.adamw's defaults (b1 0.9, b2
0.999, eps 1e-8, weight decay 1e-4 on every trained leaf), and the train
state is saved with torch.save where the JAX package uses orbax.

Under the active mesh (parallel/, one process a rank) the step is the JAX
package's SPMD step: the forward runs on the rank's blocks with the
differentiable collectives of parallel/mesh.py, so the loss is whole on
every tp and sp rank and each tensor's gradient is whole on its rank (a
block's for a block); each dp rank's loss is over its own rows of the
batch, the reported loss is the mean over all rows, and after the backward
the gradients are summed over dp (`sync_grads`: the loss's dp mean hands
each rank 1/dp of its rows' gradient). AdamW then runs on each rank over
its blocks and the replicated leaves, which `sync_grads` keeps bit-equal
across ranks by broadcasting their gradients from the first rank of each
tp and sp group. The train state is saved a file a rank and restores onto
the same mesh, as orbax restores a sharded tree.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.models.llama import forward_impl
from llamago_tpu_torch.parallel.mesh import all_reduce, broadcast, reduce_from
from llamago_tpu_torch.parallel.sharding import block_kind
from llamago_tpu_torch.parallel.tp_kernels import active_mesh
from llamago_tpu_torch.runtime.kv_cache import KVCache
from llamago_tpu_torch.utils.device import torch_dtype

# optax.adamw's defaults; torch.optim.AdamW's own weight decay is 1e-2
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def loss_fn(params, tokens: torch.Tensor, config: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy over [B, T] token batches, in f32.
    Under a mesh the cache is the rank's block, and where dp splits the
    batch the rank's loss is over its rows; the value returned is the mean
    over all rows (module docstring)."""
    b, t = tokens.shape
    dev = params["tok_embeddings"].device
    mesh = active_mesh()
    # training always uses a dense cache: quantize_kv_rows rounds, which
    # would zero the K/V gradients (kv_dtype="int8" is inference-only)
    cache = KVCache.create(config.replace(kv_dtype="auto"), batch=b, max_seq=t,
                           dtype=torch_dtype(config.dtype), device=dev, mesh=mesh)
    tokens = tokens.to(device=dev, dtype=torch.long)
    logits, cache = forward_impl(params, tokens, cache,
                                 torch.zeros(b, dtype=torch.long, device=dev), config,
                                 return_all_logits=True, remat=remat, gather_dp=False)
    if cache.batch_split > 1:
        i = mesh.coord("dp")
        tokens = tokens[i * cache.batch:(i + 1) * cache.batch]
    v = logits.shape[-1]
    loss = F.cross_entropy(logits[:, :-1].to(torch.float32).reshape(-1, v),
                           tokens[:, 1:].reshape(-1))
    if mesh is not None and mesh.dp > 1:
        loss = reduce_from(loss, mesh, "dp") / mesh.dp
    return loss


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


def tp_whole(params, config: ModelConfig, mesh) -> list[torch.Tensor]:
    """The trainable tensors of a tree that are the same on every tp rank:
    every dense leaf the loader kept whole, and of a LoRA leaf on a block
    the adapter half that is not cut (A of a column block, B of a row
    block; ops/basic.py:_lora_linear)."""
    out: list[torch.Tensor] = []

    def visit(key, node):
        if isinstance(node, dict) and "lora_a" in node:
            kind = block_kind(key, node, config, mesh)
            out.extend(node[k] for k, cut in (("lora_a", "row"), ("lora_b", "col"))
                       if kind != cut)
        elif isinstance(node, torch.Tensor) and block_kind(key, node, config, mesh) is None:
            out.append(node)

    for key in ("tok_embeddings", "norm", "output"):
        visit(key, params[key])
    layers = params["layers"]
    for lp in layers if isinstance(layers, (list, tuple)) else [layers]:
        for key, node in lp.items():
            visit(key, node)
    return [t for t in out if t.is_floating_point()]


def _flat_sync(grads: list[torch.Tensor], collective) -> None:
    """Run one collective over the gradients packed into one f32 buffer
    and unpack its result into them, in place."""
    if not grads:
        return
    flat = collective(torch.cat([g.reshape(-1).to(torch.float32) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def sync_grads(tensors: list[torch.Tensor], whole_over_tp: list[torch.Tensor], mesh) -> None:
    """After the backward under a mesh: sum the gradients of `tensors` over
    dp, then give every rank of a tp group its first rank's gradients of
    the tensors replicated over tp (those of `whole_over_tp` among
    `tensors`), and every rank of an sp group its first rank's (sp splits
    no weight). Each is one collective over a packed buffer. A tensor
    without a gradient gets zeros."""
    if mesh is None or mesh.world == 1:
        return
    for t in tensors:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    grads = [t.grad for t in tensors]
    if "dp" in mesh.groups:
        _flat_sync(grads, lambda f: all_reduce(f, mesh, "dp"))
    if "tp" in mesh.groups:
        trained = {id(t) for t in tensors}
        _flat_sync([t.grad for t in whole_over_tp if id(t) in trained],
                   lambda f: broadcast(f, mesh, "tp", 0))
    if "sp" in mesh.groups:
        _flat_sync(grads, lambda f: broadcast(f, mesh, "sp", 0))


def _step(opt: torch.optim.Optimizer, loss_of, params, config: ModelConfig) -> torch.Tensor:
    """One optimizer step on loss_of(); each tensor's `.grad` keeps this
    step's gradient afterwards. Under the active mesh the gradients are
    synced (`sync_grads`, `params` telling the blocks from the replicated
    leaves) between the backward and the update."""
    opt.zero_grad(set_to_none=True)
    loss = loss_of()
    loss.backward()
    mesh = active_mesh()
    if mesh is not None and mesh.world > 1:
        tensors = [t for group in opt.param_groups for t in group["params"]]
        sync_grads(tensors, tp_whole(params, config, mesh), mesh)
    opt.step()
    return loss.detach()


def train_step(params, opt_state: torch.optim.Optimizer, tokens: torch.Tensor,
               config: ModelConfig):
    """One training step: loss, grads, AdamW update of every tensor
    `make_optimizer` was given (in place). Returns (params, opt_state,
    loss), as the JAX step does; under a mesh the step of every rank."""
    loss = _step(opt_state, lambda: loss_fn(params, tokens, config), params, config)
    return params, opt_state, loss


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return tree.detach()


def _state_path(path: str) -> str:
    """The train state's file of this rank: `path` itself off a mesh,
    `path.rank<r>-of-<world>` on one."""
    mesh = active_mesh()
    path = os.path.abspath(path)
    return path if mesh is None or mesh.world == 1 else f"{path}.rank{mesh.rank}-of-{mesh.world}"


def _mesh_shape() -> dict:
    mesh = active_mesh()
    return {"dp": 1, "sp": 1, "tp": 1} if mesh is None else mesh.shape


def save_train_state(path: str, params, opt_state: torch.optim.Optimizer, step: int) -> None:
    """Checkpoint params + optimizer state + step with torch.save (the JAX
    package uses orbax); under a mesh every rank saves its blocks and its
    optimizer state to its own file (`_state_path`). The inference-side
    export is checkpoint/params.py:export_ggjt_tensors."""
    torch.save({"params": _tensors(params), "opt_state": opt_state.state_dict(),
                "step": step, "mesh": _mesh_shape()}, _state_path(path))


def load_train_state(path: str, params_like, opt_state_like: torch.optim.Optimizer):
    """Restore a train state into `params_like` (the same tree; its
    tensors are overwritten in place, so an optimizer over them stays
    bound) and `opt_state_like`; under a mesh each rank its own file, on
    the mesh it was saved from. Returns (params, opt_state, step)."""
    state = torch.load(_state_path(path), weights_only=True, map_location="cpu")
    if state.get("mesh", _mesh_shape()) != _mesh_shape():
        raise ValueError(f"train state saved on the mesh {state['mesh']}, restored on "
                         f"{_mesh_shape()}")

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
