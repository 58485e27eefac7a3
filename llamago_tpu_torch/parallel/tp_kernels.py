"""The single-card kernels per rank, at the shard shapes.

Counterpart of the JAX package's `parallel/tp_kernels.py`. There each
Pallas kernel runs per shard inside `jax.shard_map`; here each rank is a
process holding its local blocks (parallel/sharding.py), so a "shard map"
is the local call itself, followed by the collective XLA would insert:

  col-parallel (wq wk wv w1 w3 output): x replicated over tp -> the local
      kernel on the [K, N/tp] block -> [m, N/tp], no collective (under
      grad x enters through parallel/mesh.py:copy_to, in ops/basic.py:
      linear, whose backward sums the ranks' input gradients).
  row-parallel (wo w2): x's features split over tp -> the local kernel on
      the [K/tp, N] block -> partial [m, N] -> all_reduce(SUM) over tp
      (mesh.py:reduce_from, the identity in the backward).
  dp only: the forward already holds its rows of the batch
      (models/llama.py), the local kernel runs on them.

Under grad the local kernel runs through ops/kernels.py:FrozenQuantMatmul,
as on one card: the kernel forward at the block's shape, JAX's `_dm_bwd`
in plain PyTorch backward.

Attention needs no wrapper here (the JAX package's maybe_tp_attention and
maybe_tp_attention_quant): models/llama.py:_block_sharded calls the
single-card dispatch `_attention` (K2, K7, K4 or the einsum math) on the
rank's heads and slots, and ops/attention.py:attention_math_sp where the
cache's positions are split over sp.

The mesh is process-wide (`activate_mesh`, set once at start-up before
any forward), as ops.kernels.ACTIVE_MESH is in the JAX package.
"""

from __future__ import annotations

import torch

from llamago_tpu_torch.config import ModelConfig
from llamago_tpu_torch.ops.quant import G4X8, QK

_ACTIVE = None


def activate_mesh(mesh) -> None:
    """Declare the process-wide mesh (None: the single-card path)."""
    global _ACTIVE
    _ACTIVE = mesh


def active_mesh():
    return _ACTIVE


def tp_kinds(config: ModelConfig, mesh) -> dict[str, str]:
    """Partition kind per matmul leaf, with the head-count gates of
    param_shardings: attention projections split only when tp divides the
    head count. Empty off a mesh or at tp = 1."""
    if mesh is None or mesh.shape.get("tp", 1) <= 1:
        return {}
    tp = mesh.shape["tp"]
    kinds: dict[str, str] = {"w1": "col", "w3": "col", "w2": "row", "output": "col"}
    if config.n_heads % tp == 0:
        kinds["wq"] = "col"
        kinds["wo"] = "row"
    if config.kv_heads % tp == 0:
        kinds["wk"] = "col"
        kinds["wv"] = "col"
    return kinds


def maybe_tp_matmul(x: torch.Tensor, w: dict, kind: str | None):
    """x @ the rank's block of a quantized leaf w through the local kernel
    (ops/kernels.py:dequant_matmul, or its autograd Function
    FrozenQuantMatmul where grad is enabled and x requires it),
    all-reduced over tp for a row block (parallel/mesh.py:reduce_from,
    whose backward hands every rank the whole gradient).

    Returns None where the JAX function does, and the caller then runs
    the leaf as a whole: no active mesh, a Q4_1 or stacked leaf, a row
    block that is not whole scale groups, or a leaf that is not split
    (kind None) under tp."""
    mesh = active_mesh()
    if mesh is None:
        return None
    if "m" in w or w["s"].dim() != 2:
        return None
    from llamago_tpu_torch.ops import kernels
    from llamago_tpu_torch.parallel.mesh import reduce_from

    def local():
        if torch.is_grad_enabled() and x.requires_grad:
            return kernels.FrozenQuantMatmul.apply(x, w)
        return kernels.dequant_matmul(x, w)

    tp, dp = mesh.shape["tp"], mesh.shape["dp"]
    blk = G4X8 if "q4x" in w else QK
    if kind == "col" and tp > 1:
        return local()
    if kind == "row" and tp > 1 and x.shape[-1] % blk == 0:
        return reduce_from(local(), mesh, "tp")
    if tp == 1 and dp > 1:
        return local()
    return None
