"""Core compute ops: RMSNorm, adjacent-pair RoPE, linear, SwiGLU.

Counterparts of the JAX package's `ops/basic.py` (reference kernels:
RMSNorm ml.go:1753-1812, RoPE ml.go:2253-2328, SiLU ml.go:2599). `linear`
is the seam where block-quantized weights (Q8_0, Q4_0, Q4_1, w4x8)
dispatch to the quantized matmuls (ops/quant.py:quant_matmul,
ops/kernels.py) and LoRA leaves add their low-rank update.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """promote_types(dtype, float32): f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with the reduction in f32. The normalized activations are
    cast back to the activation dtype BEFORE the weight multiply, and the
    weight is cast to the activation dtype, as the JAX package does. With
    ops.kernels.USE_FUSED_NORM it is K10 instead (one rounding)."""
    from llamago_tpu_torch.ops import kernels

    if kernels.can_fuse_norm(x):
        return kernels.fused_rms_norm(x, weight, eps)
    xf = x.to(_acc_dtype(x.dtype))
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf / rms).to(x.dtype) * weight.to(x.dtype)


def rope_tables(positions: torch.Tensor, hd: int, theta: float,
                dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [B, T, 1, hd/2] of the rotary angles for positions [B, T],
    in promote(dtype, f32). The forward pass builds them once per step and
    rotates every layer's q and k with them."""
    f = _acc_dtype(dtype)
    freqs = theta ** (torch.arange(0, hd // 2, dtype=f, device=positions.device)
                      * (-2.0 / hd))
    angles = positions.to(f)[:, :, None] * freqs  # [B, T, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ADJACENT pairs (x[2i], x[2i+1]) of x [B, T, H, hd] by the
    rope_tables angles — the ggml/Meta convention, not rotate-half."""
    b, t, h, hd = x.shape
    xf = x.to(cos.dtype).reshape(b, t, h, hd // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(b, t, h, hd).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over adjacent pairs with f32 angles.
    x [B, T, H, hd], positions [B, T]."""
    cos, sin = rope_tables(positions, x.shape[-1], theta, x.dtype)
    return rotate(x, cos, sin)


def linear(x: torch.Tensor, w, compute_dtype: torch.dtype | None = None,
           tp_kind: str | None = None) -> torch.Tensor:
    """x @ w. `w` is a dense [in, out] tensor, a quantized leaf
    ({"q8" | "q4" | "q4x", "s"[, "m"]}, ops/quant.py), which goes to
    `quant_matmul`, or a LoRA leaf ({"base", "lora_a", "lora_b",
    "lora_scale"}, models/lora.py): base(x) + ((x @ a) @ b) * scale, with
    a, b and scale in x.dtype. A dense base is detached (frozen, as
    `stop_gradient` freezes it in the JAX package); a quantized base is
    frozen by `kernels.FrozenQuantMatmul`. `tp_kind` ("col" / "row" /
    None) says that w is this rank's column or row block under the active
    mesh (parallel/): x enters a column block through `copy_to` and a row
    block's partial product is summed over tp by `reduce_from`, the
    differentiable collectives of parallel/mesh.py."""
    if isinstance(w, dict) and "lora_a" in w:
        return _lora_linear(x, w, compute_dtype, tp_kind)
    if tp_kind == "col":
        from llamago_tpu_torch.parallel.mesh import copy_to
        from llamago_tpu_torch.parallel.tp_kernels import active_mesh

        x = copy_to(x, active_mesh(), "tp")
    if isinstance(w, dict):
        from llamago_tpu_torch.ops.quant import quant_matmul

        return quant_matmul(x, w, tp_kind=tp_kind)
    dtype = compute_dtype or x.dtype
    out = torch.matmul(x.to(dtype), w.to(dtype))
    if tp_kind == "row":
        from llamago_tpu_torch.parallel.mesh import reduce_from
        from llamago_tpu_torch.parallel.tp_kernels import active_mesh

        out = reduce_from(out, active_mesh(), "tp")
    return out


def _lora_linear(x: torch.Tensor, w: dict, compute_dtype, tp_kind: str | None) -> torch.Tensor:
    """A LoRA leaf's product. On a rank's blocks under tp the adapter is cut
    with its base: a column block holds B's columns [r, N/tp] (A whole, its
    x @ A entering through `copy_to`), a row block A's rows [K/tp, r] (B
    whole): x @ A is then a partial sum, reduced in the same all_reduce as
    the base's partial product. Every adapter's gradient is whole on the
    rank that holds it."""
    from llamago_tpu_torch.parallel.mesh import copy_to, reduce_from
    from llamago_tpu_torch.parallel.tp_kernels import active_mesh

    base_w = w["base"]
    if not isinstance(base_w, dict):
        base_w = base_w.detach()
    a, b = w["lora_a"].to(x.dtype), w["lora_b"].to(x.dtype)
    if tp_kind == "row":
        part = linear(x, base_w, compute_dtype=compute_dtype)  # this rank's partial
        n = part.shape[-1]
        both = reduce_from(torch.cat([part, torch.matmul(x, a).to(part.dtype)], dim=-1),
                           active_mesh(), "tp")
        base, xa = both[..., :n], both[..., n:].to(x.dtype)
    else:
        base = linear(x, base_w, compute_dtype=compute_dtype, tp_kind=tp_kind)
        xa = torch.matmul(x, a)
        if tp_kind == "col":
            xa = copy_to(xa, active_mesh(), "tp")
    delta = torch.matmul(xa, b) * w["lora_scale"].to(x.dtype)
    return base + delta.to(base.dtype)


def swiglu(x: torch.Tensor, w1, w2, w3) -> torch.Tensor:
    """SwiGLU FFN: w2 @ (silu(w1 x) * (w3 x)), silu in f32
    (reference: llama.go:354-363)."""
    gate = F.silu(linear(x, w1).to(torch.float32)).to(x.dtype)
    up = linear(x, w3)
    return linear(gate * up, w2)
