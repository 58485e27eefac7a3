"""The benchmark's weights: Q8_0 blocks drawn on the device from the seed.

Every group of tensors (the embedding table, the head, the norm gains, and
each layer's seven matrices) has a generator of its own, seeded from the
run's seed and the group's name, so that one group can be drawn again alone:
the harness draws every group once to hand the port its checkpoint, and the
reference draws each layer again, after the program has been freed, to
dequantize it itself. A layer is two calls: its quants, int8 uniform in
[-127, 127], and its block scales, f16, uniform in [0.5, 1.5) times a base
chosen so that a matrix's weights have a spread of 1/sqrt(in), about a
trained model's (0.016 at 4096 inputs). Norm gains are f32, uniform in
[0.8, 1.2). Pure PyTorch: the reference imports it.
"""

from __future__ import annotations

import hashlib

import torch

from benchmark.reference.dims import Q8_BLOCK_BYTES, QK, Dims

# spread of a quant uniform in [-127, 127], times the rms of U[0.5, 1.5)
_Q_RMS = 73.6 * (1.0 + 1.0 / 12.0) ** 0.5


def generator(seed: int, tag: str, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, tag): 63 bits of a hash."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return g


def _draw(shapes: dict[str, tuple[int, int]], seed: int, tag: str, device) -> dict:
    """Quants and scales of the matrices `shapes` ({name: (out, in)}), in
    two calls on one generator: {name: (q int8 [out, in], s f16 [out, in/32])}."""
    g = generator(seed, tag, device)
    sizes = [o * i for o, i in shapes.values()]
    q_all = torch.randint(-127, 128, (sum(sizes),), generator=g, dtype=torch.int8,
                          device=device)
    s_all = torch.rand((sum(sizes) // QK,), generator=g, dtype=torch.float32, device=device)
    out, at = {}, 0
    for (name, (o, i)), n in zip(shapes.items(), sizes):
        q = q_all[at:at + n].view(o, i)
        base = 1.0 / (i ** 0.5 * _Q_RMS)
        s = ((s_all[at // QK:(at + n) // QK] + 0.5) * base).to(torch.float16).view(o, i // QK)
        out[name] = (q, s)
        at += n
    return out


def layer_blocks(dims: Dims, seed: int, layer: int, device) -> dict:
    """Layer `layer`'s seven matrices as Q8_0 (q, s), file layout [out, in]."""
    return _draw(dims.layer_matrices(), seed, f"layer{layer}", device)


def table_blocks(dims: Dims, seed: int, name: str, device):
    """The embedding table ("tok_embeddings") or the head ("output") as
    Q8_0 (q, s), [vocab, dim]."""
    return _draw({name: (dims.vocab, dims.dim)}, seed, name, device)[name]


def norm_gains(dims: Dims, seed: int, device) -> dict[str, torch.Tensor]:
    """attention_norm and ffn_norm [layers, dim] and the final norm [dim], f32."""
    g = generator(seed, "norms", device)
    n, d = dims.n_layers, dims.dim
    w = torch.rand((2 * n + 1, d), generator=g, dtype=torch.float32, device=device) * 0.4 + 0.8
    return {"attention_norm": w[:n], "ffn_norm": w[n:2 * n], "norm": w[2 * n]}


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Q8_0 (q [out, in], s [out, in/32]) -> f32 [out, in]: q times its block's scale."""
    o, i = q.shape
    return (q.view(o, i // QK, QK).float() * s.float()[..., None]).view(o, i)


def pack_q8_0(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The file's bytes of a Q8_0 matrix: [out, blocks * 34] uint8, each block
    its f16 scale (little-endian) and then its 32 quants (ggml's block_q8_0)."""
    o, i = q.shape
    nb = i // QK
    raw = torch.empty((o, nb, Q8_BLOCK_BYTES), dtype=torch.uint8, device=q.device)
    raw[:, :, :2] = s.contiguous().view(torch.uint8).view(o, nb, 2)
    raw[:, :, 2:] = q.contiguous().view(torch.uint8).view(o, nb, QK)
    return raw.view(o, nb * Q8_BLOCK_BYTES)
