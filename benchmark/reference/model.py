"""The plain reference: the published block in float32, from the benchmark's
own Q8_0 blocks.

Per layer, over x [tokens, dim]:

  x += wo @ attn(rope(wq h), rope(wk h), wv h),  h = rmsnorm(x) * attention_norm
  x += w2 @ (silu(w1 h) * (w3 h)),              h = rmsnorm(x) * ffn_norm
  logits = output @ (rmsnorm(x) * norm)

RoPE rotates adjacent pairs (x[2i], x[2i+1]) by pos * theta^(-2i/hd), the
convention of a GGUF file's weights (llama.cpp permutes Hugging Face's
q / k rows into it, so the same file gives the same model). Attention is
causal softmax(q k^T / sqrt(hd)) v, query heads grouped over the KV heads.
Where the configuration states an int8 KV cache, each key and value row
(one position of one head, after RoPE for keys) is stored as
round(x / s) clipped to +-127 with s = absmax / 127, and attention reads
q * s: the cache format is part of the model as served.

Everything runs in float32 with TF32 off, one layer at a time: a layer's
matrices are drawn again from the seed (blocks.py) and dequantized, so the
reference takes nothing the program made and never holds more than one
layer. `precision="fp8"` is the control: every matmul's inputs rounded to
float8 e4m3 (activations per row, weights per output row, each scaled to
the format's largest value 448), the product summed in f32.

Imports nothing but torch and this package: no `jax`, no `llamago_tpu`,
nothing of `llamago_tpu_torch`.
"""

from __future__ import annotations

import torch

from benchmark.reference.blocks import dequantize, layer_blocks, norm_gains, table_blocks
from benchmark.reference.dims import Dims

_FP8_MAX = 448.0
_Q_BLOCK = 1024  # query rows per block of attention scores


def exact_matmuls() -> None:
    """float32 matmuls in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 per row (last dim), each row scaled so that its
    absmax maps to 448, and scaled back: the values an fp8 matmul multiplies."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / _FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd] rotated by adjacent pairs at positions pos [T]."""
    t, h, hd = x.shape
    freqs = theta ** (torch.arange(0, hd // 2, dtype=torch.float64, device=x.device)
                      * (-2.0 / hd))
    ang = pos.to(torch.float64)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    xp = x.view(t, h, hd // 2, 2)
    x0, x1 = xp[..., 0], xp[..., 1]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).view(t, h, hd)


def int8_rows(x: torch.Tensor) -> torch.Tensor:
    """The int8 cache's rows of x [..., hd] as read back: round(x/s) * s,
    clipped to +-127, s = absmax/127 per row (1 for an all-zero row)."""
    a = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(a > 0, a / 127.0, torch.ones_like(a))
    return torch.clamp(torch.round(x / s), -127, 127) * s


def _attention(q, k, v, n_kv: int) -> torch.Tensor:
    """Causal attention of one sequence: q [T, H, hd], k / v [T, KV, hd]."""
    t, h, hd = q.shape
    g = h // n_kv
    qg = q.view(t, n_kv, g, hd).permute(1, 2, 0, 3)  # [KV, g, T, hd]
    kt, vt = k.permute(1, 0, 2), v.permute(1, 0, 2)  # [KV, T, hd]
    out = torch.empty_like(qg)
    keys = torch.arange(t, device=q.device)
    for r0 in range(0, t, _Q_BLOCK):
        r1 = min(t, r0 + _Q_BLOCK)
        s = torch.einsum("kgrd,ksd->kgrs", qg[:, :, r0:r1], kt[:, :r1]) / hd ** 0.5
        mask = keys[None, :r1] > torch.arange(r0, r1, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, :, r0:r1] = torch.einsum("kgrs,ksd->kgrd", torch.softmax(s, dim=-1),
                                        vt[:, :r1])
    return out.permute(2, 0, 1, 3).reshape(t, h * hd)


def logits_at(dims: Dims, seed: int, seqs: list[list[int]], rows: list[list[int]],
              device, precision: str = "f32") -> list[torch.Tensor]:
    """Logits [len(rows[i]), vocab] f32 of each sequence `seqs[i]` (token ids,
    position 0 first) at its positions `rows[i]`: the prediction of the token
    after each of them."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision!r}: f32 or fp8")
    exact_matmuls()
    fp8 = precision == "fp8"

    def mm(x, w):
        return (fp8_round(x) if fp8 else x) @ w.T

    def weight(q, s):
        w = dequantize(q, s)
        return fp8_round(w) if fp8 else w

    lens = [len(s) for s in seqs]
    ids = torch.tensor([t for s in seqs for t in s], dtype=torch.long, device=device)
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    q_emb, s_emb = table_blocks(dims, seed, "tok_embeddings", device)
    x = dequantize(q_emb[ids], s_emb[ids])
    del q_emb, s_emb
    gains = norm_gains(dims, seed, device)
    hd, eps = dims.head_dim, dims.norm_eps
    for i in range(dims.n_layers):
        w = {k: weight(*qs) for k, qs in layer_blocks(dims, seed, i, device).items()}
        h = _rms_norm(x, gains["attention_norm"][i], eps)
        q = _rope(mm(h, w["wq"]).view(-1, dims.n_heads, hd), pos, dims.rope_theta)
        k = _rope(mm(h, w["wk"]).view(-1, dims.n_kv_heads, hd), pos, dims.rope_theta)
        v = mm(h, w["wv"]).view(-1, dims.n_kv_heads, hd)
        if dims.kv_cache == "int8":
            k, v = int8_rows(k), int8_rows(v)
        attn = torch.cat([_attention(qs, ks, vs, dims.n_kv_heads) for qs, ks, vs in
                          zip(q.split(lens), k.split(lens), v.split(lens))])
        x = x + mm(attn, w["wo"])
        h = _rms_norm(x, gains["ffn_norm"][i], eps)
        x = x + mm(torch.nn.functional.silu(mm(h, w["w1"])) * mm(h, w["w3"]), w["w2"])
        del w, h, q, k, v, attn
    starts = [0]
    for n in lens[:-1]:
        starts.append(starts[-1] + n)
    pick = torch.tensor([s + r for s, rs in zip(starts, rows) for r in rs],
                        dtype=torch.long, device=device)
    hn = _rms_norm(x[pick], gains["norm"], eps)
    del x
    head = weight(*table_blocks(dims, seed, "output", device))
    logits = mm(hn, head)
    return list(logits.split([len(r) for r in rows]))
