"""Attention over the KV cache: K2 (length-aware decode attention over the
dense cache), K7 (flash attention of a prefill window over the dense
cache), K4 and K8 (K2's function over the int8 cache) and the plain einsum
math.

`flash_attention` is K2 for windows of t <= 32 query rows (decode steps
and prefill buckets of 16 and 32). It replaces
llamago_tpu/ops/attention.py `_attn_decode_kernel`; the CUDA kernel is
`csrc/attn_decode.cu`, whose header note says what bounds it on the card
(the visible cache bytes) and how its design answers that: a bf16 cache
takes its bf16 tensor-core form, an f32 cache its f32 tensor-core form in
three TF32 products (`k2_form`; the splits planned by `decode_attn_plan`
for the dtype). A CPU tensor
takes `flash_attention_plain`, the TPU kernel's online softmax over
S-blocks written in PyTorch; a CUDA tensor takes the kernel, or the
wrapper raises.

Under grad `flash_attention` goes through `FlashAttention`, the JAX
package's custom VJP: K2 or K7 forward, autograd of `attention_math`
backward.

For longer windows, and for every window when LLAMAGO_ATTN_LENAWARE is
"0", `flash_attention` is K7. It replaces `_attn_kernel`; the CUDA kernel
is `csrc/attn_prefill.cu` (an online softmax over S-tiles that stops at the
last visible slot; the TPU kernel holds the whole S plane on chip, and its
tile budgets are not carried over): a bf16 cache takes its bf16
tensor-core form, an f32 cache its f32 tensor-core form in three TF32
products (`k7_form`; both take the chunks of slots planned by
`prefill_plan`, merged in a second launch). A CPU tensor takes
`flash_attention_prefill_plain`: -inf mask and one softmax over the whole
row, as the TPU kernel computes it.

`can_fuse_attention` is the JAX package's gate under its names, read at
import: LLAMAGO_ATTN_PREFILL_FLOOR (bytes of f32 scores 4*b*kv*g*t*s from
which a window of t > 32 takes K7; 0 sends every prefill to K7),
LLAMAGO_ATTN_DECODE_FLOOR (bytes of cache from which t <= 32 takes a
kernel; default 0) and LLAMAGO_ATTN_LENAWARE (default "1"). Where
LLAMAGO_ATTN_PREFILL_FLOOR is not set, the default depends on the tensor's
device: on the card every window of t > 32 that K7's geometry takes goes
to K7 (it stops at the last visible slot, where the einsum math scores
every slot in f32); on the CPU it is the JAX package's 1024 GiB, so prefill
takes the einsum math there and the CPU parity tests compare like with
like. Where it is set, it rules on both devices.

`flash_attention_quant` is the same over the int8 cache (runtime/
kv_cache.py), for windows of t <= 32 whose S has an S-block of the TPU
kernels (`quant_fits`). `LLAMAGO_ATTN_I8DOT` (default "1", read as the JAX
package reads it) picks K4, which replaces `_attn_decode_kernel_quant_i8dot`
(int8 dot products; plain version `flash_attention_quant_i8dot_plain`), or,
with "0", K8, which replaces `_attn_decode_kernel_quant` (widening; plain
version `flash_attention_quant_plain`). Both are `csrc/attn_decode_quant.cu`:
K4 on the int8 tensor cores for S-blocks of 64 slots or more, on the CUDA
cores below (`k4_form`); K8 on the bf16 tensor cores for bf16 q over an S
that is a multiple of 64, on the CUDA cores for f32 q (`k8_form`);
`quant_plan` plans a call.

`attention_math` is the plain einsum path that the model uses where the
gate says no (by default every window of t > 32 on the CPU, where the JAX
package also leaves attention to the compiler, and on the card a geometry
that K7 does not take); with row scales it is the int8
cache's scale-folded math, which every window of t > 32 over the int8 cache
takes (the JAX package has no quantized K7).

`attention_math_sp` is the same math over a cache whose positions are
split over the mesh's sp ranks (parallel/): partial softmax statistics of
the local rows, combined by one all_reduce(MAX) and two all_reduce(SUM).
The JAX package has no kernel there either.

Cache layout is [B, KV, S, hd] (runtime/kv_cache.py). Causal mask: cache
slot j is visible to a query at absolute position p iff j <= p.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from llamago_tpu_torch.ops import _build
from llamago_tpu_torch.runtime.kv_cache import quantize_kv_rows
from llamago_tpu_torch.utils.timing import H100_SMS

NEG_INF = float("-inf")
MAX_T = 32  # longest window K2 takes; longer windows go to K7 or attention_math
_MAX_G = 8
_HEAD_DIMS = (64, 128)
_SB = 256  # S-block rows of the plain version, as in the TPU kernel
K2_FORMS = ("decode_tc", "decode_f32tc")  # K2's forms, by the C entry point's codes
_K2_TILE = 64  # cache slots per ring stage of K2's decode_tc form
# the int8 cache's forms, by the C entry point's codes: K8 on the CUDA
# cores, K4 on the CUDA cores, K4 on the int8 tensor cores (S-blocks of whole
# 64-slot tiles), K8 on the bf16 tensor cores (bf16 q, S a multiple of 64)
QUANT_FORMS = ("widening", "i8dot", "i8dot_tc", "widening_tc")
_K4_TILE = 64  # cache slots of a K or V tile of the tensor-core forms (kTile)
K7_FORMS = ("prefill_tc", "prefill_f32tc")  # K7's forms, by the C entry point's codes
_K7_TILE, _K7_ROWS = 64, 64  # slots of a K/V tile and query rows of a block (prefill_tc)
# K7's tensor-core form cuts the slots into chunks when its q-tiles give
# fewer than 96 blocks (three in four of an H100's 132 SMs), aiming then at
# about two an SM over the whole cache (a window sees a part of it). On the
# card chunks made the 7B windows of 256 rows (128 q-tiles) slower, the
# merge pass costing more than a second block an SM gained, and those of
# 128 rows faster (`k2_pair.py --kernel k7 --k7-chunks`; PERF.md).
_K7_MIN_BLOCKS, _K7_TARGET_BLOCKS = 96, 2 * H100_SMS
_MASK = -1e9  # finite: -inf - -inf = nan would poison the online stats


# int8-cache decode attention: K4 (int8 dot products) unless "0", K8
_I8DOT = os.environ.get("LLAMAGO_ATTN_I8DOT", "1") == "1"

# The gate's switches (module docstring), as the JAX package reads them. The
# prefill floor is None where the environment sets none: the gate then reads
# the tensor's device, 0 on the card and the JAX package's default on the CPU.
_GB = 1024 * 1024 * 1024
_JAX_PREFILL_SCORES = 1024 * _GB
_MIN_DECODE_TRAFFIC = int(os.environ.get("LLAMAGO_ATTN_DECODE_FLOOR", 0))
_MIN_PREFILL_SCORES = (int(os.environ["LLAMAGO_ATTN_PREFILL_FLOOR"])
                       if "LLAMAGO_ATTN_PREFILL_FLOOR" in os.environ else None)
_LENAWARE = os.environ.get("LLAMAGO_ATTN_LENAWARE", "1") == "1"


def can_fuse_attention(q: torch.Tensor, k_cache: torch.Tensor) -> bool:
    """Whether `flash_attention` (K2 or K7) takes q [B, T, H, hd] over the
    dense cache [B, KV, S, hd], or the window goes to `attention_math`: the
    JAX package's gate. A geometry the CUDA kernels do not take (K2 and K7
    share it) is refused on the card only; the plain versions take any.
    With LLAMAGO_ATTN_PREFILL_FLOOR unset, a window of t > 32 takes K7 on
    the card and the einsum math on the CPU (the JAX package's default)."""
    b, t, h, hd = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    on_card = q.device.type != "cpu"
    if on_card and not (
            q.dtype in (torch.bfloat16, torch.float32) and k_cache.dtype == q.dtype
            and 1 <= g <= _MAX_G and hd in _HEAD_DIMS):
        return False
    if t <= MAX_T:
        return 2 * b * kv * s * hd * k_cache.element_size() >= _MIN_DECODE_TRAFFIC
    floor = _MIN_PREFILL_SCORES
    if floor is None:
        floor = 0 if on_card else _JAX_PREFILL_SCORES
    return 4 * b * kv * g * t * s >= floor


def _tpu_sb(s: int) -> int | None:
    """The TPU kernels' S-block rows: 256, halved until it divides S; None
    when nothing down to 8 divides S."""
    sb = _SB
    while sb > 8 and s % sb:
        sb //= 2
    return sb if s % sb == 0 else None


def _decode_sb(s: int) -> int:
    """S-block rows for K2's plain version: the TPU kernel's block, or S
    itself when the TPU kernel has none."""
    return _tpu_sb(s) or s


def flash_attention_plain(q5: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos0: torch.Tensor) -> torch.Tensor:
    """Plain K2 on q5 [B, t, KV, g, hd]: online softmax in f32 over S-blocks,
    skipping blocks past each row's last visible slot; p is rounded to the
    V dtype before the PV product. Returns q5's shape and dtype."""
    b, t, kv, g, hd = q5.shape
    s = k_cache.shape[2]
    sb = _decode_sb(s)
    n_sb = s // sb
    rows = t * g
    scale = 1.0 / (hd ** 0.5)
    f32 = torch.float32
    dev = q5.device
    q = q5.permute(0, 2, 1, 3, 4).reshape(b, kv, rows, hd).to(f32)
    pos0 = pos0.to(torch.int64)
    last_blk = torch.clamp((pos0 + t - 1) // sb, max=n_sb - 1)  # [B]
    qpos = pos0[:, None] + torch.arange(rows, device=dev)[None, :] // g  # [B, rows]
    acc = torch.zeros((b, kv, rows, hd), dtype=f32, device=dev)
    m = torch.full((b, kv, rows, 1), _MASK, dtype=f32, device=dev)
    l = torch.zeros((b, kv, rows, 1), dtype=f32, device=dev)
    for si in range(int(last_blk.max()) + 1):
        k = k_cache[:, :, si * sb:(si + 1) * sb].to(f32)
        v = v_cache[:, :, si * sb:(si + 1) * sb]
        s_blk = torch.einsum("bkrd,bksd->bkrs", q, k) * scale
        spos = si * sb + torch.arange(sb, device=dev)
        visible = spos[None, None, None, :] <= qpos[:, None, :, None]
        s_blk = torch.where(visible, s_blk, torch.full_like(s_blk, _MASK))
        m_new = torch.maximum(m, s_blk.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s_blk - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bkrs,bksd->bkrd", p.to(v.dtype).to(f32), v.to(f32))
        acc_new = acc * alpha + pv
        upd = (si <= last_blk)[:, None, None, None]
        acc = torch.where(upd, acc_new, acc)
        m = torch.where(upd, m_new, m)
        l = torch.where(upd, l_new, l)
    out = (acc / l).reshape(b, kv, t, g, hd).permute(0, 2, 1, 3, 4)
    return out.to(q5.dtype)


def flash_attention_prefill_plain(q5: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor, pos0: torch.Tensor) -> torch.Tensor:
    """Plain K7 on q5 [B, t, KV, g, hd]: f32 scores times 1/sqrt(hd), -inf
    mask (slot <= pos0 + row // g), one f32 softmax over the whole row,
    probabilities rounded to the V dtype, PV summed in f32. A row that sees
    no slot gives NaN, as in the TPU kernel. Returns q5's shape and dtype."""
    b, t, kv, g, hd = q5.shape
    s = k_cache.shape[2]
    rows = t * g
    f32 = torch.float32
    dev = q5.device
    q = q5.permute(0, 2, 1, 3, 4).reshape(b, kv, rows, hd).to(f32)
    scores = torch.einsum("bkrd,bksd->bkrs", q, k_cache.to(f32)) * (1.0 / (hd ** 0.5))
    qpos = pos0.to(torch.int64)[:, None] + torch.arange(rows, device=dev)[None, :] // g
    visible = torch.arange(s, device=dev)[None, None, :] <= qpos[:, :, None]  # [B, rows, S]
    scores = scores.masked_fill(~visible[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkrs,bksd->bkrd", probs.to(f32), v_cache.to(f32))
    return out.reshape(b, kv, t, g, hd).permute(0, 2, 1, 3, 4).to(q5.dtype)


@functools.cache
def _lib():
    fn = _build.library("attn_decode").llamago_attn_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _prefill_lib():
    fn = _build.library("attn_prefill").llamago_attn_prefill
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_cuda_args(q5, k_cache, v_cache, pos0, max_t: int | None = MAX_T) -> None:
    """What K2 (t <= 32) and K7 (`max_t` None: any t) take."""
    b, t, kv, g, hd = q5.shape
    if t < 1 or (max_t is not None and t > max_t) or g > _MAX_G or hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: t={t} (1 to {max_t or 'any'}), g={g} "
                         f"(<= {_MAX_G}), hd={hd} (in {_HEAD_DIMS}) not supported")
    if k_cache.shape != v_cache.shape or k_cache.shape[:2] != (b, kv) \
            or k_cache.shape[3] != hd:
        raise ValueError(f"flash_attention: cache {tuple(k_cache.shape)} does not "
                         f"match q {tuple(q5.shape)}")
    if q5.dtype not in (torch.bfloat16, torch.float32) \
            or k_cache.dtype != q5.dtype or v_cache.dtype != q5.dtype:
        raise ValueError(f"flash_attention: dtypes q {q5.dtype}, k {k_cache.dtype}, "
                         f"v {v_cache.dtype} not supported")
    if pos0.dtype != torch.int32 or pos0.shape != (b,):
        raise ValueError("flash_attention: pos0 must be int32 [B]")
    for name, x in (("q", q5), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos0", pos0)):
        if x.device != q5.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, q on {q5.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and "
                             "16-byte aligned")


def k2_form(dtype: torch.dtype) -> str:
    """K2's kernel on the card for a cache of this dtype: "decode_tc" (bf16
    mma.sync) for bf16, "decode_f32tc" (tf32 mma.sync, each f32 product as
    three TF32 products) for f32, which the bf16 tensor cores cannot take
    without rounding it. Both merge their splits, where the plan has more
    than one, in a second launch."""
    return "decode_tc" if dtype == torch.bfloat16 else "decode_f32tc"


def decode_attn_plan(b: int, kv: int, t: int, g: int, hd: int, s: int,
                     dtype: torch.dtype = torch.bfloat16) -> tuple[int, int, int]:
    """(slots per split, splits, f32 workspace elements) of K2's tensor-core
    form for a cache of this dtype over S slots. A split is a run of whole
    64-slot tiles (two of the f32 form's 32-slot tiles); the C side takes
    the first two numbers as they are.

    bf16: the split is the shortest that keeps a split's f32 partials (rows
    x hd x 4 bytes) within a quarter of the cache bytes it reads when full
    (2 x slots x hd x 2): one tile up to 16 rows (every decode step), so
    that the serving fills give every SM a block and a full cache many;
    longer splits measured slower on the card (PERF.md). f32: as many
    splits as give each of the card's SMs a block, no more (one split at b
    = 4, KV = 32): a split's fixed costs weigh more there, and one split a
    (batch, kv head) measured fastest at the serving fill and up to 1.7x
    faster than 64-slot splits at full fill (PERF.md). The workspace holds
    each split's
    partials, row maxima and sums for the merge pass when there is more
    than one split."""
    rows = t * g
    tiles = -(-s // _K2_TILE)
    if dtype == torch.float32:
        blocks = b * kv * -(-rows // _K2_TILE)  # the kernel's blocks a split
        per = -(-tiles // max(1, min(tiles, H100_SMS // blocks)))
    else:
        per = min(tiles, -(-4 * rows // _K2_TILE))
    sps = per * _K2_TILE
    n_split = -(-s // sps)
    return sps, n_split, b * kv * n_split * rows * (hd + 2) if n_split > 1 else 0


def k2_plan(dtype: torch.dtype, b: int, kv: int, t: int, g: int, hd: int,
            s: int) -> tuple[str, int, int, int]:
    """(form, slots per split, splits, f32 workspace elements) of one K2
    call: both forms split as `decode_attn_plan` plans for the dtype."""
    return (k2_form(dtype), *decode_attn_plan(b, kv, t, g, hd, s, dtype))


def _flash_attention_cuda(q5, k_cache, v_cache, pos0) -> tuple[torch.Tensor, str]:
    b, t, kv, g, hd = q5.shape
    s = k_cache.shape[2]
    form, sps, n_split, ws_elems = k2_plan(q5.dtype, b, kv, t, g, hd, s)
    dev = q5.device
    out = torch.empty_like(q5)
    ws = torch.empty(ws_elems, dtype=torch.float32, device=dev) if ws_elems else None
    err = _lib()(q5.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos0.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 b, t, kv, g, hd, s, 1.0 / (hd ** 0.5), K2_FORMS.index(form), sps,
                 n_split, _stream(q5))
    _build.check(err, "flash_attention")
    return out, form


def k7_form(dtype: torch.dtype) -> str:
    """K7's kernel on the card for a cache of this dtype: "prefill_tc" (bf16
    mma.sync) for bf16, "prefill_f32tc" (tf32 mma.sync, each f32 product as
    three TF32 products) for f32, which the bf16 tensor cores cannot take
    without rounding it. Both stream K/V tiles by the TMA unit and take the
    chunks of `prefill_plan`."""
    return "prefill_tc" if dtype == torch.bfloat16 else "prefill_f32tc"


def k7_chunk(b: int, kv: int, t: int, g: int, s: int) -> int:
    """Slots per chunk of K7's tensor-core form, a multiple of 64: the whole
    cache when the q-tiles of 64 rows give `_K7_MIN_BLOCKS` blocks or more;
    else chunks of equal length, as many as bring the blocks over the whole
    cache to about two an SM (a window's blocks past its visible end return
    at once), none shorter than a tile. A function of the shapes only: pos0
    stays on the device."""
    tiles = -(-s // _K7_TILE)
    blocks = b * kv * -(-t * g // _K7_ROWS)
    if blocks >= _K7_MIN_BLOCKS:
        return tiles * _K7_TILE
    chunks = min(tiles, -(-_K7_TARGET_BLOCKS // blocks))
    return -(-tiles // chunks) * _K7_TILE


def prefill_plan(dtype: torch.dtype, b: int, kv: int, t: int, g: int, hd: int,
                 s: int) -> tuple[str, int, int, int]:
    """(form, slots per chunk, chunks, f32 workspace elements) of one K7
    call; the C side takes the middle two as they are. Both forms take
    `k7_chunk`'s chunks (their blocks hold 64 query rows). With more than
    one chunk the workspace holds each chunk's partials (t * g rows of hd
    values, a maximum and a sum each) for the merge pass."""
    form = k7_form(dtype)
    cps = k7_chunk(b, kv, t, g, s)
    chunks = -(-s // cps)
    return form, cps, chunks, b * kv * chunks * t * g * (hd + 2) if chunks > 1 else 0


def _flash_attention_prefill_cuda(q5, k_cache, v_cache, pos0) -> tuple[torch.Tensor, str]:
    b, t, kv, g, hd = q5.shape
    s = k_cache.shape[2]
    form, cps, chunks, ws_elems = prefill_plan(q5.dtype, b, kv, t, g, hd, s)
    out = torch.empty_like(q5)
    ws = torch.empty(ws_elems, dtype=torch.float32, device=q5.device) if ws_elems else None
    err = _prefill_lib()(q5.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                         pos0.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
                         b, t, kv, g, hd, s, 1.0 / (hd ** 0.5), K7_FORMS.index(form), cps,
                         chunks, _stream(q5))
    _build.check(err, "flash_attention (prefill)")
    return out, form


def flash_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Causal attention of the new queries q [B, t, H, hd] (roped) against
    the cache [B, KV, S, hd]; positions [B, t] absolute and contiguous (row
    0's position is what the kernels read). K2 for t <= 32 unless
    LLAMAGO_ATTN_LENAWARE is "0", else K7; each counts its launches
    (`launches`, `launches_prefill`), and its form's (`k2_form`, `k7_form`):
    `launches_decode_tc` and `launches_prefill_tc` the bf16 forms,
    `launches_decode_f32tc` and `launches_prefill_f32tc` the f32 forms.
    Where grad is enabled and q, k or v requires it, the call goes
    through `FlashAttention`, whose backward is that of `attention_math`.
    Returns [B, t, H*hd] in q.dtype."""
    if torch.is_grad_enabled() and (q.requires_grad or k_cache.requires_grad
                                    or v_cache.requires_grad):
        return FlashAttention.apply(q, k_cache, v_cache, positions)
    b, t, h, hd = q.shape
    kv = k_cache.shape[1]
    q5 = q.reshape(b, t, kv, h // kv, hd)
    pos0 = positions[:, 0].to(torch.int32)
    lenaware = _LENAWARE and t <= MAX_T
    if q.device.type == "cpu":
        plain = flash_attention_plain if lenaware else flash_attention_prefill_plain
        out = plain(q5, k_cache, v_cache, pos0)
    elif q.device.type == "cuda":
        q5 = q5.contiguous()
        pos0 = pos0.contiguous()
        if lenaware:
            _check_cuda_args(q5, k_cache, v_cache, pos0)
            out, form = _flash_attention_cuda(q5, k_cache, v_cache, pos0)
            flash_attention.launches += 1
            if form == "decode_tc":
                flash_attention.launches_decode_tc += 1
            elif form == "decode_f32tc":
                flash_attention.launches_decode_f32tc += 1
        else:
            _check_cuda_args(q5, k_cache, v_cache, pos0, max_t=None)
            out, form = _flash_attention_prefill_cuda(q5, k_cache, v_cache, pos0)
            flash_attention.launches_prefill += 1
            if form == "prefill_tc":
                flash_attention.launches_prefill_tc += 1
            elif form == "prefill_f32tc":
                flash_attention.launches_prefill_f32tc += 1
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return out.reshape(b, t, h * hd)


flash_attention.launches = 0  # K2, either form
flash_attention.launches_decode_tc = 0  # K2's bf16 tensor-core form
flash_attention.launches_decode_f32tc = 0  # K2's f32 tensor-core form (3xTF32)
flash_attention.launches_prefill = 0  # K7, either form
flash_attention.launches_prefill_tc = 0  # K7's bf16 tensor-core form
flash_attention.launches_prefill_f32tc = 0  # K7's f32 tensor-core form (3xTF32)


class FlashAttention(torch.autograd.Function):
    """`flash_attention` for training: the JAX package's custom VJP
    (`_flash_fwd` / `_flash_bwd`). The forward is `flash_attention` itself,
    K2 or K7 (their plain versions on the CPU), which Function.apply runs
    with grad off; the backward is autograd of `attention_math` on the
    saved q, k and v, as JAX differentiates it, in plain PyTorch (JAX has
    no backward kernel either). `positions` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k_cache, v_cache, positions):
        ctx.save_for_backward(q, k_cache, v_cache, positions)
        return flash_attention(q, k_cache, v_cache, positions)  # grad is off here

    @staticmethod
    def backward(ctx, g):
        q, k_cache, v_cache, positions = ctx.saved_tensors
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(need)
                   for a, need in zip((q, k_cache, v_cache), ctx.needs_input_grad)]
            out = attention_math(*ins, positions)
            want = [a for a in ins if a.requires_grad]
            grads = iter(torch.autograd.grad(out, want, g))
        return (*(next(grads) if a.requires_grad else None for a in ins), None)


def quant_fits(t: int, s: int) -> bool:
    """Whether K4/K8 take a window of t query rows over a cache of S slots:
    t <= 32 (and LLAMAGO_ATTN_LENAWARE not "0") and S has an S-block of the
    TPU kernels (their arithmetic depends on it). The JAX package routes the
    same shapes to its kernels."""
    return _LENAWARE and t <= MAX_T and _tpu_sb(s) is not None


def quant_takes(q: torch.Tensor, k_cache: torch.Tensor) -> bool:
    """Whether `flash_attention_quant` (K4 or K8) takes q [B, t, H, hd] over
    the int8 cache [B, KV, S, hd]: `quant_fits`, and on the card a geometry
    the CUDA kernels take (as `can_fuse_attention` refuses one for the dense
    cache); the plain versions take any. Elsewhere the window takes the
    scale-folded `attention_math`."""
    b, t, h, hd = q.shape
    if q.device.type != "cpu" and not (
            q.dtype in (torch.bfloat16, torch.float32)
            and 1 <= h // k_cache.shape[1] <= _MAX_G and hd in _HEAD_DIMS):
        return False
    return quant_fits(t, k_cache.shape[2])


def _quant_plain(q5, k8, v8, pos0, ks, vs, i8dot: bool) -> torch.Tensor:
    """The TPU kernels' online softmax over S-blocks on the int8 cache, in
    PyTorch (see flash_attention_quant_i8dot_plain / _plain). The int8
    products run as f32 einsums: int8 products summed over hd (<= 1024) or
    S-block (<= 256) terms stay below 2**24, so they are exact in any order,
    as the int32 dots are (PyTorch has no int8 matmul on the card)."""
    b, t, kv, g, hd = q5.shape
    s = k8.shape[2]
    sb = _tpu_sb(s)
    if sb is None:
        raise ValueError(f"flash_attention_quant: S={s} has no S-block of the "
                         "TPU kernels (take attention_math)")
    n_sb = s // sb
    rows = t * g
    scale = 1.0 / (hd ** 0.5)
    f32 = torch.float32
    dev = q5.device
    q = q5.permute(0, 2, 1, 3, 4).reshape(b, kv, rows, hd).to(f32)
    if i8dot:
        q8, sq = quantize_kv_rows(q)  # per (head, row), once
        q, q_scale = q8.to(f32), (scale * sq)[..., None]
    pos0 = pos0.to(torch.int64)
    last_blk = torch.clamp((pos0 + t - 1) // sb, max=n_sb - 1)  # [B]
    qpos = pos0[:, None] + torch.arange(rows, device=dev)[None, :] // g  # [B, rows]
    acc = torch.zeros((b, kv, rows, hd), dtype=f32, device=dev)
    m = torch.full((b, kv, rows, 1), _MASK, dtype=f32, device=dev)
    l = torch.zeros((b, kv, rows, 1), dtype=f32, device=dev)
    for si in range(int(last_blk.max()) + 1):
        blk = slice(si * sb, (si + 1) * sb)
        k = k8[:, :, blk].to(f32)
        v = v8[:, :, blk].to(f32)
        sk = ks[:, :, None, blk].to(f32)
        sv = vs[:, :, None, blk].to(f32)
        s_blk = torch.einsum("bkrd,bksd->bkrs", q, k)
        s_blk = (s_blk * q_scale if i8dot else s_blk * scale) * sk
        spos = si * sb + torch.arange(sb, device=dev)
        visible = spos[None, None, None, :] <= qpos[:, None, :, None]
        s_blk = torch.where(visible, s_blk, torch.full_like(s_blk, _MASK))
        m_new = torch.maximum(m, s_blk.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s_blk - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        psv = p * sv
        if i8dot:  # p*sv >= 0: requantized per row against its block maximum
            p8, sp = quantize_kv_rows(psv)
            pv = torch.einsum("bkrs,bksd->bkrd", p8.to(f32), v) * sp[..., None]
        else:  # p*sv rounded to bf16, whatever q's dtype, as in the TPU kernel
            pv = torch.einsum("bkrs,bksd->bkrd", psv.to(torch.bfloat16).to(f32), v)
        acc_new = acc * alpha + pv
        upd = (si <= last_blk)[:, None, None, None]
        acc = torch.where(upd, acc_new, acc)
        m = torch.where(upd, m_new, m)
        l = torch.where(upd, l_new, l)
    out = (acc / l).reshape(b, kv, t, g, hd).permute(0, 2, 1, 3, 4)
    return out.to(q5.dtype)


def flash_attention_quant_i8dot_plain(q5, k8, v8, pos0, ks, vs) -> torch.Tensor:
    """Plain K4 on q5 [B, t, KV, g, hd] over the int8 cache k8 / v8
    [B, KV, S, hd] with row scales ks / vs [B, KV, S]: q quantized per
    (head, row), int8 scores times (scale * sq) * sk, online softmax in f32
    over S-blocks, p*sv requantized to int8 per row and block, int8 PV
    times sp. Returns q5's shape and dtype."""
    return _quant_plain(q5, k8, v8, pos0, ks, vs, i8dot=True)


def flash_attention_quant_plain(q5, k8, v8, pos0, ks, vs) -> torch.Tensor:
    """Plain K8, the widening variant: f32 scores of q with the widened K
    times scale * sk, online softmax in f32 over S-blocks, p*sv rounded to
    bf16 before the PV product with the widened V. Returns q5's shape and
    dtype."""
    return _quant_plain(q5, k8, v8, pos0, ks, vs, i8dot=False)


@functools.cache
def _quant_lib():
    fn = _build.library("attn_decode_quant").llamago_attn_decode_quant
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * 7 + [ctypes.c_float, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def k4_form(s: int) -> str:
    """K4's kernel on the card over a cache of S slots: "i8dot_tc" (int8
    mma.sync, the S-block's 64-slot tiles streamed by the TMA unit) when the
    TPU kernels' S-block holds whole tiles (every S that is a multiple of
    256, so every serving shape), else "i8dot" (CUDA cores), for the
    S-blocks of 8 to 32 slots (S = 520: 8; S = 2000: 16)."""
    sb = _tpu_sb(s)
    return "i8dot_tc" if sb is not None and sb % _K4_TILE == 0 else "i8dot"


def k8_form(dtype: torch.dtype, s: int) -> str:
    """K8's kernel on the card for q of this dtype over a cache of S slots:
    "widening_tc" (bf16 mma.sync on the int8 K and V widened to bf16, the
    64-slot tiles streamed by the TMA unit) for bf16 q when S is a multiple
    of 64 (every serving shape), else "widening" (CUDA cores): f32 q, which
    the bf16 tensor cores cannot take without rounding it, and the S that
    whole tiles do not cover (S = 520, 2000)."""
    return "widening_tc" if dtype == torch.bfloat16 and s % _K4_TILE == 0 else "widening"


def k8_split(t: int, g: int, s: int) -> int:
    """Slots per split of K8's tensor-core form: four 64-slot tiles, or
    more where the split's f32 partials (t * g rows of hd values) would
    exceed about a quarter of the cache bytes it reads when full (2 x slots
    x hd int8): at least 8 slots a row; never more than S. Four tiles up to
    32 rows (every decode step, t = 32 at g = 1). On an H100, at b = 8, KV
    = 32, S = 1024, t = 1, four tiles a split took 8% off a call at full
    fill against two, 15% against one, and were no slower at fills 1 to
    300 (`k2_pair.py --kernel k8 --k8-splits`; PERF.md)."""
    return _K4_TILE * min(s // _K4_TILE, max(4, -(-8 * t * g // _K4_TILE)))


def quant_plan(i8dot: bool, b: int, kv: int, t: int, g: int, hd: int, s: int,
               q_dtype: torch.dtype) -> tuple[str, int, int, int]:
    """(form, slots of an S-block or split, their number, f32 workspace
    elements) of one K4 (`i8dot`) or K8 call: a function of shapes and q's
    dtype only. K4 and K8's CUDA-core form split S into the TPU kernels'
    S-blocks (K4's arithmetic depends on them); K8's tensor-core form into
    `k8_split` slots (the last split may be shorter). Every form merges the
    partials (t * g rows of hd values, a maximum and a sum each) in a
    second launch."""
    sb = _tpu_sb(s)
    if sb is None:
        raise ValueError(f"flash_attention_quant: S={s} has no S-block")
    form = k4_form(s) if i8dot else k8_form(q_dtype, s)
    if form == "widening_tc":
        sb = k8_split(t, g, s)
    nsb = -(-s // sb)
    return form, sb, nsb, b * kv * nsb * t * g * (hd + 2)


def _check_quant_cuda_args(q5, k8, v8, pos0, ks, vs) -> None:
    b, t, kv, g, hd = q5.shape
    if t > MAX_T or g > _MAX_G or hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_quant: t={t} (<= {MAX_T}), g={g} "
                         f"(<= {_MAX_G}), hd={hd} (in {_HEAD_DIMS}) not supported")
    if k8.shape != v8.shape or k8.shape[:2] != (b, kv) or k8.shape[3] != hd:
        raise ValueError(f"flash_attention_quant: cache {tuple(k8.shape)}, "
                         f"{tuple(v8.shape)} does not match q {tuple(q5.shape)}")
    if _tpu_sb(k8.shape[2]) is None:
        raise ValueError(f"flash_attention_quant: S={k8.shape[2]} has no S-block")
    if ks.shape != k8.shape[:3] or vs.shape != ks.shape:
        raise ValueError(f"flash_attention_quant: scales {tuple(ks.shape)}, "
                         f"{tuple(vs.shape)} do not match the cache {tuple(k8.shape)}")
    if q5.dtype not in (torch.bfloat16, torch.float32) or k8.dtype != torch.int8 \
            or v8.dtype != torch.int8 or ks.dtype not in (torch.bfloat16, torch.float32) \
            or vs.dtype != ks.dtype:
        raise ValueError(f"flash_attention_quant: dtypes q {q5.dtype}, cache "
                         f"{k8.dtype}/{v8.dtype}, scales {ks.dtype}/{vs.dtype} "
                         "not supported")
    if pos0.dtype != torch.int32 or pos0.shape != (b,):
        raise ValueError("flash_attention_quant: pos0 must be int32 [B]")
    for name, x in (("q", q5), ("k8", k8), ("v8", v8), ("pos0", pos0), ("ks", ks),
                    ("vs", vs)):
        if x.device != q5.device:
            raise ValueError(f"flash_attention_quant: {name} on {x.device}, q on "
                             f"{q5.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention_quant: {name} must be contiguous "
                             "and 16-byte aligned")


def _flash_attention_quant_cuda(q5, k8, v8, pos0, ks, vs,
                                i8dot: bool) -> tuple[torch.Tensor, str]:
    b, t, kv, g, hd = q5.shape
    s = k8.shape[2]
    form, sb, _, ws_elems = quant_plan(i8dot, b, kv, t, g, hd, s, q5.dtype)
    out = torch.empty_like(q5)
    ws = torch.empty(ws_elems, dtype=torch.float32, device=q5.device)
    err = _quant_lib()(q5.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(),
                       vs.data_ptr(), pos0.data_ptr(), out.data_ptr(), ws.data_ptr(),
                       b, t, kv, g, hd, s, sb, 1.0 / (hd ** 0.5),
                       int(q5.dtype == torch.bfloat16), QUANT_FORMS.index(form),
                       int(ks.dtype == torch.bfloat16), _stream(q5))
    _build.check(err, "flash_attention_quant")
    return out, form


def flash_attention_quant(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                          positions: torch.Tensor, ks: torch.Tensor,
                          vs: torch.Tensor) -> torch.Tensor:
    """Causal attention of t <= 32 new queries q [B, t, H, hd] (roped)
    against the int8 cache k8 / v8 [B, KV, S, hd] with row scales ks / vs
    [B, KV, S] in f32 or bf16; positions [B, t] absolute (row 0's position is what
    the kernel reads). K4 unless LLAMAGO_ATTN_I8DOT is "0", then K8; each
    counts its launches (`launches_i8dot`, `launches_widening`;
    `launches_i8dot_tc` counts K4's tensor-core form, `k4_form`, and
    `launches_widening_tc` K8's, `k8_form`). Returns [B, t, H*hd] in
    q.dtype."""
    b, t, h, hd = q.shape
    kv = k8.shape[1]
    q5 = q.reshape(b, t, kv, h // kv, hd)
    pos0 = positions[:, 0].to(torch.int32)
    i8dot = _I8DOT
    if q.device.type == "cpu":
        plain = flash_attention_quant_i8dot_plain if i8dot else flash_attention_quant_plain
        out = plain(q5, k8, v8, pos0, ks, vs)
    elif q.device.type == "cuda":
        q5 = q5.contiguous()
        pos0 = pos0.contiguous()
        _check_quant_cuda_args(q5, k8, v8, pos0, ks, vs)
        out, form = _flash_attention_quant_cuda(q5, k8, v8, pos0, ks, vs, i8dot)
        if i8dot:
            flash_attention_quant.launches_i8dot += 1
            if form == "i8dot_tc":
                flash_attention_quant.launches_i8dot_tc += 1
        else:
            flash_attention_quant.launches_widening += 1
            if form == "widening_tc":
                flash_attention_quant.launches_widening_tc += 1
    else:
        raise ValueError(f"flash_attention_quant: unsupported device {q.device}")
    return out.reshape(b, t, h * hd)


flash_attention_quant.launches_i8dot = 0  # K4, either form
flash_attention_quant.launches_i8dot_tc = 0  # K4's tensor-core form
flash_attention_quant.launches_widening = 0  # K8, either form
flash_attention_quant.launches_widening_tc = 0  # K8's tensor-core form


def attention_math(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   positions: torch.Tensor, k_scale: torch.Tensor | None = None,
                   v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain attention (reference: llama.go:300-336): f32 scores, -inf
    mask, softmax, probabilities cast to q.dtype before the PV einsum.
    q [B, T, H, hd], caches [B, KV, S, hd], positions [B, T].
    With k_scale / v_scale [B, KV, S] (the int8 cache) the scales fold in
    per cache column, as in the JAX package: scores times k_scale after the
    1/sqrt(hd) scale, probabilities times v_scale before the cast, the int8
    cache widened to q.dtype. Returns [B, T, H*hd] in q.dtype."""
    b, t, h, hd = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, t, kv, g, hd)
    scale = 1.0 / (hd ** 0.5)
    if k_scale is not None:
        k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
    scores = torch.einsum("btkgd,bksd->bkgts", qg.to(acc), k_cache.to(acc)) * scale
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, None, :].to(acc)
    slot = torch.arange(s, device=q.device)
    allowed = slot[None, None, :] <= positions[:, :, None]  # [B, T, S]
    scores = scores.masked_fill(~allowed[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[:, :, None, None, :].to(acc)
    probs = probs.to(q.dtype)
    out = torch.einsum("bkgts,bksd->btkgd", probs.to(acc), v_cache.to(acc))
    return out.reshape(b, t, h * hd).to(q.dtype)


def attention_math_sp(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      positions: torch.Tensor, mesh, k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over a cache whose S dim is split over the mesh's sp axis:
    this rank holds the S_l rows from sp_index * S_l. Masked partial
    softmax statistics over the local rows, then the two-pass flash
    combine over sp, as the JAX package's `attention_math_sp`:

        out = sum_i exp(m_i - M) V_i / sum_i exp(m_i - M) s_i,  M = max_i m_i

    one all_reduce(MAX) for M and two all_reduce(SUM), for the denominator
    and the numerator. A shard that sees no visible slot contributes
    exp(-inf - M) = 0; M is finite since slot 0 is visible to every
    position. With the int8 cache's scales the local scales fold in as in
    `attention_math`. Differentiable as the JAX function is (its lines
    730-760): M is detached (JAX's stop_gradient; the result does not
    depend on it), the two sums pass their gradient to each rank's partial
    as it is (parallel/mesh.py:reduce_from), and q enters through
    `copy_to`, whose backward sums over sp the parts of q's gradient that
    each rank's positions give (the new K/V rows enter the same way before
    their write, models/llama.py).
    q [B, T, H, hd], caches [B, KV, S_l, hd]; returns [B, T, H*hd]."""
    from llamago_tpu_torch.parallel.mesh import all_reduce, copy_to, reduce_from

    b, t, h, hd = q.shape
    kv, s_l = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    acc = torch.promote_types(q.dtype, torch.float32)
    offset = mesh.coord("sp") * s_l
    qg = copy_to(q, mesh, "sp").reshape(b, t, kv, g, hd)
    if k_scale is not None:
        k_cache = k_cache.to(q.dtype)
    scores = torch.einsum("btkgd,bksd->bkgts", qg.to(acc), k_cache.to(acc)) * (1.0 / (hd ** 0.5))
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, None, :].to(acc)
    slot = offset + torch.arange(s_l, device=q.device)
    allowed = slot[None, None, :] <= positions[:, :, None]  # [B, T, S_l]
    scores = scores.masked_fill(~allowed[:, None, None, :, :], NEG_INF)
    m = all_reduce(scores.detach().amax(dim=-1, keepdim=True), mesh, "sp", "max")
    p = torch.exp(scores - m)
    denom = reduce_from(p.sum(dim=-1, keepdim=True), mesh, "sp")
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :].to(acc)
    num = reduce_from(torch.einsum("bkgts,bksd->bkgtd", p, v_cache.to(acc)), mesh, "sp")
    out = num / denom  # [B, KV, G, T, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h * hd).to(q.dtype)
