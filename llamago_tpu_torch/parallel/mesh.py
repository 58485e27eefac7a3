"""Process grid and collectives of the port's parallel path.

Counterpart of the JAX package's `parallel/mesh.py`. The JAX package
annotates shardings over a device mesh and lets GSPMD insert the
collectives. PyTorch has no partitioner, so here every rank is one OS
process that holds only its local tensors, and the model code calls the
collectives of this module where XLA would have inserted them:

  tp — tensor parallel over heads / FFN / vocab: all_reduce(SUM) of the
       row-parallel partials, all_gather of the vocab-sharded logits
  sp — sequence parallel over KV-cache positions: the attention combines
       its partial softmax statistics with one all_reduce(MAX) and two
       all_reduce(SUM) (ops/attention.py:attention_math_sp)
  dp — data parallel over decode slots: all_gather of the logits rows

World = tp * dp * sp processes. Coordinates follow the JAX grid (dp, sp,
tp) with tp fastest: rank = (dp_i * sp + sp_i) * tp + tp_i.

The collective backend is decided once a mesh is made: NCCL when every
rank's card is a distinct one, gloo otherwise (ranks that share a card, or
the CPU). The ranks compare their devices' UUIDs over the control group (the
gloo world group every mesh carries for host messages) to decide, and the
choice is logged. There is no switch and no retry on the other backend.
Gloo moves host memory: a CUDA tensor that reaches a collective under gloo is
copied to the host and back here, in f32, and every such copy is counted in
`host_copies`.

Training runs the same collectives under autograd through their
differentiable forms (`copy_to`, `reduce_from`, `gather_from`, `tp_slice`,
below), each with Megatron's conjugate in the backward: the loss is whole
on every tp and sp rank, so a gradient is never summed twice.
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

# seconds a collective or the rendezvous may wait for the other ranks
# before it raises (torch.distributed's own default is 30 minutes)
_TIMEOUT_S = 600.0

# this process's device, as initialize_distributed placed it
_RANK_DEVICE: torch.device | None = None

# collectives on CUDA tensors that went through host memory (gloo), and
# every collective's count and host seconds (from the call to its result)
host_copies = 0
collective_calls = 0
collective_s = 0.0


@dataclass
class Mesh:
    """One rank's view of the (dp, sp, tp) grid: its coordinates, its
    device, the collective backend and one process group per axis of size
    above 1 (`groups`). Host messages go over the gloo world group
    (parallel/multihost.py)."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    backend: str = "none"
    groups: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp}

    @property
    def world(self) -> int:
        return self.dp * self.sp * self.tp

    def coord(self, axis: str) -> int:
        """This rank's index along `axis`."""
        dp_i, rest = divmod(self.rank, self.sp * self.tp)
        sp_i, tp_i = divmod(rest, self.tp)
        return {"dp": dp_i, "sp": sp_i, "tp": tp_i}[axis]

    def axis_ranks(self, axis: str) -> list[int]:
        """Global ranks of this rank's group along `axis`, by index."""
        return _axis_groups(self.dp, self.sp, self.tp, axis)[
            _group_index(self, axis)]


def _axis_groups(dp: int, sp: int, tp: int, axis: str) -> list[list[int]]:
    """Every group of ranks along `axis`, in a fixed order (each group's
    ranks by their index along the axis)."""
    def rank(d, s, t):
        return (d * sp + s) * tp + t

    if axis == "tp":
        return [[rank(d, s, t) for t in range(tp)] for d in range(dp) for s in range(sp)]
    if axis == "sp":
        return [[rank(d, s, t) for s in range(sp)] for d in range(dp) for t in range(tp)]
    return [[rank(d, s, t) for d in range(dp)] for s in range(sp) for t in range(tp)]


def _group_index(mesh: Mesh, axis: str) -> int:
    for i, ranks in enumerate(_axis_groups(mesh.dp, mesh.sp, mesh.tp, axis)):
        if mesh.rank in ranks:
            return i
    raise AssertionError(f"rank {mesh.rank} in no {axis} group")


def check_local_devices(device_type: str, n: int) -> None:
    """Refuse, naming both counts, `n` ranks spawned on this host with one
    card each when fewer cards are visible. The CPU takes any number."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_type != "cpu" and n > have:
        raise ValueError(f"mesh needs {n} devices, have {have}")


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device: str = "cuda") -> torch.device:
    """Join the process group: `tcp://coordinator` as rank `process_id` of
    `num_processes`, or, without a coordinator, the `env://` variables that
    torchrun sets (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK).
    The world group is gloo: it carries the host messages. This process's
    device is `cuda:(LOCAL_RANK or rank, mod the visible cards)`, or the
    CPU for device="cpu". Returns that device."""
    global _RANK_DEVICE
    timeout = datetime.timedelta(seconds=_TIMEOUT_S)
    if coordinator:
        addr = coordinator.removeprefix("tcp://")
        dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method="env://", timeout=timeout)
    rank = dist.get_rank()
    if torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(CLI: --device cpu) to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank)) if not coordinator else rank
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _RANK_DEVICE = dev
    return dev


def _device_id(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    return f"cuda:{uuid}" if uuid is not None else f"cuda:{socket.gethostname()}:{dev.index}"


def make_mesh(tp: int = 1, dp: int = 1, sp: int = 1, devices=None) -> Mesh:
    """This rank's mesh of the (dp, sp, tp) grid over the initialized world
    (which must hold exactly tp * dp * sp processes; a grid of 1 needs no
    process group). `devices[rank]` is each rank's device, and a list may
    name one card more than once; by default each rank keeps the device
    initialize_distributed gave it. Every rank must call this with the same
    arguments: it creates the axis groups, and decides the backend."""
    n = tp * dp * sp
    if devices is not None and n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs initialize_distributed first")
        dev = torch.device(devices[0]) if devices is not None else (
            _RANK_DEVICE or torch.device("cpu"))
        return Mesh(device=dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"mesh of {n} ranks (tp {tp}, dp {dp}, sp {sp}), "
                         f"the world has {world} processes")
    dev = torch.device(devices[rank]) if devices is not None else (
        _RANK_DEVICE or torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ids = [None] * world
    dist.all_gather_object(ids, _device_id(dev))
    distinct = all(i.startswith("cuda:") for i in ids) and len(set(ids)) == world
    backend = "nccl" if distinct else "gloo"
    groups = {}
    for axis, size in (("dp", dp), ("sp", sp), ("tp", tp)):
        if size == 1:
            continue
        for ranks in _axis_groups(dp, sp, tp, axis):
            g = dist.new_group(ranks, backend=backend)  # every rank makes every group
            if rank in ranks:
                groups[axis] = g
    mesh = Mesh(dp=dp, sp=sp, tp=tp, rank=rank, device=dev, backend=backend,
                groups=groups)
    if rank == 0:
        print(f"[mesh] tp={tp} dp={dp} sp={sp}: {backend} collectives "
              f"({'one card a rank' if distinct else 'ranks share a card or the CPU'})",
              file=sys.stderr, flush=True)
    return mesh


# ------------------------------------------------------------ collectives

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _staged(x: torch.Tensor, mesh: Mesh) -> bool:
    """Whether `x` goes through host memory: gloo with a CUDA tensor."""
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor a collective runs on: x itself (contiguous) under NCCL;
    under gloo an f32 host copy where x is on the card or not f32 (gloo
    reduces f32 on the host)."""
    global host_copies
    if mesh.backend != "gloo":
        return x.contiguous()
    if x.device.type == "cuda":
        host_copies += 1
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return x.contiguous()
    return x.to(device="cpu", dtype=torch.float32)


def _back(w: torch.Tensor, x: torch.Tensor, t0: float) -> torch.Tensor:
    """The collective's result `w` in x's device and dtype, and its count
    and host time."""
    global collective_calls, collective_s
    out = w if w.device == x.device and w.dtype == x.dtype else w.to(x.device, x.dtype)
    collective_calls += 1
    collective_s += time.perf_counter() - t0
    return out


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum",
               fresh: bool = False) -> torch.Tensor:
    """x reduced (sum or max) over this rank's `axis` group; x itself where
    the axis has one rank. No gradient (the differentiable forms are
    below). The result may share x's memory (the collective then ran in
    place on x) unless `fresh` asks for a new tensor."""
    group = mesh.groups.get(axis)
    if group is None:
        return x
    t0 = time.perf_counter()
    w = _wire(x, mesh)
    if fresh and w.data_ptr() == x.data_ptr():
        w = w.clone()
    dist.all_reduce(w, op=_OPS[op], group=group)
    return _back(w, x, t0)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """The `axis` group's tensors concatenated along `dim` in the group's
    order; x itself where the axis has one rank. No gradient."""
    group = mesh.groups.get(axis)
    if group is None:
        return x
    t0 = time.perf_counter()
    w = _wire(x, mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, w, group=group)
    return _back(torch.cat(parts, dim=dim), x, t0)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """x of the rank at index `src` of this rank's `axis` group, on every
    rank of the group. No gradient."""
    group = mesh.groups.get(axis)
    if group is None:
        return x
    t0 = time.perf_counter()
    w = _wire(x, mesh)
    dist.broadcast(w, src=mesh.axis_ranks(axis)[src], group=group)
    return _back(w, x, t0)


def _slice(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    n = x.shape[dim] // mesh.shape[axis]
    return x.narrow(dim, mesh.coord(axis) * n, n)


# ---------------------------------------------- differentiable collectives
#
# Training computes the loss whole on every tp and sp rank, so a tensor
# that is the same on every rank of an axis (replicated) carries its whole
# gradient on every rank, and a rank's block carries the gradient of its
# block. Each collective of the forward then has Megatron's conjugate in
# the backward:
#
#   copy_to      forward identity      backward all_reduce(SUM)
#                (a replicated tensor entering per-rank work: each rank's
#                gradient is the part its work sees)
#   reduce_from  forward all_reduce    backward identity
#   gather_from  forward all_gather    backward the rank's slice
#   tp_slice     forward the slice     backward all_gather
#
# torch.distributed.nn.functional.all_reduce's backward all-reduces again,
# which would count a replicated loss once a rank. Each form runs its plain
# collective where no gradient is asked for; its results never share memory
# with its input (autograd may have saved the input).

def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis, fresh=True), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis, fresh=True)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


class _SliceTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _slice(x, mesh, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x, replicated over `axis`, as the input of this rank's share of the
    work: the identity, whose backward sums the ranks' gradients."""
    if mesh is None or axis not in mesh.groups or not _wants_grad(x):
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over `axis` of the ranks' partials x (a row block's product,
    the sp softmax sums), replicated; the backward passes the gradient to
    each partial as it is."""
    if mesh is None or axis not in mesh.groups:
        return x
    if not _wants_grad(x):
        return all_reduce(x, mesh, axis)
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks x concatenated along `dim` (all_gather); the
    backward keeps this rank's slice of the gradient."""
    if mesh is None or axis not in mesh.groups:
        return x
    if not _wants_grad(x):
        return all_gather(x, mesh, axis, dim)
    return _GatherFrom.apply(x, mesh, axis, dim)


def tp_slice(x: torch.Tensor, mesh: Mesh, dim: int = -1) -> torch.Tensor:
    """This rank's contiguous block of x along `dim`, split tp ways; under
    grad the backward all-gathers the ranks' gradient slices."""
    if "tp" in mesh.groups and _wants_grad(x):
        return _SliceTo.apply(x, mesh, "tp", dim)
    return _slice(x, mesh, "tp", dim)
