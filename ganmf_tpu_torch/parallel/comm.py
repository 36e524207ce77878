"""Multi-process runtime initialization and the collective facade.

Port of ganmf_tpu/parallel/comm.py onto ``torch.distributed``. JAX gets its
multi-device program from GSPMD inside one process; the port runs an
explicit SPMD program instead: one process per mesh coordinate, each holding
its shards, joined by the named collectives below. ``initialize`` reads
torch's launcher environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, as ``torchrun`` sets them) or explicit
arguments; with no configuration at all it does nothing, as JAX's does.

The backend is NCCL when the ranks run on the card and gloo on the CPU; a
caller may name gloo for CUDA tensors too (ranks that share one card, which
NCCL refuses). Every collective here is one that NCCL and gloo both take on
CUDA tensors: all_reduce and all_gather (gloo has no reduce_scatter, so
``reduce_scatter`` is an all_reduce and a slice). A process group gets a
``timeout``, so that a rank that dies fails the others instead of hanging
them.

The collectives take the ``MeshPlan`` whose axis groups they run on
(``plan.group(axis)``); on a plan without a process group (``make_mesh()``
in one process) every axis has size 1 and each collective is the identity.
``CopyToAxis`` and ``ReduceFromAxis`` are Megatron's two autograd operators:
forward identity and backward all_reduce, and the reverse.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

#: A collective that waits longer than this fails its process group.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)

_local_rank = 0


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, local_rank: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join a multi-process runtime (a no-op when nothing configures one).

    ``init_method`` defaults to ``tcp://$MASTER_ADDR:$MASTER_PORT``,
    ``world_size``, ``rank`` and ``local_rank`` to ``$WORLD_SIZE``, ``$RANK``
    and ``$LOCAL_RANK``. ``device``: the ranks' device type, the card unless
    it is ``"cpu"``; a rank on the card takes ``cuda:LOCAL_RANK`` and raises
    when there is none. ``backend`` defaults to NCCL on the card and gloo on
    the CPU."""
    global _local_rank
    if dist.is_initialized():
        return
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if init_method is None and world_size is None:
        return  # single-process default
    if init_method is None or world_size is None or rank is None:
        raise ValueError("a multi-process run needs its address, world size and rank "
                         f"(got {init_method!r}, {world_size!r}, {rank!r})")
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        torch.cuda.set_device(local_rank)
    backend = backend or ("nccl" if on_card else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout)
    _local_rank = local_rank


def is_initialized() -> bool:
    return dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    return _local_rank


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# -- named-axis collectives ------------------------------------------------------
# ``axis`` is a mesh axis name or a tuple of them; the collective runs over
# the ranks that share this rank's coordinates on every other axis.

def psum(x: torch.Tensor, plan, axis) -> torch.Tensor:
    group = plan.group(axis)
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def psum_many(parts, plan, axis):
    """Each tensor of ``parts`` (one dtype) summed over ``axis``, in one
    collective: the parts concatenated, summed and split again."""
    if plan.group(axis) is None:
        return list(parts)
    flat = psum(torch.cat([p.reshape(-1) for p in parts]), plan, axis)
    return [f.view_as(p) for f, p in zip(flat.split([p.numel() for p in parts]), parts)]


def pmean(x: torch.Tensor, plan, axis) -> torch.Tensor:
    return psum(x, plan, axis) / plan.axis_size(axis)


def pmax(x: torch.Tensor, plan, axis) -> torch.Tensor:
    group = plan.group(axis)
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather(x: torch.Tensor, plan, axis, *, tiled_axis: int = 0) -> torch.Tensor:
    """The members' ``x`` concatenated along ``tiled_axis`` in the order of
    their coordinates on ``axis`` (every member's ``x`` has one shape)."""
    group = plan.group(axis)
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=tiled_axis)


def reduce_scatter(x: torch.Tensor, plan, axis, *, scatter_axis: int = 0) -> torch.Tensor:
    """This member's slice of the sum over ``axis``, ``x`` cut evenly along
    ``scatter_axis`` in coordinate order: an all_reduce and a slice, since
    gloo has no reduce_scatter."""
    n = plan.axis_size(axis)
    summed = psum(x, plan, axis)
    width = summed.shape[scatter_axis] // n
    return summed.narrow(scatter_axis, plan.axis_index(axis) * width, width).contiguous()


def ppermute_shift(x: torch.Tensor, plan, axis, shift: int = 1) -> torch.Tensor:
    """Ring shift along a mesh axis: member i receives member (i - shift)'s
    ``x`` (an all_gather and a pick, which both backends take)."""
    n = plan.axis_size(axis)
    if n == 1:
        return x
    parts = all_gather(x.unsqueeze(0), plan, axis)
    return parts[(plan.axis_index(axis) - shift) % n]


# -- autograd through collectives --------------------------------------------------

class CopyToAxis(torch.autograd.Function):
    """Forward identity, backward all_reduce over ``group``: the input of a
    column-parallel product, whose gradient each member holds a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ReduceFromAxis(torch.autograd.Function):
    """Forward all_reduce over ``group``, backward identity: the partial
    sums of a row-parallel product, or a loss's partial sums, whose
    gradient every member already holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, plan, axis) -> torch.Tensor:
    group = plan.group(axis)
    return x if group is None else CopyToAxis.apply(x, group)


def reduce_from(x: torch.Tensor, plan, axis) -> torch.Tensor:
    group = plan.group(axis)
    return x if group is None else ReduceFromAxis.apply(x, group)
