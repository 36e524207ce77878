"""Mesh construction and sharding plans.

Port of ganmf_tpu/parallel/mesh.py onto ``torch.distributed``. A
``MeshPlan`` lays the world's ranks out as JAX lays devices out: a (data,
model) grid, or (slice, data, model) with the slice axis outermost, ranks in
row-major order (rank = (slice * n_data + data) * n_model + model). The
``data`` axis (users) carries the gradient sums, the ``model`` axis (items)
shards the item dimension of the URM, the item embeddings and the
discriminator's item-sized layers; the user dimension shards over
(slice, data).

A plan carries one process group for every set of its axes (the ranks that
share this rank's coordinates on the other axes), this rank's coordinates and
its device. A placement names which slice of a global tensor a rank keeps,
as a JAX PartitionSpec does: one entry per leading dimension, an axis name,
a tuple of them or None. ``put`` keeps JAX's degrade rule: along each
dimension, the longest prefix of its axes whose shard count divides it (a
50-user URM on a 4-way user axis keeps 2 shards; ML-1M's 3706 items divide
over 2 model ranks but not over 4, and then stay whole).

Without an initialized process group ``make_mesh()`` gives a 1 x 1 plan
whose collectives are identities. With one, every axis set has its group,
even an axis of size 1, so a world of one rank still makes real collective
calls.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ganmf_tpu_torch.parallel import comm

SLICE_AXIS = "slice"
DATA_AXIS = "data"
MODEL_AXIS = "model"


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


@dataclass
class MeshPlan:
    """This rank's view of the mesh: the axes, its coordinates, its device
    and the process group of every set of axes."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    groups: Dict[Tuple[str, ...], object] = field(default_factory=dict, repr=False)
    coords: Dict[str, int] = field(init=False)  # this rank's coordinate on each axis

    def __post_init__(self):
        idx = np.unravel_index(self.rank, self.axis_sizes)
        self.coords = {name: int(i) for name, i in zip(self.axis_names, idx)}

    # -- axes and coordinates ---------------------------------------------------
    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def _ordered(self, axes) -> Tuple[str, ...]:
        names = _names(axes)
        unknown = set(names) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh {self.axis_names}")
        return tuple(n for n in self.axis_names if n in names)

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[n] for n in _names(axes)], dtype=np.int64))

    def axis_index(self, axes) -> int:
        """This rank's coordinate on ``axes`` taken together, the first
        axis major (the shard index of a dimension split over them)."""
        idx = 0
        for n in _names(axes):
            idx = idx * self.shape[n] + self.coords[n]
        return idx

    def group(self, axes):
        """The process group over ``axes`` that holds this rank, or None
        where no collective is needed (no process group, or no axes)."""
        key = self._ordered(axes)
        if not key:
            return None
        return self.groups.get(key)

    @property
    def n_slices(self) -> int:
        return self.shape.get(SLICE_AXIS, 1)

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def n_user_shards(self) -> int:
        """Number of shards the user dimension splits into."""
        return self.n_data * self.n_slices

    # -- placements (JAX's NamedShardings, as specs) -------------------------------
    def named(self, *spec) -> tuple:
        return tuple(spec)

    @property
    def user_axes(self):
        """Mesh axes the user dimension shards over: (slice, data) or data."""
        if SLICE_AXIS in self.axis_names:
            return (SLICE_AXIS, DATA_AXIS)
        return DATA_AXIS

    @property
    def replicated(self) -> tuple:
        return ()

    @property
    def urm(self) -> tuple:
        """[U, I] interaction matrix: users x items over (data, model)."""
        return (self.user_axes, MODEL_AXIS)

    @property
    def user_rows(self) -> tuple:
        """[U, ...] user-major tensors (user embeddings) over data."""
        return (self.user_axes,)

    @property
    def item_rows(self) -> tuple:
        """[I, ...] item-major tensors (item embeddings, encoder kernel)."""
        return (MODEL_AXIS,)

    @property
    def item_cols(self) -> tuple:
        """[..., I] item-minor tensors (decoder kernel)."""
        return (None, MODEL_AXIS)

    @property
    def batch(self) -> tuple:
        """[B, ...] per-step user batches over data."""
        return (self.user_axes,)

    def effective_spec(self, shape, spec) -> tuple:
        """``spec`` under the degrade rule for a tensor of ``shape``: each
        dimension keeps the longest prefix of its axes whose shard count
        divides it (none: that dimension is whole on every rank)."""
        out = []
        for dim, axes in enumerate(spec):
            if dim >= len(shape):
                break
            keep, size = [], 1
            for name in _names(axes):
                size *= self.shape[name]
                if shape[dim] % size:
                    break
                keep.append(name)
            out.append(tuple(keep))
        return tuple(out)

    def bounds(self, shape, spec) -> Tuple[Tuple[int, int], ...]:
        """[lo, hi) of this rank's slice along each dimension of a global
        tensor of ``shape`` placed by ``spec``."""
        eff = self.effective_spec(shape, spec)
        out = []
        for dim, n in enumerate(shape):
            axes = eff[dim] if dim < len(eff) else ()
            width = n // self.axis_size(axes)
            lo = self.axis_index(axes) * width
            out.append((lo, lo + width))
        return tuple(out)

    def put(self, x: torch.Tensor, spec) -> torch.Tensor:
        """This rank's slice of the global tensor ``x``, on the plan's
        device (the counterpart of ``jax.device_put`` with the degrade
        rule)."""
        index = tuple(slice(lo, hi) for lo, hi in self.bounds(tuple(x.shape), spec))
        return x[index].contiguous().to(self.device)

    def gather(self, x: torch.Tensor, spec, shape) -> torch.Tensor:
        """The global tensor of ``shape`` from each rank's slice ``x`` of it
        (a collective: every rank of the mesh calls it)."""
        for dim, axes in enumerate(self.effective_spec(tuple(shape), spec)):
            x = comm.all_gather(x, self, axes, tiled_axis=dim)
        return x

    def is_primary(self, shape, spec) -> bool:
        """True on the one rank of each set that holds the same slice: the
        ranks at coordinate 0 on every axis that ``spec`` names but the
        degrade rule dropped (for sums that must count each element once)."""
        eff = self.effective_spec(tuple(shape), spec)
        dropped = set(n for axes in spec[: len(shape)] for n in _names(axes)) - set(
            n for axes in eff for n in axes)
        return all(self.coords[n] == 0 for n in dropped)


def _plan_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", comm.local_rank())


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_slices: int = 1,
              device=None) -> MeshPlan:
    """Build a (data, model) or (slice, data, model) plan over the world's
    ranks. ``n_data`` defaults to every rank on the data axis; the mesh must
    hold every rank (a process has no device to leave unused).

    ``device`` is this rank's device: ``cuda:LOCAL_RANK`` unless the caller
    asks for another (the CPU for gloo ranks); without a card the default
    raises. Every rank calls ``make_mesh`` with the same sizes, as it builds
    the process groups collectively."""
    world = comm.process_count()
    if n_data is None:
        n_data = max(1, world // (n_model * n_slices))
    needed = n_slices * n_data * n_model
    if needed != world:
        raise ValueError(f"mesh {n_slices}x{n_data}x{n_model} needs {needed} ranks, the world has {world}")
    if n_slices > 1:
        names, sizes = (SLICE_AXIS, DATA_AXIS, MODEL_AXIS), (n_slices, n_data, n_model)
    else:
        names, sizes = (DATA_AXIS, MODEL_AXIS), (n_data, n_model)
    plan = MeshPlan(names, sizes, comm.process_index(), _plan_device(device))
    if dist.is_initialized():
        grid = np.arange(world).reshape(sizes)
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(range(len(names)), r):
                # the groups over ``axes``: one for each coordinate of the
                # other axes, members in row-major order of ``axes``
                rest = [a for a in range(len(names)) if a not in axes]
                members = np.transpose(grid, rest + list(axes)).reshape(-1, int(np.prod([sizes[a] for a in axes])))
                mine, _ = dist.new_subgroups_by_enumeration([row.tolist() for row in members])
                plan.groups[tuple(names[a] for a in axes)] = mine
    return plan
