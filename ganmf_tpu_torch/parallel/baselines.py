"""Row layouts of the factor and similarity baselines (IALS, MF-SGD,
SLIM-BPR) on a mesh, and their one-process counterpart.

Port of the ``mesh_plan`` placements of ganmf_tpu/models/ials.py (:336-396),
mf_sgd.py (:240-255) and slim_bpr.py (:249-262). JAX runs the one-device
program under GSPMD on the sharded arrays; here every rank runs the model's
one epoch body on its shards, and the body reads and writes rows through a
layout:

  * ``Shards`` (a mesh): a chunk's rows are gathered from their owners (a
    masked take, then one sum over the mesh in which each entry has one
    contributor, so the gathered values are exact); every rank computes the
    chunk's update alike, and only the ranks holding a row apply it, with the
    one-card ``index_add_`` and its duplicate-index sums;
  * ``WHOLE`` (one process, no mesh): the same calls as the plain ops,
    ``index_select``, ``index_add_`` and index writes, with no mask and no
    collective.

``RowShard.placed`` gives JAX's placements under the degrade rule of
``MeshPlan.put``; ``RowShard.chunked`` gives the ranges of whole chunks of
JAX's flat-CSR mesh storage (IALS, ``_flat_csr_stacked``).

Nothing here reads the device to the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from ganmf_tpu_torch.parallel import comm
from ganmf_tpu_torch.parallel.mesh import MeshPlan, _names


def _keep(values: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``values`` where ``mask`` (over the leading dimension), zeros
    elsewhere; ``values`` itself without a mask."""
    if mask is None:
        return values
    mask = mask.view(-1, *([1] * (values.dim() - 1)))
    return torch.where(mask, values, torch.zeros((), dtype=values.dtype, device=values.device))


class WholeRows:
    """Every row of a tensor, in one process: ``RowShard``'s calls as the
    plain indexing ops."""

    def read(self, fn, ids: torch.Tensor) -> torch.Tensor:
        return fn(ids)

    def take(self, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return x.index_select(0, ids)

    def take_at(self, x: torch.Tensor, ids: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        return x[ids, cols]

    def add_(self, x: torch.Tensor, ids: torch.Tensor, values: torch.Tensor) -> None:
        x.index_add_(0, ids, values)

    def set_(self, x: torch.Tensor, ids: torch.Tensor, fn) -> torch.Tensor:
        x[ids] = fn(x[ids])
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def slice(self, x: torch.Tensor) -> torch.Tensor:
        return x


class RowShard:
    """This rank's rows [lo, hi) of an n-row tensor split over ``axes``.

    ``sole``: this rank is the one contributor of its rows to a sum over
    the whole mesh (its coordinate is 0 on every axis the rows do not split
    over), so that a masked take summed over the mesh gives each row once.
    ``take``, ``take_at``, ``add_`` and ``set_`` need at least one row, as
    every ``placed`` shard has."""

    def __init__(self, plan: MeshPlan, n: int, lo: int, hi: int, axes, per: Optional[int] = None):
        self.plan, self.n, self.lo, self.hi = plan, n, lo, hi
        self.axes = tuple(_names(axes))
        self.per = hi - lo if per is None else per  # rows a rank's slice is padded to for a gather
        self.sole = all(plan.coords[a] == 0 for a in plan.axis_names if a not in self.axes)

    @classmethod
    def placed(cls, plan: MeshPlan, n: int, spec) -> "RowShard":
        """The rows ``plan.put`` keeps of an n-row tensor placed by ``spec``."""
        axes = plan.effective_spec((n,), spec)[0]
        (lo, hi), = plan.bounds((n,), spec)
        return cls(plan, n, lo, hi, axes)

    @classmethod
    def chunked(cls, plan: MeshPlan, n: int, chunk: int, axes) -> "RowShard":
        """JAX's flat-CSR mesh layout: rows padded to a multiple of chunk * S
        (S the size of ``axes``), each of the S ranges a whole number of
        chunks; the last ranges may hold padding rows only (JAX :162-195)."""
        S = plan.axis_size(axes)
        per = -(-max(n, 1) // (chunk * S)) * chunk
        lo = min(plan.axis_index(axes) * per, n)
        return cls(plan, n, lo, min(lo + per, n), axes if S > 1 else (), per)

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    def owned(self, ids: torch.Tensor):
        """(each id's local row, clamped into range; whether this rank is its
        sole contributor)."""
        local = (ids - self.lo).clamp(0, max(self.rows - 1, 0))
        return local, (ids >= self.lo) & (ids < self.hi) & self.sole

    def read(self, fn, ids: torch.Tensor) -> torch.Tensor:
        """``fn`` of the ids' local rows (a tensor over the ids), where this
        rank is their sole contributor; zeros elsewhere."""
        local, own = self.owned(ids)
        return _keep(fn(local), own)

    def take(self, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of this rank's slice ``x`` where it is their sole
        contributor, zeros elsewhere (summed over the mesh: the rows)."""
        return self.read(lambda at: x.index_select(0, at), ids)

    def take_at(self, x: torch.Tensor, ids: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """x[ids, cols] of this rank's slice ``x`` where it is the rows' sole
        contributor, zeros elsewhere (a column held elsewhere may pass this
        rank's width: it is clamped, and masked)."""
        return self.read(lambda at: x[at, cols.clamp(max=x.shape[1] - 1)], ids)

    def add_(self, x: torch.Tensor, ids: torch.Tensor, values: torch.Tensor) -> None:
        """``x.index_add_`` of the rows this rank holds (every replica of a
        row takes it); the others add zeros to a row in range."""
        local = (ids - self.lo).clamp(0, self.rows - 1)
        x.index_add_(0, local, _keep(values, (ids >= self.lo) & (ids < self.hi)))

    def set_(self, x: torch.Tensor, ids: torch.Tensor, fn) -> torch.Tensor:
        """``x[ids] = fn(x[ids])`` on the rows this rank holds, in the one-card
        order (a later duplicate overwrites an earlier one): the ids this rank
        does not hold write a spare slot. Returns the new ``x``."""
        held = (ids >= self.lo) & (ids < self.hi)
        ext = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        slot = torch.where(held, ids - self.lo, self.rows)
        ext[slot] = fn(ext[slot])
        return ext[: self.rows]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The n full rows from every rank's slice ``x`` (a collective over
        ``axes``)."""
        if not self.axes or self.plan.group(self.axes) is None:
            return x
        if x.shape[0] < self.per:
            x = torch.cat([x, x.new_zeros((self.per - x.shape[0],) + x.shape[1:])])
        return comm.all_gather(x, self.plan, self.axes)[: self.n]

    def slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the full ``x``."""
        return x[self.lo : self.hi]


class Whole:
    """The one-process layout of an MF-SGD or SLIM-BPR fit: every user and
    item row, the whole URM; no collective."""

    users = items = WholeRows()

    def psum(self, parts):
        return list(parts)

    def local_csr(self, urm):
        """(this rank's rows of the CSR ``urm``, its [users, items] block)."""
        return urm, urm

    def urm_values(self, urm: torch.Tensor, users: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        return urm[users[:, None], cols]

    def urm_rows(self, urm: torch.Tensor, users: torch.Tensor) -> torch.Tensor:
        return urm.index_select(0, users)

    def columns(self, W: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """[C, I]: the columns W[:, ids], transposed."""
        return W.index_select(1, ids).T

    def shard(self, state, rows):
        """This rank's shards of a full ``state`` (a NamedTuple), each field
        by ``rows``: "users", "items" or None (replicated)."""
        return state

    def gather(self, state, rows):
        """The full state from this rank's shards (a collective on a mesh)."""
        return state


WHOLE = Whole()


class Shards(Whole):
    """Where a rank's part of a sharded MF-SGD or SLIM-BPR fit lies: its user
    rows, its item rows, and its [users, items] block of the URM."""

    def __init__(self, plan: MeshPlan, n_users: int, n_items: int):
        urm_axes = plan.effective_spec((n_users, n_items), plan.urm)
        (u0, u1), (i0, i1) = plan.bounds((n_users, n_items), plan.urm)
        both = tuple(urm_axes[0]) + tuple(urm_axes[1])
        self.plan = plan
        self.users = RowShard.placed(plan, n_users, plan.user_rows)
        self.items = RowShard.placed(plan, n_items, plan.item_rows)
        # the URM's rows and columns, sole over both of its axes
        self.urm_users = RowShard(plan, n_users, u0, u1, both)
        self.urm_items = RowShard(plan, n_items, i0, i1, both)

    def psum(self, parts):
        """``parts`` (one dtype) each summed over the whole mesh, in one
        collective."""
        return comm.psum_many(parts, self.plan, self.plan.axis_names) if parts else []

    def local_csr(self, urm):
        return (urm[self.users.lo : self.users.hi],
                urm[self.urm_users.lo : self.urm_users.hi][:, self.urm_items.lo : self.urm_items.hi])

    def urm_values(self, urm: torch.Tensor, users: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """[n, c] entries urm[users, cols] of the global URM from this rank's
        block ``urm``, where this rank is their sole contributor (zeros
        elsewhere; summed over the mesh: the entries)."""
        lu, hu = self.urm_users.owned(users)
        lc, hc = self.urm_items.owned(cols)
        return torch.where(hu[:, None] & hc, urm[lu[:, None], lc],
                           torch.zeros((), dtype=urm.dtype, device=urm.device))

    def urm_rows(self, urm: torch.Tensor, users: torch.Tensor) -> torch.Tensor:
        """[n, I] whole URM rows of ``users`` where this rank contributes
        them: its block in its columns, zeros elsewhere."""
        out = torch.zeros((len(users), self.urm_items.n), dtype=urm.dtype, device=urm.device)
        out[:, self.urm_items.lo : self.urm_items.hi] = self.urm_users.take(urm, users)
        return out

    def columns(self, W: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """[C, I]: this rank's rows of the columns W[:, ids], transposed, in
        its item range (the sole contributor's; zeros elsewhere)."""
        out = torch.zeros((len(ids), self.items.n), dtype=W.dtype, device=W.device)
        if self.items.sole:
            out[:, self.items.lo : self.items.hi] = W.index_select(1, ids).T
        return out

    def shard(self, state, rows):
        return type(state)(*((t if r is None else getattr(self, r).slice(t)).contiguous().to(self.plan.device)
                             for t, r in zip(state, rows)))

    def gather(self, state, rows):
        return type(state)(*(t if r is None else getattr(self, r).gather(t) for t, r in zip(state, rows)))
