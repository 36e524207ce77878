"""Implicit Alternating Least Squares (Hu/Koren/Volinsky).

Port of ganmf_tpu/models/ials.py. The reference solves the K x K normal
equations one warm user or item at a time with np.linalg.inv
(MatrixFactorization/IALSRecommender.py:137-201). Here each half-epoch runs
its rows in chunks: the confidence-weighted Gram matrices of a chunk come
from one matmul against the outer-product table Z [n_cols, K^2] (A = W @ Z),
and all of the chunk's systems are solved by a batched conjugate-gradient
loop. These are plain float32 products (TF32 off, utils/device.py): the JAX
package computes them outside any Pallas kernel, so they stay torch.matmul
and torch.bmm. Cold rows keep their factors, as the reference's warm-only
updates do.

The CG loop keeps JAX's exit rule: every system of a chunk iterates until
all of them meet ``rtol`` or the cap of K + 16 is reached. The JAX loop
tests that on the device (``lax.while_loop``); here each test is one host
read of a device bool. ``fit`` records each chunk's iterations and reads in
``cg_log``. Rows are not padded to a chunk multiple as in JAX (a zero row
converges at once), but the chunk boundaries, which decide each chunk's
exit, are JAX's.

Storage (``urm_storage``): "dense" holds the [U, I] confidence matrices on
the device; "csr" builds each chunk's confidence block from the padded-CSR
planes, or from flat CSR where the padded planes of an orientation would
pass ``_PAD_PLANE_BYTE_LIMIT`` (the JAX rule: 8 bytes a padded slot, set by
GANMF_TPU_PAD_PLANE_GB).

``fit(mesh_plan=...)`` trains on a mesh of ranks (JAX :336-396), U's rows
over the user axes and V's over the model axis:

  * dense storage takes JAX's placements (``mesh_plan.urm``, ``user_rows``,
    ``item_rows`` under the degrade rule) and keeps this rank's [users,
    items] block of the confidence matrices. Every rank steps through the
    one-process chunks and solves the rows of each that it holds: a chunk's
    Gram and right-hand side are summed over the other orientation's shards
    (a psum over model in the user step, over the user axes in the item
    step), and the CG's exit test is agreed over the whole mesh (a pmax of
    the host-read bool), so that each chunk stops where the one-process
    chunk stops; a rank with no rows in a chunk still joins the test;
  * csr storage (padded or flat) takes JAX's flat mesh layout
    (``_flat_csr_stacked``: rows padded to a multiple of chunk * n_shards,
    each shard a range of whole chunks, ``parallel.baselines.RowShard.
    chunked``) for both forms: each shard runs the one-process half-step on
    its own chunks against the full fixed factors (an all_gather), with no
    collective inside, which gives the one-process fit's values bitwise. A
    chunk split between two ranks would run its products at other shapes,
    whose float32 sums differ (JAX's even padded-csr placement, which splits
    chunks, is not taken for that reason). An orientation of fewer rows than
    chunk * n_shards therefore lies on its first shard, as in JAX's flat
    layout.

``cg_log`` keeps the chunks this rank stepped through; the factor stores and
checkpoints hold the full factors (gathered, a collective every rank calls).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ganmf_tpu_torch.data.device import dense_from_sparse, padded_csr_from_sparse
from ganmf_tpu_torch.models.base import MatrixFactorizationRecommender
from ganmf_tpu_torch.models.early_stopping import IncrementalTrainingEarlyStopping

# Above this padded-plane size (bytes of idx+val for one orientation, at the
# JAX package's 4-byte ids) the csr storage switches from padded-CSR to flat
# CSR: padding is O(rows * max_row_nnz) and explodes on head-heavy
# orientations.
_PAD_PLANE_BYTE_LIMIT = int(float(os.environ.get("GANMF_TPU_PAD_PLANE_GB", "2")) * (1 << 30))


def chunk_rows(num_factors: int, n_cols: int) -> int:
    """Rows a half-step solves at once: the dominant per-chunk block, the
    larger of the [C, K^2] Gram slab and the [C, n_cols] confidence block,
    stays under ~512 MB (JAX :312-320); the two orientations see different
    n_cols."""
    return max(8, min(4096, int(512e6 / (4 * max(num_factors * num_factors, n_cols)))))


def confidence(r: torch.Tensor, scaling: str, alpha: float, epsilon: float):
    """(w, c) of a block of ratings: c = 1 + alpha * r ("linear") or
    1 + alpha * log(1 + r / epsilon) ("log") on the observed entries and 0
    elsewhere, w = c - 1 on the observed entries."""
    obs = (r != 0).to(r.dtype)
    if scaling == "linear":
        conf = (1.0 + alpha * r) * obs
    else:
        conf = (1.0 + alpha * torch.log(1.0 + r / epsilon)) * obs
    return conf - obs, conf


def batched_cg(A: torch.Tensor, b: torch.Tensor, iters: int, rtol: float = 1e-5, agree=None):
    """Solve the batch of SPD K x K systems A x = b by conjugate gradients
    (JAX :235-274). Every system iterates until all of them satisfy
    ||r|| <= rtol * ||b||, or ``iters`` iterations ran. ``agree`` maps the
    device bool "go on" to the one the ranks solving the same systems share.
    Returns (x, iterations, host reads of the exit test)."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r, dim=1)
    tol2 = (rtol * rtol) * torch.sum(b * b, dim=1)  # squared per-system target
    it = reads = 0
    while it < iters:
        reads += 1
        go = torch.any(rs > tol2)
        if not bool(go if agree is None else agree(go)):
            break
        Ap = torch.bmm(A, p.unsqueeze(2)).squeeze(2)
        alpha = rs / torch.clamp(torch.sum(p * Ap, dim=1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = torch.sum(r * r, dim=1)
        p = r + (rs_new / torch.clamp(rs, min=1e-30))[:, None] * p
        rs = rs_new
        it += 1
    return x, it, reads


def als_half_step(block, n_rows: int, Y: torch.Tensor, reg: float, chunk: int, log=None,
                  reduce=None, agree=None, span=None) -> torch.Tensor:
    """Solve (YtY + Yt diag(w_u) Y + reg I) x_u = Yt c_u for every row u
    (JAX :25-60), ``chunk`` rows at a time. ``block(lo, hi)`` gives the rows'
    (w, c) [hi - lo, n_cols]; Y [n_cols, K] holds the fixed factors. Appends
    each chunk's (iterations, host reads) to ``log``. Returns [n_rows, K].

    On a mesh, ``span`` (lo, hi) is this rank's rows of the n_rows (``block``
    takes local rows) and the result is theirs: each chunk solves its rows
    in the span. With ``agree`` (the CG's exit test shared over the mesh)
    every chunk is stepped through, an empty share too; without it the
    chunks outside the span are skipped. With dense storage the columns are
    this rank's shard of the contraction axis: ``reduce`` sums YtY and each
    chunk's [Gram | rhs] over the shards, whose ranks hold the same rows."""
    n_cols, K = Y.shape
    lo_r, hi_r = span or (0, n_rows)
    YtY = Y.T @ Y
    if reduce is not None:
        YtY = reduce(YtY)
    YtY = YtY + reg * torch.eye(K, dtype=Y.dtype, device=Y.device)
    # A_u = Y^T diag(w_u) Y for a chunk is one matmul against the
    # outer-product table Z[i] = y_i y_i^T
    Z = (Y[:, :, None] * Y[:, None, :]).reshape(n_cols, K * K)
    xs = [Y.new_zeros((0, K))]
    for lo in range(0, n_rows, chunk):
        # the chunk's rows in the span, as local rows
        r0, r1 = (min(max(x, lo_r), hi_r) - lo_r for x in (lo, min(lo + chunk, n_rows)))
        if r0 == r1 and agree is None:
            continue
        w, conf = block(r0, r1)
        WZ, b = w @ Z, conf @ Y
        if reduce is not None and r1 > r0:
            WZ, b = (t.contiguous() for t in reduce(torch.cat([WZ, b], dim=1)).split([K * K, K], dim=1))
        A = WZ.reshape(-1, K, K).add_(YtY)
        x, it, reads = batched_cg(A, b, iters=K + 16, agree=agree)
        xs.append(x)
        if log is not None:
            log.append((it, reads))
    return torch.cat(xs)


def _padded_blocks(pc, n_cols, scaling, alpha, epsilon):
    """block(lo, hi) of the padded-CSR planes: the chunk's rows scattered
    into a [C, n_cols + 1] zeros block (JAX :82-92)."""
    def block(lo, hi):
        r = torch.zeros((hi - lo, n_cols + 1), dtype=pc.val.dtype, device=pc.val.device)
        r = r.scatter_add_(1, pc.idx[lo:hi], pc.val[lo:hi])[:, :n_cols]
        return confidence(r, scaling, alpha, epsilon)

    return block


def _flat_blocks(flat, n_cols, scaling, alpha, epsilon):
    """block(lo, hi) of flat CSR (JAX :108-143): the chunk's contiguous
    entries, their local rows found by searchsorted over the chunk's indptr
    window, summed into a [C, n_cols + 1] block by index_add_."""
    indptr_host, indptr, cols, vals = flat

    def block(lo, hi):
        start, end = int(indptr_host[lo]), int(indptr_host[hi])
        pos = torch.arange(start, end, device=vals.device)
        local = torch.searchsorted(indptr[lo : hi + 1], pos, right=True) - 1
        lin = local * (n_cols + 1) + cols[start:end]
        r = torch.zeros((hi - lo) * (n_cols + 1), dtype=vals.dtype, device=vals.device)
        r = r.index_add_(0, lin, vals[start:end]).view(hi - lo, n_cols + 1)[:, :n_cols]
        return confidence(r, scaling, alpha, epsilon)

    return block


def _flat_csr_device(csr, device):
    """(host indptr, device indptr, cols, vals) of a CSR matrix."""
    indptr = csr.indptr.astype(np.int64)
    return (indptr, torch.from_numpy(indptr).to(device),
            torch.from_numpy(csr.indices.astype(np.int64)).to(device),
            torch.from_numpy(csr.data.astype(np.float32)).to(device))


class IALSRecommender(MatrixFactorizationRecommender, IncrementalTrainingEarlyStopping):
    RECOMMENDER_NAME = "IALSRecommender"
    AVAILABLE_CONFIDENCE_SCALING = ["linear", "log"]

    def fit(
        self,
        epochs: int = 300,
        num_factors: int = 20,
        confidence_scaling: str = "linear",
        alpha: float = 1.0,
        epsilon: float = 1.0,
        reg: float = 1e-3,
        init_std: float = 0.1,
        random_seed: int = 1234,
        mesh_plan=None,
        urm_storage: str = "dense",
        **earlystopping_kwargs,
    ):
        if confidence_scaling not in self.AVAILABLE_CONFIDENCE_SCALING:
            raise ValueError(f"confidence_scaling must be one of {self.AVAILABLE_CONFIDENCE_SCALING}")
        if urm_storage not in ("dense", "csr"):
            raise ValueError(f"urm_storage must be 'dense' or 'csr', got {urm_storage!r}")
        if mesh_plan is not None and mesh_plan.device != self.device:
            raise ValueError(f"model on {self.device}, its mesh plan on {mesh_plan.device}")

        self.num_factors = num_factors
        self.alpha = alpha
        self.epsilon = epsilon
        self.reg = reg
        self._scaling = confidence_scaling
        self._storage = urm_storage

        rng = np.random.RandomState(random_seed)
        # reference init: num_factors^-0.5 * U(0,1) (IALSRecommender.py:204-210)
        self.USER_factors = (num_factors ** -0.5 * rng.random_sample((self.n_users, num_factors))).astype(np.float32)
        self.ITEM_factors = (num_factors ** -0.5 * rng.random_sample((self.n_items, num_factors))).astype(np.float32)

        self._chunk_u = chunk_rows(num_factors, self.n_items)
        self._chunk_i = chunk_rows(num_factors, self.n_users)

        args = (confidence_scaling, alpha, epsilon)
        self.mesh_plan = plan = mesh_plan
        agree = None
        if plan is not None:
            from ganmf_tpu_torch.parallel import comm
            from ganmf_tpu_torch.parallel.baselines import RowShard
            from ganmf_tpu_torch.parallel.mesh import MODEL_AXIS

            def over(axes):
                """A sum over ``axes`` (None where no rank shares the sum)."""
                if not axes or plan.group(axes) is None or plan.axis_size(axes) == 1:
                    return None
                return lambda x: comm.psum(x, plan, axes)

            # the CG's exit test, agreed over the whole mesh
            everyone = plan.axis_names if plan.axis_size(plan.axis_names) > 1 else ()
            agree = None if not everyone else (
                lambda go: comm.pmax(go.to(torch.int32), plan, everyone) > 0)
        # per orientation: (form, block, reduce, agree, rows); reduce None:
        # the block's columns are whole and the half-step takes the full
        # fixed factors; rows: this rank's (None without a mesh)
        if urm_storage == "csr":
            # O(nnz) storage per orientation, each chunk's confidence block
            # built on the fly; an orientation whose padded planes would pass
            # the limit takes flat CSR (exactly O(nnz)); on a mesh, this
            # rank's range of whole chunks of either
            def _storage_for(csr, n_cols, chunk, axes):
                lens = np.ediff1d(csr.indptr)
                L = max(int(lens.max()) if csr.shape[0] else 0, 1)
                rows = None if plan is None else RowShard.chunked(plan, csr.shape[0], chunk, axes)
                mine = csr if rows is None else csr[rows.lo : rows.hi]
                if 8 * csr.shape[0] * L > _PAD_PLANE_BYTE_LIMIT:
                    return "flat", _flat_blocks(_flat_csr_device(mine, self.device), n_cols, *args), None, None, rows
                return ("padded", _padded_blocks(padded_csr_from_sparse(mine, self.device), n_cols, *args),
                        None, None, rows)

            axes = (None, None) if plan is None else (plan.user_axes, MODEL_AXIS)
            self._store_users = _storage_for(self.URM_train, self.n_items, self._chunk_u, axes[0])
            self._store_items = _storage_for(self.URM_train.T.tocsr(), self.n_users, self._chunk_i, axes[1])
        else:
            if plan is None:
                W, P = confidence(self.device_urm().dense, *args)
                ru = ri = None
                sums = None, None
            else:
                # this rank's [users, items] block of mesh_plan.urm; the
                # products are summed over the other orientation's shards
                ru = RowShard.placed(plan, self.n_users, plan.user_rows)
                ri = RowShard.placed(plan, self.n_items, plan.item_rows)
                W, P = confidence(dense_from_sparse(self.URM_train[ru.lo : ru.hi][:, ri.lo : ri.hi], self.device),
                                  *args)
                sums = over(ri.axes), over(ru.axes)
            self._store_users = ("dense", lambda lo, hi: (W[lo:hi], P[lo:hi]), sums[0], agree, ru)
            # the item step's rows are W's columns, copied a chunk at a time
            # into the csr blocks' layout, so that both storages run the
            # same products
            self._store_items = ("dense", lambda lo, hi: (W.T[lo:hi].contiguous(), P.T[lo:hi].contiguous()),
                                 sums[1], agree, ri)
        # this rank's users and items (every row without a mesh)
        self._rows_u, self._rows_i = self._store_users[4], self._store_items[4]
        u0, u1 = (0, self.n_users) if plan is None else (self._rows_u.lo, self._rows_u.hi)
        i0, i1 = (0, self.n_items) if plan is None else (self._rows_i.lo, self._rows_i.hi)
        warm_u = np.ediff1d(self.URM_train.indptr)[u0:u1] > 0
        warm_i = np.ediff1d(self.URM_train.tocsc().indptr)[i0:i1] > 0
        self._warm_users = torch.from_numpy(warm_u).to(self.device)
        self._warm_items = torch.from_numpy(warm_i).to(self.device)

        self._U_dev = self._on_device(self.USER_factors[u0:u1])
        self._V_dev = self._on_device(self.ITEM_factors[i0:i1])
        #: per epoch, each chunk's (CG iterations, host reads): the user
        #: step's chunks, then the item step's (on a mesh, this rank's)
        self.cg_log = []

        self._update_best_model()
        self._train_with_early_stopping(epochs, algorithm_name=self.RECOMMENDER_NAME, **earlystopping_kwargs)

        self.USER_factors = self.USER_factors_best
        self.ITEM_factors = self.ITEM_factors_best

    def _full(self, x, rows):
        """The full factor table from this rank's rows (a collective on a
        mesh)."""
        return x if rows is None else rows.gather(x)

    def _half_step(self, store, n_rows, Y, Y_rows, chunk, log):
        _, block, reduce, agree, rows = store
        if reduce is None:
            Y = self._full(Y, Y_rows)  # the csr blocks span every column
        span = None if rows is None else (rows.lo, rows.hi)
        return als_half_step(block, n_rows, Y, self.reg, chunk, log, reduce, agree, span)

    # -- epoch ------------------------------------------------------------------
    def _run_epoch(self, num_epoch):
        log = []
        new_U = self._half_step(self._store_users, self.n_users, self._V_dev, self._rows_i, self._chunk_u, log)
        self._U_dev = torch.where(self._warm_users[:, None], new_U, self._U_dev)
        new_V = self._half_step(self._store_items, self.n_items, self._U_dev, self._rows_u, self._chunk_i, log)
        self._V_dev = torch.where(self._warm_items[:, None], new_V, self._V_dev)
        self.cg_log.append(log)

    # -- crash resume (device factors; the epoch itself is deterministic) ------
    # on a mesh the full factors, gathered, so that a checkpoint resumes on
    # any plan
    def _checkpoint_state(self):
        return {"U": self._full(self._U_dev, self._rows_u), "V": self._full(self._V_dev, self._rows_i)}

    def _restore_checkpoint_state(self, state):
        U, V = state["U"].to(self.device), state["V"].to(self.device)
        self._U_dev = U if self._rows_u is None else self._rows_u.slice(U).contiguous()
        self._V_dev = V if self._rows_i is None else self._rows_i.slice(V).contiguous()

    # the factor stores take the device tensors: no copy per validation (JAX
    # :446-453 copies them to the host); an epoch makes new tensors, so a
    # stored one never changes. On a mesh they take the gathered factors
    def _prepare_model_for_validation(self):
        self.USER_factors = self._full(self._U_dev, self._rows_u)
        self.ITEM_factors = self._full(self._V_dev, self._rows_i)

    def _update_best_model(self):
        self.USER_factors_best = self._full(self._U_dev, self._rows_u)
        self.ITEM_factors_best = self._full(self._V_dev, self._rows_i)
