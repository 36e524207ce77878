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
GANMF_TPU_PAD_PLANE_GB). ``mesh_plan`` is not ported and raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ganmf_tpu_torch.data.device import padded_csr_from_sparse
from ganmf_tpu_torch.models.base import MatrixFactorizationRecommender
from ganmf_tpu_torch.models.early_stopping import IncrementalTrainingEarlyStopping

# Above this padded-plane size (bytes of idx+val for one orientation, at the
# JAX package's 4-byte ids) the csr storage switches from padded-CSR to flat
# CSR: padding is O(rows * max_row_nnz) and explodes on head-heavy
# orientations.
_PAD_PLANE_BYTE_LIMIT = int(float(os.environ.get("GANMF_TPU_PAD_PLANE_GB", "2")) * (1 << 30))


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


def batched_cg(A: torch.Tensor, b: torch.Tensor, iters: int, rtol: float = 1e-5):
    """Solve the batch of SPD K x K systems A x = b by conjugate gradients
    (JAX :235-274). Every system iterates until all of them satisfy
    ||r|| <= rtol * ||b||, or ``iters`` iterations ran. Returns (x,
    iterations, host reads of the exit test)."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r, dim=1)
    tol2 = (rtol * rtol) * torch.sum(b * b, dim=1)  # squared per-system target
    it = reads = 0
    while it < iters:
        reads += 1
        if not bool(torch.any(rs > tol2)):
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


def als_half_step(block, n_rows: int, Y: torch.Tensor, reg: float, chunk: int, log=None) -> torch.Tensor:
    """Solve (YtY + Yt diag(w_u) Y + reg I) x_u = Yt c_u for every row u
    (JAX :25-60), ``chunk`` rows at a time. ``block(lo, hi)`` gives the rows'
    (w, c) [hi - lo, n_cols]; Y [n_cols, K] holds the fixed factors. Appends
    each chunk's (iterations, host reads) to ``log``. Returns [n_rows, K]."""
    n_cols, K = Y.shape
    YtY = Y.T @ Y + reg * torch.eye(K, dtype=Y.dtype, device=Y.device)
    # A_u = Y^T diag(w_u) Y for a chunk is one matmul against the
    # outer-product table Z[i] = y_i y_i^T
    Z = (Y[:, :, None] * Y[:, None, :]).reshape(n_cols, K * K)
    xs = []
    for lo in range(0, n_rows, chunk):
        w, conf = block(lo, min(lo + chunk, n_rows))
        A = (w @ Z).reshape(-1, K, K).add_(YtY)
        x, it, reads = batched_cg(A, conf @ Y, iters=K + 16)
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
        if mesh_plan is not None:
            raise NotImplementedError("mesh_plan is not ported")

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

        # chunk sized so the dominant per-chunk block, the larger of the
        # [C, K^2] Gram slab and the [C, n_cols] confidence block, stays
        # under ~512 MB; the two orientations see different n_cols
        def _chunk_for(n_cols):
            return max(8, min(4096, int(512e6 / (4 * max(num_factors * num_factors, n_cols)))))

        self._chunk_u = _chunk_for(self.n_items)
        self._chunk_i = _chunk_for(self.n_users)

        args = (confidence_scaling, alpha, epsilon)
        if urm_storage == "csr":
            # O(nnz) storage per orientation, each chunk's confidence block
            # built on the fly; an orientation whose padded planes would pass
            # the limit takes flat CSR (exactly O(nnz))
            def _storage_for(csr, n_cols):
                lens = np.ediff1d(csr.indptr)
                L = max(int(lens.max()) if csr.shape[0] else 0, 1)
                if 8 * csr.shape[0] * L > _PAD_PLANE_BYTE_LIMIT:
                    return "flat", _flat_blocks(_flat_csr_device(csr, self.device), n_cols, *args)
                return "padded", _padded_blocks(padded_csr_from_sparse(csr, self.device), n_cols, *args)

            self._store_users = _storage_for(self.URM_train, self.n_items)
            self._store_items = _storage_for(self.URM_train.T.tocsr(), self.n_users)
        else:
            W, P = confidence(self.device_urm().dense, *args)
            self._store_users = "dense", lambda lo, hi: (W[lo:hi], P[lo:hi])
            # the item step's rows are W's columns, copied a chunk at a time
            # into the csr blocks' layout, so that both storages run the
            # same products
            self._store_items = "dense", lambda lo, hi: (W.T[lo:hi].contiguous(), P.T[lo:hi].contiguous())
        self._warm_users = torch.from_numpy(np.ediff1d(self.URM_train.indptr) > 0).to(self.device)
        self._warm_items = torch.from_numpy(np.ediff1d(self.URM_train.tocsc().indptr) > 0).to(self.device)

        self._U_dev = self._on_device(self.USER_factors)
        self._V_dev = self._on_device(self.ITEM_factors)
        #: per epoch, each chunk's (CG iterations, host reads): the user
        #: step's chunks, then the item step's
        self.cg_log = []

        self._update_best_model()
        self._train_with_early_stopping(epochs, algorithm_name=self.RECOMMENDER_NAME, **earlystopping_kwargs)

        self.USER_factors = self.USER_factors_best
        self.ITEM_factors = self.ITEM_factors_best

    # -- epoch ------------------------------------------------------------------
    def _run_epoch(self, num_epoch):
        log = []
        new_U = als_half_step(self._store_users[1], self.n_users, self._V_dev, self.reg, self._chunk_u, log)
        self._U_dev = torch.where(self._warm_users[:, None], new_U, self._U_dev)
        new_V = als_half_step(self._store_items[1], self.n_items, self._U_dev, self.reg, self._chunk_i, log)
        self._V_dev = torch.where(self._warm_items[:, None], new_V, self._V_dev)
        self.cg_log.append(log)

    # -- crash resume (device factors; the epoch itself is deterministic) ------
    def _checkpoint_state(self):
        return {"U": self._U_dev, "V": self._V_dev}

    def _restore_checkpoint_state(self, state):
        self._U_dev = state["U"].to(self.device)
        self._V_dev = state["V"].to(self.device)

    # the factor stores take the device tensors: no copy per validation (JAX
    # :446-453 copies them to the host); an epoch makes new tensors, so a
    # stored one never changes
    def _prepare_model_for_validation(self):
        self.USER_factors = self._U_dev
        self.ITEM_factors = self._V_dev

    def _update_best_model(self):
        self.USER_factors_best = self._U_dev
        self.ITEM_factors_best = self._V_dev
