"""NMF, EASE-R and the predefined-list recommender.

Port of ganmf_tpu/models/extras.py:

- NMF (:29-58): Lee-Seung multiplicative updates for min ||A - W H||_F with
  W, H >= 0, float32 products on the model's device (TF32 off,
  utils/device.py). The initial W and H are uniform draws from a
  ``torch.Generator`` on the device, scaled as in JAX; ``fit`` also takes
  them (``init``), as PureSVD's takes its Omega.
- EASE-R (:62-138): B = -P / diag(P) with a zero diagonal, P = (A^T A +
  lambda I)^-1 from a Cholesky factor and a solve against the identity. With
  ``topK`` each column keeps its k largest nonzeros (exact zeros become -inf
  keys, so negative weights survive) through ``tiled_topk``; the pruned W
  stays on the device when its dense float32 bytes are within
  ``_DENSE_W_BYTE_LIMIT``, and is otherwise assembled as a host CSC, as in
  JAX. Without ``topK`` the dense W stays on the device. With ``topK`` and
  a ``mesh_plan`` whose model axis has more than one rank (JAX :115), the
  build is column-sharded over that axis (``ops.distchol``: the distributed
  Cholesky, each rank ranking its own columns) and W is assembled as a host
  CSC from the gathered candidates; any other plan takes the one-device
  route.
- PredefinedListRecommender (:141-165): serves fixed lists; it has no
  scores, so the base ``score_device`` (and with it ``serve_all`` and the
  evaluator) raises ``NotImplementedError``, as JAX's
  ``_check_scoring_overridden`` does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.models.base import (
    ItemSimilarityRecommender,
    MatrixFactorizationRecommender,
    Recommender,
    check_matrix,
)
from ganmf_tpu_torch.ops.similarity import csc_from_col_topk
from ganmf_tpu_torch.ops.topk import scatter_col_topk_dense, tiled_topk


def nmf_init(A: torch.Tensor, num_factors: int, generator: torch.Generator):
    """(W [n, K], H [K, m]) uniform in [0, 1) times sqrt(mean(A) / K), plus
    1e-4 (JAX :32-36)."""
    n, m = A.shape
    scale = torch.sqrt(torch.mean(A) / num_factors)
    W = torch.rand((n, num_factors), generator=generator, device=A.device) * scale + 1e-4
    H = torch.rand((num_factors, m), generator=generator, device=A.device) * scale + 1e-4
    return W, H


def nmf_multiplicative(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor, n_iter: int):
    """``n_iter`` Lee-Seung updates from (W, H), in JAX's order (:38-44)."""
    for _ in range(n_iter):
        WH_H = (W @ H) @ H.T
        W = W * (A @ H.T) / torch.clamp_min(WH_H, 1e-10)
        WtWH = W.T @ (W @ H)
        H = H * (W.T @ A) / torch.clamp_min(WtWH, 1e-10)
    return W, H


class NMFRecommender(MatrixFactorizationRecommender):
    RECOMMENDER_NAME = "NMFRecommender"

    def fit(self, num_factors: int = 100, l1_ratio: float = 0.5, n_iter: int = 200, random_seed: int = 1234,
            init=None):
        """``l1_ratio`` is taken for the JAX signature's sake and not used, as
        in JAX. ``init`` ((W [U, K], H [K, I]) float32) replaces the draws from
        ``random_seed``."""
        A = self.device_urm().dense
        if init is None:
            gen = torch.Generator(device=self.device).manual_seed(int(random_seed))
            W, H = nmf_init(A, int(num_factors), gen)
        else:
            W, H = (torch.from_numpy(np.array(x, dtype=np.float32)).to(self.device) for x in init)
        W, H = nmf_multiplicative(A, W, H, int(n_iter))
        self.USER_factors, self.ITEM_factors = W, H.T


def ease_r_weights(A: torch.Tensor, l2_norm: float) -> torch.Tensor:
    """B = -P / diag(P) with a zero diagonal, P = (A^T A + lambda I)^-1,
    float32 on A's device (JAX :62-74)."""
    n = A.shape[1]
    eye = torch.eye(n, dtype=torch.float32, device=A.device)
    G = A.T @ A
    G += float(np.float32(l2_norm)) * eye
    P = torch.cholesky_solve(eye, torch.linalg.cholesky(G))
    del G
    B = -P / torch.diagonal(P)[None, :]
    return B.fill_diagonal_(0.0)


def ease_r_weights_topk(A: torch.Tensor, l2_norm: float, k: int):
    """([n, k] values, [n, k] row ids) of each column's k largest nonzero
    weights (JAX :77-88); empty slots hold 0."""
    B = ease_r_weights(A, l2_norm)
    vals, idx = tiled_topk(torch.where(B == 0.0, float("-inf"), B).T, k)  # per column j: its top rows
    return torch.where(torch.isfinite(vals), vals, 0.0), idx


class EASE_R_Recommender(ItemSimilarityRecommender):
    """Embarrassingly Shallow Autoencoder (Steck 2019): B = I - P / diag(P),
    P = (A^T A + lambda I)^-1, zero diagonal (JAX :102-138)."""

    RECOMMENDER_NAME = "EASE_R_Recommender"

    def fit(self, topK: Optional[int] = None, l2_norm: float = 1e3, mesh_plan=None):
        A = self.device_urm().dense
        n = A.shape[1]
        if topK is None:
            self._adopt_device_w(ease_r_weights(A, l2_norm))
            return
        if mesh_plan is not None and mesh_plan.n_model > 1:
            from ganmf_tpu_torch.ops.distchol import ease_r_topk_sharded

            vals, idx = ease_r_topk_sharded(A, l2_norm, min(int(topK), n), mesh_plan)
            self.W_sparse = check_matrix(csc_from_col_topk(vals, idx, n), "csr")
            return
        vals, idx = ease_r_weights_topk(A, l2_norm, min(int(topK), n))
        if 4 * n * n <= self._DENSE_W_BYTE_LIMIT:
            # the pruned W stays on the device: no [n, k] readback
            self._adopt_device_w(scatter_col_topk_dense(vals, idx))
        else:
            self.W_sparse = check_matrix(csc_from_col_topk(vals, idx, n), "csr")


class PredefinedListRecommender(Recommender):
    """Serves externally supplied ranked lists (reference
    Base/PredefinedListRecommender.py:14): row u of
    ``URM_recommendations_items`` holds u's list as its stored values, in
    order."""

    RECOMMENDER_NAME = "PredefinedListRecommender"

    def __init__(self, URM_recommendations_items, *, device: Optional[torch.device] = None):
        rec = check_matrix(URM_recommendations_items, "csr", dtype=np.int32)
        super().__init__(sps.csr_matrix(rec.shape, dtype=np.float32), device=device)
        self.URM_recommendations = rec

    def fit(self):
        pass

    def recommend(self, user_id_array, cutoff=None, **kwargs):
        if np.isscalar(user_id_array):
            users, single = [int(user_id_array)], True
        else:
            users, single = list(user_id_array), False
        out = []
        for u in users:
            start, end = self.URM_recommendations.indptr[u], self.URM_recommendations.indptr[u + 1]
            items = self.URM_recommendations.data[start:end]
            out.append(list(items[:cutoff] if cutoff else items))
        return out[0] if single else out
