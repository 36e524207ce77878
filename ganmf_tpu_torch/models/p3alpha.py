"""Graph-based random-walk recommenders P3alpha and RP3beta.

Port of ganmf_tpu/models/p3alpha.py. The reference computes
W = (Piu^a)(Pui^a) in 200-column host blocks with a per-row top-K
(GraphBased/P3alphaRecommender.py:52-141); here the walk product is one
float32 product of the dense transition matrices on the device, pruned
row-wise and then column-wise with ``tiled_topk``. The transition matrices'
L1 row normalization is written in scipy (the card's machine has no
scikit-learn): each row divided by the sum of its absolute values, zero rows
left as they are, as ``sklearn.preprocessing.normalize(norm="l1")`` does.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.data.device import dense_from_sparse
from ganmf_tpu_torch.models.base import ItemSimilarityRecommender, check_matrix, row_col_topk
from ganmf_tpu_torch.ops.similarity import csc_from_col_topk
from ganmf_tpu_torch.ops.topk import scatter_col_topk_dense


def l1_normalize_rows(X) -> sps.csr_matrix:
    """float32 CSR of X with each row divided by the sum of its absolute
    values, summed in float64 (sklearn's normalize(norm="l1") on a float32
    CSR matrix); rows that sum to 0 stay as they are."""
    X = sps.csr_matrix(X, dtype=np.float32, copy=True)
    lens = np.diff(X.indptr)
    # a trailing 0 keeps the empty rows' start offsets in bounds
    sums = np.add.reduceat(np.append(np.abs(X.data).astype(np.float64), 0.0), X.indptr[:-1])
    sums = np.where((lens > 0) & (sums != 0), sums, 1.0)
    X.data = (X.data / np.repeat(sums, lens)).astype(np.float32)
    return X


def _walk_topk_pruned(Piu: torch.Tensor, Pui: torch.Tensor, col_scale: torch.Tensor, topk: int,
                      l1_normalize: bool):
    """W = Piu @ Pui with columns scaled (RP3beta's popularity^-beta; ones
    for P3alpha) and a zeroed diagonal, pruned by ``row_col_topk`` with the
    optional L1 row normalization between its passes (JAX :25-47). Returns
    the per-column [I, topk] values and row ids."""
    W = Piu @ Pui  # [I, I]
    W = W * col_scale[None, :]
    W.fill_diagonal_(0.0)
    return row_col_topk(W, topk, l1_normalize)


class _WalkRecommender(ItemSimilarityRecommender):
    def _transitions(self, alpha: float):
        """(Piu, Pui, X_bool) as float32 CSR: the item-to-user and
        user-to-item transition matrices, each to the power alpha, and the
        binary URM^T they come from."""
        Pui = l1_normalize_rows(self.URM_train)
        X_bool = self.URM_train.transpose(copy=True).tocsr()
        X_bool.data = np.ones(X_bool.data.size, np.float32)
        Piu = l1_normalize_rows(X_bool)
        if alpha != 1.0:
            Pui = Pui.power(alpha)
            Piu = Piu.power(alpha)
        return Piu, Pui, X_bool

    def _apply_min_rating(self, min_rating: float, implicit: bool):
        if min_rating > 0:
            self.URM_train.data[self.URM_train.data < min_rating] = 0
            self.URM_train.eliminate_zeros()
            if implicit:
                self.URM_train.data = np.ones(self.URM_train.data.size, dtype=np.float32)
            self._invalidate_device_cache()

    def _walk(self, Piu, Pui, col_scale: np.ndarray, topK, normalize_similarity: bool):
        """Build and prune the walk on the device, then adopt the pruned W:
        dense on the device when it fits (no readback), host CSR otherwise."""
        cv, cix = _walk_topk_pruned(
            dense_from_sparse(sps.csr_matrix(Piu, dtype=np.float32), self.device),
            dense_from_sparse(sps.csr_matrix(Pui, dtype=np.float32), self.device),
            torch.from_numpy(np.asarray(col_scale, dtype=np.float32)).to(self.device),
            topk=min(topK, self.n_items) if topK else self.n_items,
            l1_normalize=bool(normalize_similarity),
        )
        n = self.n_items
        if 4 * n * n <= self._DENSE_W_BYTE_LIMIT:
            self._adopt_device_w(scatter_col_topk_dense(cv, cix))
        else:
            self.W_sparse = check_matrix(csc_from_col_topk(cv, cix, n).tocsr(), "csr")


class P3alphaRecommender(_WalkRecommender):
    RECOMMENDER_NAME = "P3alphaRecommender"

    def fit(self, topK: int = 100, alpha: float = 1.0, min_rating: float = 0, implicit: bool = False,
            normalize_similarity: bool = False):
        self.topK = topK
        self.alpha = alpha
        self.min_rating = min_rating
        self.implicit = implicit
        self.normalize_similarity = normalize_similarity
        self._apply_min_rating(min_rating, implicit)
        Piu, Pui, _ = self._transitions(alpha)
        self._walk(Piu, Pui, np.ones(self.n_items, np.float32), topK, normalize_similarity)


class RP3betaRecommender(_WalkRecommender):
    """RP3beta: P3alpha with the walk matrix's column j divided by item j's
    popularity^beta (reference GraphBased/RP3betaRecommender.py)."""

    RECOMMENDER_NAME = "RP3betaRecommender"

    def fit(self, alpha: float = 1.0, beta: float = 0.6, min_rating: float = 0, topK: int = 100,
            implicit: bool = False, normalize_similarity: bool = True):
        self.alpha = alpha
        self.beta = beta
        self.min_rating = min_rating
        self.topK = topK
        self.implicit = implicit
        self.normalize_similarity = normalize_similarity
        self._apply_min_rating(min_rating, implicit)
        Piu, Pui, X_bool = self._transitions(alpha)
        pop = np.asarray(X_bool.sum(axis=1)).ravel()
        degree = np.zeros(self.n_items, dtype=np.float32)
        nonzero = pop > 0
        degree[nonzero] = np.power(pop[nonzero], -beta)
        # the scaling comes before the top-K selection, as in the reference's
        # block loop
        self._walk(Piu, Pui, degree, topK, normalize_similarity)
