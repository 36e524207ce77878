"""KNN collaborative-filtering recommenders.

Port of ganmf_tpu/models/itemknn.py. ItemKNN (reference
KNN/ItemKNNCFRecommender.py:18-54): optional BM25 or TF-IDF reweighting, then
the item-item similarity of ops/similarity.py on the model's device. UserKNN
is the user-side analogue, ItemKNNCBF takes its W from an item-content
matrix, ItemKNNCustomSimilarity scores with a W given to it, and
ItemKNNSimilarityHybrid with alpha * W1 + (1 - alpha) * W2.

A built W whose float32 bytes are within ``_DENSE_W_BYTE_LIMIT`` stays on the
device only (``export="device"``): the host CSR is made when something reads
``W_sparse``. A ``mesh_plan`` among the similarity arguments goes to
``compute_similarity``, whose sharded build exports a host CSR, as in JAX
(:46-61).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ganmf_tpu_torch.models.base import (
    ItemSimilarityRecommender,
    UserSimilarityRecommender,
    check_matrix,
    similarity_matrix_topk,
)
from ganmf_tpu_torch.ops.similarity import compute_similarity
from ganmf_tpu_torch.utils.weighting import TF_IDF, okapi_BM_25

FEATURE_WEIGHTING_VALUES = ["BM25", "TF-IDF", "none"]


def _check_weighting(feature_weighting: str):
    if feature_weighting not in FEATURE_WEIGHTING_VALUES:
        raise ValueError(f"feature_weighting must be one of {FEATURE_WEIGHTING_VALUES}")


def _weighted(mat, feature_weighting: str):
    """``mat`` with BM25 or TF-IDF applied to its rows, or as it is."""
    if feature_weighting == "BM25":
        return check_matrix(okapi_BM_25(mat.astype(np.float32)), "csr")
    if feature_weighting == "TF-IDF":
        return check_matrix(TF_IDF(mat.astype(np.float32)), "csr")
    return mat


def _fit_w(model, data, n: int, topK, shrink, similarity, normalize, similarity_args):
    """The column similarity of ``data`` ([rows, n]) as the model's W: dense
    on the device when it fits, host CSR otherwise, and host CSR with a
    ``mesh_plan`` in ``similarity_args`` (the sharded build's export, JAX
    :46-61)."""
    kw = dict(similarity=similarity, topK=topK, shrink=shrink, normalize=normalize, device=model.device,
              **similarity_args)
    if similarity_args.get("mesh_plan") is None and 4 * n * n <= model._DENSE_W_BYTE_LIMIT:
        model._adopt_device_w(compute_similarity(data, export="device", **kw))
    else:
        model.W_sparse = check_matrix(compute_similarity(data, **kw), "csr")


class ItemKNNCFRecommender(ItemSimilarityRecommender):
    RECOMMENDER_NAME = "ItemKNNCFRecommender"

    def fit(
        self,
        topK: int = 50,
        shrink: float = 100,
        similarity: str = "cosine",
        normalize: bool = True,
        feature_weighting: str = "none",
        **similarity_args,
    ):
        self.topK = topK
        self.shrink = shrink
        _check_weighting(feature_weighting)
        if feature_weighting != "none":
            # the weighted URM is also what the model scores with
            self.URM_train = _weighted(self.URM_train.T, feature_weighting).T.tocsr()
            self._invalidate_device_cache()
        _fit_w(self, self.URM_train, self.n_items, topK, shrink, similarity, normalize, similarity_args)


class UserKNNCFRecommender(UserSimilarityRecommender):
    RECOMMENDER_NAME = "UserKNNCFRecommender"

    def fit(
        self,
        topK: int = 50,
        shrink: float = 100,
        similarity: str = "cosine",
        normalize: bool = True,
        feature_weighting: str = "none",
        **similarity_args,
    ):
        self.topK = topK
        self.shrink = shrink
        _check_weighting(feature_weighting)
        # user-user similarity = column similarity of URM^T
        urm = _weighted(self.URM_train, feature_weighting)
        _fit_w(self, urm.T.tocsr(), self.n_users, topK, shrink, similarity, normalize, similarity_args)


class ItemKNNCBFRecommender(ItemSimilarityRecommender):
    """Content-based item KNN (reference KNN/ItemKNNCBFRecommender.py:17-52):
    W is the column similarity of ICM^T ([n_features, n_items]), with the
    optional weighting applied to the ICM's rows; content enters only
    through W."""

    RECOMMENDER_NAME = "ItemKNNCBFRecommender"

    def __init__(self, ICM, URM_train, *, device: Optional[torch.device] = None):
        super().__init__(URM_train, device=device)
        ICM = check_matrix(ICM, "csr")
        if ICM.shape[0] != self.n_items:
            raise ValueError(f"ICM has {ICM.shape[0]} rows but URM_train has {self.n_items} items")
        self.ICM = ICM.copy()

    def fit(
        self,
        topK: int = 50,
        shrink: float = 100,
        similarity: str = "cosine",
        normalize: bool = True,
        feature_weighting: str = "none",
        **similarity_args,
    ):
        self.topK = topK
        self.shrink = shrink
        _check_weighting(feature_weighting)
        self.ICM = _weighted(self.ICM, feature_weighting)
        _fit_w(self, self.ICM.T.tocsr(), self.n_items, topK, shrink, similarity, normalize, similarity_args)


class ItemKNNCustomSimilarityRecommender(ItemSimilarityRecommender):
    """Scores with an item-item W given to it (reference
    KNN/ItemKNNCustomSimilarityRecommender.py)."""

    RECOMMENDER_NAME = "ItemKNNCustomSimilarityRecommender"

    def fit(self, W_sparse, selectTopK: bool = False, topK: int = 100):
        if selectTopK:
            W_sparse = similarity_matrix_topk(W_sparse, k=topK, device=self.device)
        self.W_sparse = check_matrix(W_sparse, "csr")


class ItemKNNSimilarityHybridRecommender(ItemSimilarityRecommender):
    """alpha * W1 + (1 - alpha) * W2, top-K a column (reference
    KNN/ItemKNNSimilarityHybridRecommender.py)."""

    RECOMMENDER_NAME = "ItemKNNSimilarityHybridRecommender"

    def __init__(self, URM_train, Similarity_1, Similarity_2, *, device: Optional[torch.device] = None):
        super().__init__(URM_train, device=device)
        if Similarity_1.shape != Similarity_2.shape:
            raise ValueError("Similarity matrices have different shapes")
        self.Similarity_1 = check_matrix(Similarity_1.copy(), "csr")
        self.Similarity_2 = check_matrix(Similarity_2.copy(), "csr")

    def fit(self, topK: int = 100, alpha: float = 0.5):
        self.topK = topK
        self.alpha = alpha
        W = self.Similarity_1 * alpha + self.Similarity_2 * (1 - alpha)
        self.W_sparse = check_matrix(similarity_matrix_topk(W, k=topK, device=self.device), "csr")
