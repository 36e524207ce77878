"""Non-personalized recommenders (reference Base/NonPersonalizedRecommender.py).

Port of ganmf_tpu/models/toppop.py. None of them has factors, so they rank by
the dense route (``score_device`` plus a stable top-k, models/base.py) and
launch no kernel. TopPop and GlobalEffects return one row broadcast over the
block (an ``expand``, no copy): every route masks it out of place. Random
draws its scores on the host from a ``RandomState``, as the JAX package does,
so both packages draw the same scores from one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ganmf_tpu_torch.models.base import Recommender, check_matrix


class TopPop(Recommender):
    """Item-popularity scores (reference NonPersonalizedRecommender.py:14-59)."""

    RECOMMENDER_NAME = "TopPopRecommender"

    def fit(self):
        self.item_pop = np.ediff1d(self.URM_train.tocsc().indptr).astype(np.float32)
        self._pop_device = torch.from_numpy(self.item_pop).to(self.device)

    def score_device(self, user_ids):
        return self._pop_device[None, :].expand(user_ids.shape[0], self.n_items)

    def _save_dict(self):
        return {"item_pop": np.asarray(self.item_pop)}


class Random(Recommender):
    """Uniform random scores (reference NonPersonalizedRecommender.py:152)."""

    RECOMMENDER_NAME = "RandomRecommender"

    def fit(self, random_seed: int = 42):
        self._rng = np.random.RandomState(random_seed)

    def score_device(self, user_ids):
        scores = self._rng.rand(int(user_ids.shape[0]), self.n_items).astype(np.float32)
        return torch.from_numpy(scores).to(self.device)


class GlobalEffects(Recommender):
    """Global + item-bias baseline (reference NonPersonalizedRecommender.py:62-149)."""

    RECOMMENDER_NAME = "GlobalEffectsRecommender"

    def fit(self, lambda_user: float = 10, lambda_item: float = 25):
        self.lambda_user = lambda_user
        self.lambda_item = lambda_item

        urm = check_matrix(self.URM_train, "csc", np.float32)
        self.mu = urm.data.sum(dtype=np.float32) / urm.data.shape[0]
        col_nnz = np.diff(urm.indptr)

        unbiased = urm.copy()
        unbiased.data -= self.mu
        item_bias = np.asarray(unbiased.sum(axis=0)).ravel() / (col_nnz + self.lambda_item)
        self.item_bias = item_bias.astype(np.float32)

        unbiased.data -= np.repeat(self.item_bias, col_nnz)
        unbiased_csr = unbiased.tocsr()
        row_nnz = np.diff(unbiased_csr.indptr)
        self.user_bias = (
            np.asarray(unbiased_csr.sum(axis=1)).ravel() / (row_nnz + self.lambda_user)
        ).astype(np.float32)

        self._bias_device = torch.from_numpy(self.item_bias).to(self.device)

    def score_device(self, user_ids):
        return self._bias_device[None, :].expand(user_ids.shape[0], self.n_items)

    def _save_dict(self):
        return {"item_bias": np.asarray(self.item_bias), "user_bias": np.asarray(self.user_bias)}
