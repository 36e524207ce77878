"""Shared machinery for the adversarial recommenders.

Port of ganmf_tpu/models/gan_base.py:27-88,193-207: user and item training
modes via transposition, the best-weight snapshot that early stopping drives,
and the saveModel layout (``param_0..param_n`` in parameter order, plus
``config`` and ``mode``), which is the JAX package's, so either package reads
the other's zips. The training loop and early stopping (:130-173) come with
the training port.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ganmf_tpu_torch.data.device import dense_from_sparse
from ganmf_tpu_torch.models.base import Recommender


class AdversarialRecommender(Recommender):
    """Base for GAN recommenders whose parameters are one ``nn.Module``."""

    RECOMMENDER_NAME = "AdversarialRecommender"
    SUPPORTS_ITEM_MODE = True

    def __init__(self, URM_train, mode: str = "user", seed: int = 1234, verbose: bool = False,
                 is_experiment: bool = False, *, device: torch.device):
        if self.SUPPORTS_ITEM_MODE and mode not in ("user", "item"):
            raise ValueError(f"Accepted training modes are `user` and `item`. Given was {mode}.")
        # external orientation is always users x items; item mode transposes
        # only the training view
        super().__init__(URM_train, device=device)
        self.mode = mode if self.SUPPORTS_ITEM_MODE else "user"
        self.seed = seed
        self.verbose = verbose
        self.is_experiment = is_experiment
        self.config: Optional[dict] = None

        self.params: Optional[torch.nn.Module] = None  # current parameters
        self.best_params: Optional[torch.nn.Module] = None  # early-stopping snapshot
        self._stop_training = False

    # -- training-orientation helpers ---------------------------------------
    def _train_matrix(self):
        """CSR in training orientation (transposed for item mode)."""
        if self.mode == "item":
            return self.URM_train.T.tocsr()
        return self.URM_train

    def _train_dense(self) -> torch.Tensor:
        return dense_from_sparse(self._train_matrix(), self.device)

    # -- early-stopping snapshot protocol (reference GANMF.py:246-255) -------
    def stop_fit(self):
        self._stop_training = True

    def save_current_model(self):
        self.best_params = copy.deepcopy(self.params)

    def load_model(self):
        if self.best_params is not None:
            self.params = self.best_params
            self._on_params_loaded()

    def _on_params_loaded(self):
        pass

    # -- persistence ----------------------------------------------------------
    def _save_dict(self):
        flat = {}
        if self.params is not None:
            leaves = [p.detach().cpu().numpy() for p in self.params.parameters()]
            flat["_n_leaves"] = np.asarray([len(leaves)])
            for i, leaf in enumerate(leaves):
                flat[f"param_{i}"] = leaf
        if self.config is not None:
            flat["config"] = {k: v for k, v in self.config.items() if _json_safe(v)}
        flat["mode"] = self.mode
        return flat


def _json_safe(v):
    return isinstance(v, (int, float, str, bool, list, tuple, type(None)))
