"""Shared machinery for the adversarial recommenders.

Port of ganmf_tpu/models/gan_base.py: user and item training modes via
transposition, the best-weight snapshot that early stopping drives, the
shared epoch loop with its metrics-logger and checkpointer hooks and crash
resume (:90-96,115-173), the batching helpers ``make_batches`` and
``padded_weights`` (:210-214,226-229), and the saveModel layout
(``param_0..param_n`` in parameter order, plus ``config`` and ``mode``),
which is the JAX package's, so either package reads the other's zips.

Not ported yet, because no ported model calls them: the loss histories
(:98-113, their checkpoint aux and ``_save_loss_plots``) and
``shuffled_padded_perm`` (:216-223). GANMF's epoch is their first caller.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ganmf_tpu_torch.data.device import dense_from_sparse
from ganmf_tpu_torch.models.base import Recommender
from ganmf_tpu_torch.models.early_stopping import EarlyStoppingScheduler


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

        # optional observability and durability hooks (ganmf_tpu_torch.utils)
        self.metrics_logger = None  # utils.logging.MetricsLogger
        self.checkpointer = None  # utils.checkpoint.TrainCheckpointer

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

    # -- shared epoch loop -----------------------------------------------------
    def _checkpoint_state(self):
        """State persisted by the training checkpointer; subclasses extend
        it with their optimizer states."""
        return {"params": self.params.state_dict()}

    def _restore_checkpoint_state(self, state):
        self.params.load_state_dict(state["params"])

    def resume_from_checkpoint(self) -> int:
        """Restore the latest training checkpoint, returning the epoch to
        continue from (1 when no checkpoint exists). Requires
        ``self.checkpointer`` and the model to be mid-fit (state built)."""
        if self.checkpointer is None:
            return 1
        latest = self.checkpointer.latest_epoch()
        if latest is None:
            return 1
        self._restore_checkpoint_state(self.checkpointer.restore(latest, self._checkpoint_state()))
        return latest + 1

    def _run_training_loop(self, epochs, validation_evaluator, validation_set, sample_every,
                           allow_worse, freq, metrics, after, epoch_fn, start_epoch: int = 1):
        """The reference's fit() main loop (GANMF.py:151-244).

        ``epoch_fn(epoch_index)`` runs one full epoch on the device. Returns
        the reference's fit() return value: the last epoch run when early
        stopping stopped the fit, else ``epochs + 1``.
        """
        self._stop_training = False
        early_stop = None
        if validation_evaluator is not None:
            early_stop = EarlyStoppingScheduler(
                self, evaluator=validation_evaluator, allow_worse=allow_worse,
                freq=freq, metrics=metrics, after=after,
            )

        epoch = start_epoch
        while not self._stop_training and epoch < epochs + 1:
            epoch_fn(epoch)

            if self.metrics_logger is not None:
                self.metrics_logger.log_epoch(epoch)
            if self.checkpointer is not None:
                self.checkpointer.maybe_save(epoch, self._checkpoint_state())

            if validation_set is not None and sample_every is not None and epoch % sample_every == 0:
                results, results_string = validation_evaluator.evaluateRecommender(self)
                if self.metrics_logger is not None:
                    self.metrics_logger.log_eval(epoch, results)
                if self.verbose:
                    print(f"Epoch {epoch}:\n{results_string}")

            if early_stop is not None:
                early_stop(epoch)
                if self._stop_training and self.verbose:
                    print("Training stopped, epoch:", epoch)

            epoch += 1

        return epoch - 1 if self._stop_training else epoch

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


def make_batches(n_rows: int, batch_size: int):
    """Static batching plan: number of batches and padded length."""
    n_batches = int(np.ceil(n_rows / batch_size))
    return n_batches, n_batches * batch_size


def padded_weights(n_rows: int, padded: int) -> np.ndarray:
    w = np.zeros(padded, dtype=np.float32)
    w[:n_rows] = 1.0
    return w
