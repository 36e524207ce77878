"""Early-stopping utilities.

A copy of ganmf_tpu/models/early_stopping.py, which imports nothing of JAX.

Two mechanisms, mirroring the reference:

* :class:`EarlyStoppingScheduler` — the GAN-side scheduler (Utils_.py:25-88):
  every ``freq`` epochs after ``after``, evaluate; if every tracked metric is
  <= its best value, spend one unit of the ``allow_worse`` budget, otherwise
  snapshot the model weights; on budget exhaustion stop training and restore
  the snapshot. The reference hard-codes the comparison cutoff to 5
  (Utils_.py:64); here it defaults to the evaluator's smallest cutoff and can
  be overridden.

* :func:`train_with_early_stopping` — the template-method trainer used by the
  classical baselines (Base/Incremental_Training_Early_Stopping.py:93-259):
  evaluate every N epochs on a single metric, keep the best model, stop after
  ``lower_validations_allowed`` consecutive non-improvements.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np


class EarlyStoppingScheduler:
    def __init__(
        self,
        model,
        evaluator,
        metrics: Sequence[str] = ("PRECISION", "RECALL", "MAP", "NDCG"),
        freq: int = 1,
        allow_worse: int = 5,
        after: int = 0,
        cutoff: Optional[int] = None,
    ):
        self.model = model
        self.evaluator = evaluator
        self.metrics = list(metrics)
        self.freq = freq if freq else 1
        self.allow_worse = allow_worse if allow_worse is not None else 5
        self.worse_left = self.allow_worse
        self.after = after
        self.best_scores = np.zeros(len(self.metrics))
        self.scores: List[np.ndarray] = []
        self.cutoff = cutoff

    def _comparison_cutoff(self):
        if self.cutoff is not None:
            return self.cutoff
        return min(self.evaluator.cutoff_list)

    def score(self, epoch: int) -> None:
        if epoch % self.freq == 0:
            results_dic, _ = self.evaluator.evaluateRecommender(self.model)
            at = self._comparison_cutoff()
            curr = np.array([results_dic[at][m] for m in self.metrics])
            self.scores.append(curr)
            if np.all(np.less_equal(curr, self.best_scores)):
                if self.worse_left > 0:
                    self.worse_left -= 1
                else:
                    self.model.stop_fit()
                    self.model.load_model()
            else:
                self.best_scores = curr
                self.worse_left = self.allow_worse
                self.model.save_current_model()

    def __call__(self, epoch: int) -> None:
        if epoch > self.after:
            self.score(epoch)

    def reset(self):
        self.worse_left = self.allow_worse

    def load_best(self):
        self.model.load_model()

    def get_scores(self):
        return self.scores


class IncrementalTrainingEarlyStopping:
    """Mixin for epoch-trained baselines (IALS, SLIM-BPR).

    Subclasses implement ``_run_epoch``, ``_prepare_model_for_validation``
    and ``_update_best_model``.
    """

    def _run_epoch(self, num_epoch):
        raise NotImplementedError

    def _prepare_model_for_validation(self):
        raise NotImplementedError

    def _update_best_model(self):
        raise NotImplementedError

    def get_early_stopping_final_epochs_dict(self):
        return {"epochs": self.epochs_best}

    def _train_with_early_stopping(
        self,
        epochs_max: int,
        epochs_min: int = 0,
        validation_every_n: Optional[int] = None,
        stop_on_validation: bool = False,
        validation_metric: Optional[str] = None,
        lower_validations_allowed: Optional[int] = None,
        evaluator_object=None,
        algorithm_name: str = "Incremental_Training_Early_Stopping",
    ):
        assert epochs_max > 0 and 0 <= epochs_min <= epochs_max
        if evaluator_object is not None:
            assert validation_every_n is not None and validation_metric is not None
            if stop_on_validation:
                assert lower_validations_allowed is not None

        self.best_validation_metric = None
        lower_validations_count = 0
        convergence = False
        self.epochs_best = 0
        epochs_current = 0

        # optional crash resume: models that define _checkpoint_state and set
        # self.checkpointer restore the latest training state and continue
        # (validation-tracking state restarts; best-model snapshots are
        # re-established at the next validation)
        checkpointer = getattr(self, "checkpointer", None)
        can_checkpoint = checkpointer is not None and hasattr(self, "_checkpoint_state")
        if can_checkpoint:
            latest = checkpointer.latest_epoch()
            if latest is not None:
                self._restore_checkpoint_state(
                    checkpointer.restore(latest, self._checkpoint_state())
                )
                epochs_current = latest
                self.epochs_best = latest

        while epochs_current < epochs_max and not convergence:
            self._run_epoch(epochs_current)

            if can_checkpoint and checkpointer.due(epochs_current + 1):
                # on a mesh every rank gathers the state (a collective) and
                # rank 0 writes it
                state = self._checkpoint_state()
                plan = getattr(self, "mesh_plan", None)
                if plan is None or plan.rank == 0:
                    checkpointer.save(epochs_current + 1, state)

            if evaluator_object is None:
                self.epochs_best = epochs_current

            elif (epochs_current + 1) % validation_every_n == 0:
                self._prepare_model_for_validation()
                results_run, _ = evaluator_object.evaluateRecommender(self)
                current_metric_value = results_run[list(results_run.keys())[0]][validation_metric]

                if self.best_validation_metric is None or self.best_validation_metric < current_metric_value:
                    self.best_validation_metric = current_metric_value
                    self._update_best_model()
                    self.epochs_best = epochs_current + 1
                    lower_validations_count = 0
                else:
                    lower_validations_count += 1

                if (
                    stop_on_validation
                    and lower_validations_count >= lower_validations_allowed
                    and epochs_current >= epochs_min
                ):
                    convergence = True

            epochs_current += 1

        if evaluator_object is None:
            self._prepare_model_for_validation()
            self._update_best_model()
