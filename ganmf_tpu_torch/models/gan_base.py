"""Shared machinery for the adversarial recommenders.

Port of ganmf_tpu/models/gan_base.py: user and item training modes via
transposition, the best-weight snapshot that early stopping drives, the
shared epoch loop with its metrics-logger and checkpointer hooks, crash
resume with the loss histories beside the state (:90-173), the loss-curve
plot at the loop's end (:175-190), the batching helpers ``make_batches``,
``shuffled_padded_perm`` and ``padded_weights`` (:210-229), and the saveModel
layout (``param_0..param_n`` in parameter order, plus ``config`` and
``mode``), which is the JAX package's, so either package reads the other's
zips.
"""

from __future__ import annotations

import copy
import datetime
import os
from typing import Optional

import numpy as np
import torch

from ganmf_tpu_torch.data.device import dense_from_sparse
from ganmf_tpu_torch.models.base import Recommender
from ganmf_tpu_torch.models.early_stopping import EarlyStoppingScheduler
from ganmf_tpu_torch.utils.analysis import plot_loss
from ganmf_tpu_torch.utils.profiling import root


class AdversarialRecommender(Recommender):
    """Base for GAN recommenders whose parameters are one ``nn.Module``."""

    RECOMMENDER_NAME = "AdversarialRecommender"
    SUPPORTS_ITEM_MODE = True

    def __init__(self, URM_train, mode: str = "user", seed: int = 1234, verbose: bool = False,
                 is_experiment: bool = False, *, device: Optional[torch.device] = None):
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
        # the reference keeps a per-run plots folder (GANMF.py:40-45), made
        # when the first plot is written
        self.logsdir = os.path.join(
            "plots", self.RECOMMENDER_NAME, datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))

        self.params: Optional[torch.nn.Module] = None  # current parameters
        self.best_params: Optional[torch.nn.Module] = None  # early-stopping snapshot
        self._stop_training = False

        # optional observability and durability hooks (ganmf_tpu_torch.utils)
        self.metrics_logger = None  # utils.logging.MetricsLogger
        self.checkpointer = None  # utils.checkpoint.TrainCheckpointer
        # the parallel.MeshPlan the parameters are sharded on, set by a fit
        # on a mesh; None: the parameters are whole
        self.mesh_plan = None

    def _lead(self) -> bool:
        """True on the rank that logs, prints and writes files: every rank
        without a mesh, rank 0 on one."""
        return self.mesh_plan is None or self.mesh_plan.rank == 0

    def _agree(self, value: float, what: str) -> None:
        """On a mesh, raise unless every rank holds the same ``value`` (ranks
        that went different ways would deadlock in their next collective)."""
        if self.mesh_plan is None:
            return
        from ganmf_tpu_torch.parallel import comm

        plan = self.mesh_plan
        both = comm.pmax(torch.tensor([value, -value], dtype=torch.float64, device=plan.device),
                         plan, plan.axis_names).tolist()
        if both[0] != -both[1]:
            raise RuntimeError(f"the mesh's ranks disagree on {what}: from {-both[1]} to {both[0]}")

    def _full_params(self) -> torch.nn.Module:
        """The whole parameters: on a mesh-trained model gathered from the
        shards (``parallel.distributed.gather_module``), a collective that
        every rank calls."""
        if self.mesh_plan is None:
            return self.params
        from ganmf_tpu_torch.parallel.distributed import gather_module

        return gather_module(self.params, self.mesh_plan)

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

    _LOSS_ATTRS = ("train_d_loss", "train_g_loss", "train_pg_loss", "train_ng_loss")

    def _checkpoint_aux(self) -> dict:
        """Variable-length side state (the loss histories) saved beside the
        checkpoint, so that a resumed run keeps its whole loss curves. Reads
        each loss to the host."""
        aux = {}
        for name in self._LOSS_ATTRS:
            vals = getattr(self, name, None)
            if vals:
                aux[name] = np.asarray([float(v) for v in vals], np.float32)
        return aux

    def _restore_checkpoint_aux(self, aux: dict) -> None:
        for name in self._LOSS_ATTRS:
            if name in aux:
                setattr(self, name, [float(v) for v in aux[name]])

    def resume_from_checkpoint(self) -> int:
        """Restore the latest training checkpoint and its loss histories,
        returning the epoch to continue from (1 when no checkpoint exists).
        Requires ``self.checkpointer`` and the model to be mid-fit (state
        built)."""
        if self.checkpointer is None:
            return 1
        latest = self.checkpointer.latest_epoch()
        self._agree(-1 if latest is None else latest, "the latest checkpoint")
        if latest is None:
            return 1
        self._restore_checkpoint_state(self.checkpointer.restore(latest, self._checkpoint_state()))
        aux = self.checkpointer.restore_aux(latest)
        if aux:
            self._restore_checkpoint_aux(aux)
        return latest + 1

    def _run_training_loop(self, epochs, validation_evaluator, validation_set, sample_every,
                           allow_worse, freq, metrics, after, epoch_fn, start_epoch: int = 1):
        """The reference's fit() main loop (GANMF.py:151-244).

        ``epoch_fn(epoch_index)`` runs one full epoch on the device, the
        root span ``train.epoch``. Returns the reference's fit() return
        value: the last epoch run when early stopping stopped the fit, else
        ``epochs + 1``.
        """
        self._stop_training = False
        early_stop = None
        if validation_evaluator is not None:
            early_stop = EarlyStoppingScheduler(
                self, evaluator=validation_evaluator, allow_worse=allow_worse,
                freq=freq, metrics=metrics, after=after,
            )

        # on a mesh every rank runs this loop; only rank 0 logs, prints and
        # writes, and every rank must reach the same early-stopping decision
        lead = self._lead()
        epoch = start_epoch
        while not self._stop_training and epoch < epochs + 1:
            with root("train.epoch"):
                epoch_fn(epoch)

            if self.metrics_logger is not None and lead:
                self.metrics_logger.log_epoch(epoch)
            if self.checkpointer is not None and self.checkpointer.due(epoch):
                # on a mesh, gathering the state is a collective of every rank
                state, aux = self._checkpoint_state(), self._checkpoint_aux()
                if lead:
                    self.checkpointer.save(epoch, state, aux=aux)

            if validation_set is not None and sample_every is not None and epoch % sample_every == 0:
                results, results_string = validation_evaluator.evaluateRecommender(self)
                if self.metrics_logger is not None and lead:
                    self.metrics_logger.log_eval(epoch, results)
                if self.verbose and lead:
                    print(f"Epoch {epoch}:\n{results_string}")

            if early_stop is not None:
                early_stop(epoch)
                self._agree(float(self._stop_training), f"stopping at epoch {epoch}")
                if self._stop_training and self.verbose and lead:
                    print("Training stopped, epoch:", epoch)

            epoch += 1

        if not self.is_experiment and lead:
            self._save_loss_plots()

        return epoch - 1 if self._stop_training else epoch

    def _save_loss_plots(self):
        """The loss curves as a plot in ``logsdir``, like the reference's plot
        sinks (Utils_.plot_loss_acc, Utils_.py:109)."""
        curves = {}
        for name in self._LOSS_ATTRS:
            values = getattr(self, name, None)
            if values:
                curves[name] = [float(v) for v in values]
        if curves:
            plot_loss(curves, os.path.join(self.logsdir, "losses.png"), ylabel="loss",
                      title=self.RECOMMENDER_NAME)

    # -- persistence ----------------------------------------------------------
    def _save_dict(self):
        flat = {}
        if self.params is not None:
            leaves = [p.detach().cpu().numpy() for p in self._full_params().parameters()]
            flat["_n_leaves"] = np.asarray([len(leaves)])
            for i, leaf in enumerate(leaves):
                flat[f"param_{i}"] = leaf
        if self.config is not None:
            flat["config"] = {k: v for k, v in self.config.items() if _json_safe(v)}
        flat["mode"] = self.mode
        return flat

    def saveModel(self, folder_path, file_name=None):
        """As the base's; on a mesh every rank calls it (the parameters are
        gathered) and rank 0 writes."""
        if self._lead():
            super().saveModel(folder_path, file_name)
        else:
            self._save_dict()


def _json_safe(v):
    return isinstance(v, (int, float, str, bool, list, tuple, type(None)))


ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8  # optax.scale_by_adam's and TF1's defaults


def apply_grads(opt: torch.optim.Optimizer, params, grads) -> None:
    """One optimizer step on ``params`` with ``grads`` (each phase takes the
    gradient of its own parameters only; the other network stays frozen)."""
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def make_batches(n_rows: int, batch_size: int):
    """Static batching plan: number of batches and padded length."""
    n_batches = int(np.ceil(n_rows / batch_size))
    return n_batches, n_batches * batch_size


def shuffled_padded_perm(rng: np.random.RandomState, n_rows: int, padded: int) -> np.ndarray:
    """The epoch's shuffle on the host (reference np.random.shuffle,
    GANMF.py:175); padding slots replay row 0 with zero weight. Kept in numpy
    so that both packages draw the same permutation from one seed."""
    perm = np.arange(n_rows)
    rng.shuffle(perm)
    out = np.zeros(padded, dtype=np.int32)
    out[:n_rows] = perm
    return out


def padded_weights(n_rows: int, padded: int) -> np.ndarray:
    w = np.zeros(padded, dtype=np.float32)
    w[:n_rows] = 1.0
    return w
