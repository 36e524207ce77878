"""SGD matrix-factorization trainers: BPR-MF, FunkSVD, AsySVD.

Port of ganmf_tpu/models/mf_sgd.py (the reference's Cython MF epochs,
MatrixFactorization/Cython/MatrixFactorization_Cython_Epoch.pyx:29-910). An
epoch runs its sampled SGD updates in chunks of ``batch_size``: gathers of
the chunk's factor rows, the BPR sigmoid gradient or the pointwise squared
error, the optional AdaGrad scale and row-wise ``index_add_`` updates, in the
JAX epoch's order (:100-155). ``index_add_`` sums a chunk's duplicate rows,
as JAX's ``.at[].add`` does.

The draws (:44-71) come from a ``torch.Generator`` on the model's device, by
JAX's rules: u a uniform warm user, a uniform slot of u's profile
(randint(0, 2^31 - 1) % length) giving i and r_ui, and for BPR j the first of
8 uniform candidate items that u has not seen, or the first candidate when
all 8 are seen. With ``presample`` (the default) a whole epoch's draws are
made at once; without it each chunk draws its own inside the loop.
``mf_epoch`` takes the draws as an input, so that an epoch can be run from
the JAX package's.

Storage (``urm_storage``): "dense" reads r_ui and the seen test from the
dense [U, I] URM on the device; "csr" keeps only the padded-CSR planes and
reads r_ui at the drawn slot and the seen test as a membership check against
u's padded row. Both give the same draws from the same generator state.

On a CUDA device ``index_add_`` sums a chunk's duplicate rows by atomics, in
no fixed order: two runs on the card need not be bitwise equal.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.data.device import dense_from_sparse, padded_csr_from_sparse
from ganmf_tpu_torch.models.base import MatrixFactorizationRecommender
from ganmf_tpu_torch.models.early_stopping import IncrementalTrainingEarlyStopping

#: Samples whose [n, 8, L] membership test the csr storage runs at once.
MEMBERSHIP_ELEMENTS = 1 << 24


class MFState(NamedTuple):
    """JAX's ``_MFState`` (:24-31)."""

    U: torch.Tensor  # [n_users, K]
    V: torch.Tensor  # [n_items, K]
    bU: torch.Tensor  # [n_users]
    bV: torch.Tensor  # [n_items]
    bG: torch.Tensor  # [1] global bias (reference pyx:179 GLOBAL_bias)
    cacheU: torch.Tensor  # AdaGrad's sum of squares per user [n_users]
    cacheV: torch.Tensor  # per item [n_items]


class MFTables(NamedTuple):
    """The epoch-constant sampling tables, on the device."""

    urm: Optional[torch.Tensor]  # [U, I] float32 ratings; None under csr storage
    val: torch.Tensor  # [U, L] padded rating values
    warm: torch.Tensor  # [W] users with at least one interaction
    profile: torch.Tensor  # [U, L] item ids, padded with n_items
    profile_len: torch.Tensor  # [U], at least 1
    n_items: int


def _f32(x) -> float:
    """x rounded to float32, as JAX traces a Python scalar."""
    return float(np.float32(x))


def build_tables(urm: sps.csr_matrix, device: torch.device, storage: str = "dense") -> MFTables:
    """The sampling tables of a CSR rating matrix (JAX :212-229)."""
    lens = np.ediff1d(urm.indptr)
    pc = padded_csr_from_sparse(urm, device)
    return MFTables(
        urm=None if storage == "csr" else dense_from_sparse(urm, device),
        val=pc.val,
        warm=torch.from_numpy(np.where(lens > 0)[0].astype(np.int64)).to(device),
        profile=pc.idx,
        profile_len=torch.from_numpy(np.maximum(lens, 1).astype(np.int64)).to(device),
        n_items=urm.shape[1],
    )


def _first_unseen(tables: MFTables, u: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Per sample, the first of its candidates that u has not seen, or the
    first candidate when all are seen (JAX's argmax over an all-zero row)."""
    if tables.urm is not None:
        seen = tables.urm[u[:, None], cand] != 0
    else:
        # membership against u's padded row, in slices of MEMBERSHIP_ELEMENTS
        L = tables.profile.shape[1]
        step = max(1, MEMBERSHIP_ELEMENTS // (cand.shape[1] * L))
        seen = torch.cat([
            (tables.profile[u[lo : lo + step]][:, None, :] == cand[lo : lo + step, :, None]).any(-1)
            for lo in range(0, len(u), step)])
    first = torch.argmax((~seen).to(torch.int32), dim=1)  # the first maximum: 0 if all are seen
    return torch.gather(cand, 1, first[:, None])[:, 0]


def draw_samples(tables: MFTables, shape, with_neg: bool, generator: torch.Generator):
    """(u, i, r_ui, j) of the given leading shape, int64 ids and float32
    ratings on the tables' device (JAX :44-71); j is 0 without ``with_neg``."""
    dev = tables.profile.device
    n = int(np.prod(shape))
    u = tables.warm[torch.randint(0, tables.warm.shape[0], (n,), generator=generator, device=dev)]
    slot = torch.randint(0, 2**31 - 1, (n,), generator=generator, device=dev) % tables.profile_len[u]
    i = tables.profile[u, slot]
    r_ui = tables.val[u, slot] if tables.urm is None else tables.urm[u, i]
    if with_neg:
        cand = torch.randint(0, tables.n_items, (n, 8), generator=generator, device=dev)
        j = _first_unseen(tables, u, cand)
    else:
        j = torch.zeros_like(u)
    return tuple(t.view(*shape) for t in (u, i, r_ui, j))


@torch.no_grad()
def mf_epoch(
    state: MFState,
    draws: Iterable,  # per chunk (u, i, r_ui, j): [chunk] int64, int64, float32, int64
    *,
    learning_rate: float,
    user_reg: float,
    item_reg: float,
    bias_reg: float,
    algorithm: str,
    use_adagrad: bool,
    use_bias: bool,
) -> MFState:
    """One epoch over the chunks of ``draws``, in JAX's update order
    (:100-155); returns a new state and leaves ``state`` as it was.
    ``algorithm`` is "bpr", or "funk_svd" / "asy_svd" (pointwise squared
    error on the observed cells)."""
    lr, ur, ir, br = _f32(learning_rate), _f32(user_reg), _f32(item_reg), _f32(bias_reg)
    U, V, bU, bV, bG, cacheU, cacheV = (t.clone() for t in state)
    bpr = algorithm == "bpr"

    for u, i, r_ui, j in draws:
        Uu = U.index_select(0, u)  # [C, K]
        Vi = V.index_select(0, i)
        if bpr:
            Vj = V.index_select(0, j)
            diff = Vi - Vj
            g = 1.0 / (1.0 + torch.exp(torch.sum(Uu * diff, dim=1)))  # the sigmoid gradient
            dU = g[:, None] * diff - ur * Uu
            dVi = g[:, None] * Uu - ir * Vi
            dVj = -g[:, None] * Uu - ir * Vj
        else:
            pred = torch.sum(Uu * Vi, dim=1)
            if use_bias:
                bU_u, bV_i = bU.index_select(0, u), bV.index_select(0, i)
                pred = pred + bG[0] + bU_u + bV_i
            err = r_ui - pred
            dU = err[:, None] * Vi - ur * Uu
            dVi = err[:, None] * Uu - ir * Vi

        if use_adagrad:
            # the cache takes the chunk's squares first, then gives the scale
            cacheU.index_add_(0, u, torch.mean(dU * dU, dim=1))
            cacheV.index_add_(0, i, torch.mean(dVi * dVi, dim=1))
            step_u = (lr * (1.0 / (torch.sqrt(cacheU.index_select(0, u)) + 1e-8)))[:, None]
            step_v = (lr * (1.0 / (torch.sqrt(cacheV.index_select(0, i)) + 1e-8)))[:, None]
        else:
            step_u = step_v = lr

        U.index_add_(0, u, step_u * dU)
        V.index_add_(0, i, step_v * dVi)
        if bpr:
            V.index_add_(0, j, step_v * dVj)
        elif use_bias:
            # the biases step from the chunk's pre-update error; the global
            # bias with the chunk-mean gradient (JAX :141-153)
            bU.index_add_(0, u, lr * (err - br * bU_u))
            bV.index_add_(0, i, lr * (err - br * bV_i))
            bG = bG + lr * torch.mean(err - br * bG[0])
    return MFState(U, V, bU, bV, bG, cacheU, cacheV)


def state_from_jax(state) -> MFState:
    """The port's state from the arrays of JAX's ``_MFState`` (as numpy
    arrays or anything ``np.asarray`` takes), on the CPU."""
    return MFState(*(torch.from_numpy(np.array(x, dtype=np.float32)) for x in state))


class _MFSGDBase(MatrixFactorizationRecommender, IncrementalTrainingEarlyStopping):
    ALGORITHM = "funk_svd"

    def fit(
        self,
        epochs: int = 300,
        num_factors: int = 10,
        learning_rate: float = 0.001,
        use_bias: bool = True,
        user_reg: float = 0.0,
        item_reg: float = 0.0,
        bias_reg: float = 0.0,
        sgd_mode: str = "adagrad",
        init_std: float = 0.1,
        random_seed: int = 1234,
        batch_size: int = 256,
        samples_per_epoch: int = None,
        mesh_plan=None,
        presample: bool = True,
        urm_storage: str = "dense",
        **earlystopping_kwargs,
    ):
        if urm_storage not in ("dense", "csr"):
            raise ValueError(f"urm_storage must be 'dense' or 'csr', got {urm_storage!r}")
        if mesh_plan is not None:
            raise NotImplementedError("mesh_plan is not ported")
        # BPR forces use_bias off, as the reference wrappers do
        # (MatrixFactorization_Cython.py:39 fit default, :184 BPR override)
        self._use_bias = False if self.ALGORITHM == "bpr" else bool(use_bias)
        self._presample = bool(presample)
        rng = np.random.RandomState(random_seed)
        K = int(num_factors)
        self.num_factors = K

        urm = self.URM_train
        # urm_storage="csr" trains from the padded planes alone
        self._tables = build_tables(urm, self.device, urm_storage)

        def table(shape):
            return torch.from_numpy(rng.normal(0, init_std, shape).astype(np.float32)).to(self.device)

        z = lambda n: torch.zeros(n, dtype=torch.float32, device=self.device)  # noqa: E731
        self._state = MFState(
            U=table((self.n_users, K)), V=table((self.n_items, K)),
            bU=z(self.n_users), bV=z(self.n_items), bG=z(1), cacheU=z(self.n_users), cacheV=z(self.n_items),
        )
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(random_seed)
        self._chunk = int(batch_size)
        n_samples = samples_per_epoch or max(self.n_users, urm.nnz // 4)
        self._n_chunks = max(1, int(np.ceil(n_samples / self._chunk)))
        self._hyper = dict(
            learning_rate=float(learning_rate), user_reg=float(user_reg), item_reg=float(item_reg),
            bias_reg=float(bias_reg), algorithm=self.ALGORITHM, use_adagrad=sgd_mode == "adagrad",
            use_bias=self._use_bias,
        )

        self._update_best_model()
        self._train_with_early_stopping(epochs, algorithm_name=self.RECOMMENDER_NAME, **earlystopping_kwargs)
        self.USER_factors = self.USER_factors_best
        self.ITEM_factors = self.ITEM_factors_best
        # the published biases are host arrays, as the JAX fit's (saveModel
        # writes them)
        best = self._bias_best
        self._export_biases(None if best is None else (best[0].cpu().numpy(), best[1].cpu().numpy(), best[2]))

    def _run_epoch(self, num_epoch):
        with_neg = self.ALGORITHM == "bpr"
        if self._presample:
            draws = zip(*draw_samples(self._tables, (self._n_chunks, self._chunk), with_neg, self._generator))
        else:
            draws = (draw_samples(self._tables, (self._chunk,), with_neg, self._generator)
                     for _ in range(self._n_chunks))
        self._state = mf_epoch(self._state, draws, **self._hyper)

    # -- crash resume (the state and the generator's state) -------------------
    def _checkpoint_state(self):
        return {"state": self._state._asdict(), "generator": self._generator.get_state()}

    def _restore_checkpoint_state(self, state):
        self._state = MFState(**{k: v.to(self.device) for k, v in state["state"].items()})
        self._generator.set_state(state["generator"])

    def _export_biases(self, triple):
        """Publish (bU, bV, bG) for scoring (folded into the device factors by
        ``_factors_device``), or mark the model biasless (JAX :292-303)."""
        if self._use_bias and triple is not None:
            self.USER_bias, self.ITEM_bias, self.GLOBAL_bias = triple
            self.use_bias = True
        else:
            self.USER_bias = self.ITEM_bias = None
            self.GLOBAL_bias = 0.0
            self.use_bias = False
        self._device_factors = None

    def _bias_triple(self):
        """(bU, bV, bG) of the state: the bias tables stay on the device, the
        global bias is read to the host (one sync, as JAX's ``float``)."""
        return self._state.bU, self._state.bV, float(self._state.bG[0])

    # the factor stores take the device tensors: an epoch makes new tensors,
    # so a stored one never changes
    def _prepare_model_for_validation(self):
        self.USER_factors = self._state.U
        self.ITEM_factors = self._state.V
        self._export_biases(self._bias_triple() if self._use_bias else None)

    def _update_best_model(self):
        self.USER_factors_best = self._state.U
        self.ITEM_factors_best = self._state.V
        self._bias_best = self._bias_triple() if self._use_bias else None


class MatrixFactorization_BPR(_MFSGDBase):
    """BPR-MF (reference MatrixFactorization_Cython.py:172)."""

    RECOMMENDER_NAME = "MF_BPR_Recommender"
    ALGORITHM = "bpr"


class MatrixFactorization_FunkSVD(_MFSGDBase):
    """FunkSVD pointwise MF (reference MatrixFactorization_Cython.py:193)."""

    RECOMMENDER_NAME = "MF_FunkSVD_Recommender"
    ALGORITHM = "funk_svd"


class MatrixFactorization_AsySVD(_MFSGDBase):
    """AsySVD with biases (reference MatrixFactorization_Cython.py:220)."""

    RECOMMENDER_NAME = "MF_AsySVD_Recommender"
    ALGORITHM = "asy_svd"
