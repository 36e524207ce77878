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

``fit(mesh_plan=...)`` trains on a mesh of ranks (JAX :240-255): U, bU and
cacheU over the user rows, V, bV and cacheV over the item rows, the dense URM
over (data, model), the padded planes over the user rows, bG replicated
(``parallel.baselines.Shards``). The draws and the epoch are the ones above,
reading and writing rows through that layout: every rank draws the same
samples as the one-process fit from its own generator, seeded alike, reading
the drawn ids, ratings and seen tests from the ranks that hold them; each
chunk gathers its rows from their owners, every rank computes the update
alike and the owners apply it. The factor stores and checkpoints hold the
full tables (gathered, a collective every rank calls).
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


#: each field of an MFState: its rows on a mesh (None: replicated)
STATE_ROWS = ("users", "items", "users", "items", None, "users", "items")


def build_tables(urm: sps.csr_matrix, device: torch.device, storage: str = "dense", lay=None) -> MFTables:
    """The sampling tables of a CSR rating matrix (JAX :212-229); with a
    mesh layout ``lay`` (``parallel.baselines.Shards``) this rank's padded
    rows and URM block, the warm users and the profile lengths whole."""
    lens = np.ediff1d(urm.indptr)
    rows, block = (urm, urm) if lay is None else lay.local_csr(urm)
    pc = padded_csr_from_sparse(rows, device)
    return MFTables(
        urm=None if storage == "csr" else dense_from_sparse(block, device),
        val=pc.val,
        warm=torch.from_numpy(np.where(lens > 0)[0].astype(np.int64)).to(device),
        profile=pc.idx,
        profile_len=torch.from_numpy(np.maximum(lens, 1).astype(np.int64)).to(device),
        n_items=urm.shape[1],
    )


def seen_in_profiles(profile: torch.Tensor, rows: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[n, c] whether cand[s] is in row rows[s] of the padded ``profile``: a
    membership test against the row, in slices of MEMBERSHIP_ELEMENTS."""
    L = profile.shape[1]
    step = max(1, MEMBERSHIP_ELEMENTS // (cand.shape[1] * L))
    return torch.cat([(profile[rows[lo : lo + step]][:, None, :] == cand[lo : lo + step, :, None]).any(-1)
                      for lo in range(0, len(rows), step)])


def draw_samples(tables, shape, with_neg: bool, generator: torch.Generator, lay=None, want_rating: bool = True):
    """(u, i, r_ui, j) of the given leading shape, int64 ids and float32
    ratings on the tables' device (JAX :44-71); j is 0 without ``with_neg``,
    r_ui None without ``want_rating``. The seen test reads the dense URM, or
    u's padded row under csr storage (``tables.urm`` None).

    With a mesh layout ``lay`` (``parallel.baselines.Shards``) and this
    rank's ``build_tables(..., lay)``: the same random calls in the same
    order on every rank, the drawn slot's item and rating and the
    candidates' seen test read from the ranks that hold them, in two
    collectives (the ids, then the ratings and the seen tests)."""
    if lay is None:
        from ganmf_tpu_torch.parallel.baselines import WHOLE as lay
    rows, urm = lay.users, tables.urm
    dev = tables.profile.device
    n = int(np.prod(shape))
    u = tables.warm[torch.randint(0, tables.warm.shape[0], (n,), generator=generator, device=dev)]
    slot = torch.randint(0, 2**31 - 1, (n,), generator=generator, device=dev) % tables.profile_len[u]
    ints = [rows.take_at(tables.profile, u, slot)]
    cand = torch.randint(0, tables.n_items, (n, 8), generator=generator, device=dev) if with_neg else None
    if with_neg and urm is None:
        ints.append(rows.read(lambda at: seen_in_profiles(tables.profile, at, cand), u).to(torch.int64))
    ints = lay.psum(ints)
    i = ints[0]
    floats = []
    if want_rating:
        floats.append(rows.take_at(tables.val, u, slot) if urm is None else lay.urm_values(urm, u, i[:, None])[:, 0])
    if with_neg and urm is not None:
        floats.append(lay.urm_values(urm, u, cand))
    floats = lay.psum(floats)
    r_ui = floats.pop(0) if want_rating else None
    if with_neg:
        seen = floats.pop(0) != 0 if urm is not None else ints[1] > 0
        first = torch.argmax((~seen).to(torch.int32), dim=1)  # the first maximum: 0 if all are seen
        j = torch.gather(cand, 1, first[:, None])[:, 0]
    else:
        j = torch.zeros_like(u)
    return tuple(None if t is None else t.view(*shape) for t in (u, i, r_ui, j))


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
    lay=None,
) -> MFState:
    """One epoch over the chunks of ``draws``, in JAX's update order
    (:100-155); returns a new state and leaves ``state`` as it was.
    ``algorithm`` is "bpr", or "funk_svd" / "asy_svd" (pointwise squared
    error on the observed cells).

    With a mesh layout ``lay`` (``parallel.baselines.Shards``) the state is
    this rank's shards (``lay.shard(state, STATE_ROWS)``): each chunk
    gathers its rows of U (and bU), V at i (and j, or bV) in one collective,
    and with AdaGrad the updated caches at u and i in a second."""
    if lay is None:
        from ganmf_tpu_torch.parallel.baselines import WHOLE as lay
    users, items = lay.users, lay.items
    lr, ur, ir, br = _f32(learning_rate), _f32(user_reg), _f32(item_reg), _f32(bias_reg)
    U, V, bU, bV, bG, cacheU, cacheV = (t.clone() for t in state)
    bpr = algorithm == "bpr"

    for u, i, r_ui, j in draws:
        parts = [users.take(U, u), items.take(V, i)]  # [C, K]
        if bpr:
            parts.append(items.take(V, j))
        elif use_bias:
            parts += [users.take(bU, u), items.take(bV, i)]
        Uu, Vi, *rest = lay.psum(parts)
        if bpr:
            Vj, = rest
            diff = Vi - Vj
            g = 1.0 / (1.0 + torch.exp(torch.sum(Uu * diff, dim=1)))  # the sigmoid gradient
            dU = g[:, None] * diff - ur * Uu
            dVi = g[:, None] * Uu - ir * Vi
            dVj = -g[:, None] * Uu - ir * Vj
        else:
            pred = torch.sum(Uu * Vi, dim=1)
            if use_bias:
                bU_u, bV_i = rest
                pred = pred + bG[0] + bU_u + bV_i
            err = r_ui - pred
            dU = err[:, None] * Vi - ur * Uu
            dVi = err[:, None] * Uu - ir * Vi

        if use_adagrad:
            # the cache takes the chunk's squares first, then gives the scale
            users.add_(cacheU, u, torch.mean(dU * dU, dim=1))
            items.add_(cacheV, i, torch.mean(dVi * dVi, dim=1))
            cu, cv = lay.psum([users.take(cacheU, u), items.take(cacheV, i)])
            step_u = (lr * (1.0 / (torch.sqrt(cu) + 1e-8)))[:, None]
            step_v = (lr * (1.0 / (torch.sqrt(cv) + 1e-8)))[:, None]
        else:
            step_u = step_v = lr

        users.add_(U, u, step_u * dU)
        items.add_(V, i, step_v * dVi)
        if bpr:
            items.add_(V, j, step_v * dVj)
        elif use_bias:
            # the biases step from the chunk's pre-update error; the global
            # bias with the chunk-mean gradient (JAX :141-153)
            users.add_(bU, u, lr * (err - br * bU_u))
            items.add_(bV, i, lr * (err - br * bV_i))
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
        if mesh_plan is not None and mesh_plan.device != self.device:
            raise ValueError(f"model on {self.device}, its mesh plan on {mesh_plan.device}")
        # BPR forces use_bias off, as the reference wrappers do
        # (MatrixFactorization_Cython.py:39 fit default, :184 BPR override)
        self._use_bias = False if self.ALGORITHM == "bpr" else bool(use_bias)
        self._presample = bool(presample)
        rng = np.random.RandomState(random_seed)
        K = int(num_factors)
        self.num_factors = K

        from ganmf_tpu_torch.parallel.baselines import WHOLE, Shards

        urm = self.URM_train
        self.mesh_plan = mesh_plan
        self._lay = WHOLE if mesh_plan is None else Shards(mesh_plan, self.n_users, self.n_items)
        # urm_storage="csr" trains from the padded planes alone
        self._tables = build_tables(urm, self.device, urm_storage, self._lay)

        def table(shape):
            return torch.from_numpy(rng.normal(0, init_std, shape).astype(np.float32)).to(self.device)

        z = lambda n: torch.zeros(n, dtype=torch.float32, device=self.device)  # noqa: E731
        self._state = MFState(
            U=table((self.n_users, K)), V=table((self.n_items, K)),
            bU=z(self.n_users), bV=z(self.n_items), bG=z(1), cacheU=z(self.n_users), cacheV=z(self.n_items),
        )
        self._state = self._lay.shard(self._state, STATE_ROWS)
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

    def _draw(self, shape):
        """(u, i, r_ui, j) of ``draw_samples``; on a mesh from this rank's
        shards (collectives every rank calls). One process calls it with its
        four arguments alone, as JAX's draws are passed in."""
        mesh = () if self.mesh_plan is None else (self._lay,)
        return draw_samples(self._tables, shape, self.ALGORITHM == "bpr", self._generator, *mesh)

    def _run_epoch(self, num_epoch):
        if self._presample:
            draws = zip(*self._draw((self._n_chunks, self._chunk)))
        else:
            draws = (self._draw((self._chunk,)) for _ in range(self._n_chunks))
        self._state = mf_epoch(self._state, draws, **self._hyper, lay=self._lay)

    def _full_state(self) -> MFState:
        """The full state; on a mesh gathered from the shards (a collective)."""
        return self._lay.gather(self._state, STATE_ROWS)

    # -- crash resume (the state and the generator's state); on a mesh the
    # full state, so that a checkpoint resumes on any plan ---------------------
    def _checkpoint_state(self):
        return {"state": self._full_state()._asdict(), "generator": self._generator.get_state()}

    def _restore_checkpoint_state(self, state):
        self._state = self._lay.shard(MFState(**{k: v.to(self.device) for k, v in state["state"].items()}),
                                      STATE_ROWS)
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

    @staticmethod
    def _bias_triple(state):
        """(bU, bV, bG) of a full state: the bias tables stay on the device,
        the global bias is read to the host (one sync, as JAX's ``float``)."""
        return state.bU, state.bV, float(state.bG[0])

    # the factor stores take the device tensors: an epoch makes new tensors,
    # so a stored one never changes
    def _prepare_model_for_validation(self):
        full = self._full_state()
        self.USER_factors = full.U
        self.ITEM_factors = full.V
        self._export_biases(self._bias_triple(full) if self._use_bias else None)

    def _update_best_model(self):
        full = self._full_state()
        self.USER_factors_best = full.U
        self.ITEM_factors_best = full.V
        self._bias_best = self._bias_triple(full) if self._use_bias else None


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
