"""SLIM-BPR: an item-item similarity learned with BPR sampling.

Port of ganmf_tpu/models/slim_bpr.py. The item-item W is dense on the
device; an epoch draws n_users (u, i+, j-) triples and processes them in
chunks of ``chunk_size``: gathers of W's rows, a masked row dot for x_uij,
the sigmoid gradient, the per-item AdaGrad / RMSProp / Adam caches and
row-wise ``index_add_`` updates, in the JAX epoch's order (:80-143). The
symmetric variant reads W[i] + W[:, i], the reference's shared triangular
cells; the column is an ``index_select`` along dim 1, which gives the values
of JAX's one-hot product without its FLOPs.

The draws (:38-54) come from a ``torch.Generator`` on the model's device, the
whole epoch's at once, by JAX's rules: u a warm user, i+ a uniform slot of
u's profile, j- the first unseen of 8 uniform candidates (candidate 0 when
all 8 are seen). ``bpr_epoch`` takes the triples as an input, so that an
epoch can be run from the JAX package's draws.

On a CUDA device ``index_add_`` sums a chunk's duplicate rows by atomics, in
no fixed order: two runs on the card need not be bitwise equal.

``fit(mesh_plan=...)`` trains on a mesh of ranks (JAX :249-262): W, cache,
m1 and m2 row-sharded over the model axis, the URM over (data, model), the
padded profiles over the user rows (``parallel.baselines.Shards``). The draws
and the epoch are the ones above, reading and writing rows through that
layout: every rank draws the same triples as the one-process fit, reading
the drawn ids and seen tests from the ranks that hold them; each chunk
gathers the whole seen rows and W's rows (and the symmetric form's columns)
from their owners in one collective, every rank computes the update alike,
and the owners apply it and their caches' updates. The prune and the
``W_sparse`` export run on the gathered W, the same on every rank;
checkpoints hold the full state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.data.device import dense_from_sparse
from ganmf_tpu_torch.models.base import ItemSimilarityRecommender, check_matrix, row_col_topk
from ganmf_tpu_torch.models.early_stopping import IncrementalTrainingEarlyStopping
from ganmf_tpu_torch.models.mf_sgd import draw_samples
from ganmf_tpu_torch.ops.similarity import csc_from_col_topk
from ganmf_tpu_torch.ops.topk import scatter_col_topk_dense


class OptState(NamedTuple):
    """JAX's ``_OptState`` (:29-35)."""

    W: torch.Tensor  # [I, I]
    cache: torch.Tensor  # adagrad / rmsprop second moment per item [I]
    m1: torch.Tensor  # adam first moment per item [I]
    m2: torch.Tensor  # adam second moment per item [I]
    beta1_t: torch.Tensor  # adam bias-correction powers (0-dim)
    beta2_t: torch.Tensor


class BPRTables(NamedTuple):
    """The epoch-constant sampling tables, on the device."""

    urm: torch.Tensor  # [U, I] float32 0/1 mask of the positives
    warm: torch.Tensor  # [W] users with 1 <= profile length < I
    profile: torch.Tensor  # [U, L] item ids, padded with 0
    profile_len: torch.Tensor  # [U], at least 1
    n_items: int


#: each field of an OptState: its rows on a mesh (None: replicated)
STATE_ROWS = ("items", "items", "items", "items", None, None)


def _f32(x) -> float:
    """x rounded to float32, as JAX traces a Python scalar."""
    return float(np.float32(x))


def _integer_pow_f32(x: float, n: int) -> float:
    """x ** n in float32 by JAX's lowering of ``integer_pow``: binary
    exponentiation, every product rounded to float32."""
    x, acc = np.float32(x), None
    while n > 0:
        if n & 1:
            acc = x if acc is None else np.float32(acc * x)
        n >>= 1
        if n > 0:
            x = np.float32(x * x)
    return float(acc) if acc is not None else 1.0


def init_state(n_items: int, beta_1: float, beta_2: float, device: torch.device) -> OptState:
    """The zero state of JAX's ``fit`` (:237-244)."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return OptState(
        W=z(n_items, n_items), cache=z(n_items), m1=z(n_items), m2=z(n_items),
        # = beta, as in the reference's init
        beta1_t=torch.tensor(np.float32(1.0 - (1.0 - beta_1)), device=device),
        beta2_t=torch.tensor(np.float32(1.0 - (1.0 - beta_2)), device=device),
    )


def _profiles(urm_mask: sps.csr_matrix) -> np.ndarray:
    """[U, L] each row's item ids, padded with 0."""
    n_users = urm_mask.shape[0]
    lens = np.ediff1d(urm_mask.indptr)
    lmax = max(int(lens.max()) if len(lens) else 1, 1)
    profile = np.zeros((n_users, lmax), dtype=np.int64)
    profile[np.repeat(np.arange(n_users), lens),
            np.arange(urm_mask.nnz) - np.repeat(urm_mask.indptr[:-1], lens)] = urm_mask.indices
    return profile


def build_tables(urm_mask: sps.csr_matrix, device: torch.device, lay=None) -> BPRTables:
    """The sampling tables of a 0/1 CSR matrix of positives (JAX
    :218-234); with a mesh layout ``lay`` (``parallel.baselines.Shards``)
    this rank's URM block and profile rows, the warm users and the profile
    lengths whole."""
    n_users, n_items = urm_mask.shape
    lens = np.ediff1d(urm_mask.indptr)
    warm = np.where((lens > 0) & (lens < n_items))[0]
    rows, urm = (urm_mask, urm_mask) if lay is None else lay.local_csr(urm_mask)
    return BPRTables(
        urm=dense_from_sparse(urm, device),
        warm=torch.from_numpy(warm.astype(np.int64)).to(device),
        profile=torch.from_numpy(_profiles(rows)).to(device),
        profile_len=torch.from_numpy(np.maximum(lens, 1).astype(np.int64)).to(device),
        n_items=n_items,
    )


def draw_triples(tables: BPRTables, n: int, generator: torch.Generator, lay=None):
    """(u, i, j), each [n] int64 on the tables' device: u a uniform warm
    user, i a uniform slot of u's profile, j the first of 8 uniform candidate
    items that u has not seen, or the first candidate when u has seen all 8
    (JAX :38-52): MF-SGD's ``draw_samples`` without the rating, on a mesh
    layout ``lay`` as there."""
    u, i, _, j = draw_samples(tables, (n,), True, generator, lay, want_rating=False)
    return u, i, j


@torch.no_grad()
def bpr_epoch(
    state: OptState,
    urm: torch.Tensor,  # [U, I] float32 0/1 mask
    triples,  # (u, i, j), each [n_chunks, chunk] int64
    *,
    learning_rate: float,
    li_reg: float,
    lj_reg: float,
    gamma: float,
    beta_1: float,
    beta_2: float,
    sgd_mode: str,
    symmetric: bool,
    lay=None,
) -> OptState:
    """One epoch over the triples, chunk by chunk in JAX's update order
    (:80-143); returns a new state and leaves ``state`` as it was. Any
    ``sgd_mode`` other than adagrad, rmsprop and adam is plain SGD, as in
    JAX.

    With a mesh layout ``lay`` (``parallel.baselines.Shards``) the state is
    this rank's shards (``lay.shard(state, STATE_ROWS)``) and ``urm`` its
    block: each chunk gathers in one collective the whole seen rows P [C, I]
    of its users and the rows W[i], W[j] (with the symmetric form also each
    rank's part of the columns W[:, i], W[:, j]); the caches update on the
    ranks holding the items, and with adagrad, rmsprop or adam a second
    collective gathers the chunk's updated cache (or moments) at i."""
    if lay is None:
        from ganmf_tpu_torch.parallel.baselines import WHOLE as lay
    items = lay.items
    us, is_, js = triples
    chunk = us.shape[1]
    lr, li, lj = _f32(learning_rate), _f32(li_reg), _f32(lj_reg)
    gm, b1, b2 = np.float32(gamma), np.float32(beta_1), np.float32(beta_2)
    one_m_gm, one_m_b1, one_m_b2 = float(1 - gm), float(1 - b1), float(1 - b2)
    gm, b1, b2 = float(gm), float(b1), float(b2)
    b1_pow, b2_pow = _integer_pow_f32(b1, chunk), _integer_pow_f32(b2, chunk)
    W, cache, m1, m2 = (t.clone() for t in state[:4])
    b1t, b2t = state.beta1_t, state.beta2_t

    for u, i, j in zip(us, is_, js):
        parts = [lay.urm_rows(urm, u), items.take(W, i), items.take(W, j)]  # P: [C, I] seen mask
        if symmetric:
            parts += [lay.columns(W, i), lay.columns(W, j)]
        P, Wi, Wj, *cols = lay.psum(parts)
        if symmetric:
            # the reference's triangular storage: the shared cell {a, b}
            # reads as W[a, b] + W[b, a]
            Wi = Wi + cols[0]
            Wj = Wj + cols[1]
        x_uij = torch.sum((Wi - Wj) * P, dim=1)
        g = 1.0 / (1.0 + torch.exp(x_uij))  # [C]
        g2 = g * g

        if sgd_mode == "adagrad":
            items.add_(cache, i, g2)
            items.add_(cache, j, g2)
            c_i, = lay.psum([items.take(cache, i)])
            g_upd = g / (torch.sqrt(c_i) + 1e-8)
        elif sgd_mode == "rmsprop":
            # the decay touches only the chunk's items, as in the reference
            cache = items.set_(cache, i, lambda c: c * gm + one_m_gm * g2)
            cache = items.set_(cache, j, lambda c: c * gm + one_m_gm * g2)
            c_i, = lay.psum([items.take(cache, i)])
            g_upd = g / (torch.sqrt(c_i) + 1e-8)
        elif sgd_mode == "adam":
            m1 = items.set_(m1, i, lambda m: m * b1 + one_m_b1 * g)
            m2 = items.set_(m2, i, lambda m: m * b2 + one_m_b2 * g2)
            m1 = items.set_(m1, j, lambda m: m * b1 + one_m_b1 * g)
            m2 = items.set_(m2, j, lambda m: m * b2 + one_m_b2 * g2)
            m1_i, m2_i = lay.psum([items.take(m1, i), items.take(m2, i)])
            g_upd = (m1_i / (1 - b1t)) / (torch.sqrt(m2_i / (1 - b2t)) + 1e-8)
            b1t = b1t * b1_pow
            b2t = b2t * b2_pow
        else:
            g_upd = g

        # updates over the user's seen items, skipping the updated row's item;
        # every write is row-oriented (the symmetric reads do the mirroring)
        not_i = P.scatter(1, i[:, None], 0.0)
        not_j = P.scatter(1, j[:, None], 0.0)
        items.add_(W, i, lr * (g_upd[:, None] - li * Wi) * not_i)
        items.add_(W, j, -lr * (g_upd[:, None] - lj * Wj) * not_j)
    return OptState(W, cache, m1, m2, b1t, b2t)


def prune_topk_device(W: torch.Tensor, k: int, symmetric: bool):
    """The reference's double top-K prune on the device (JAX :157-180): the
    symmetric cells summed, the diagonal zeroed, each row's then each
    column's top k nonzeros. Returns the pruned dense matrix and its
    per-column [I, k] values and row ids."""
    S = W + W.T if symmetric else W.clone()
    S.fill_diagonal_(0.0)
    cv, cix = row_col_topk(S, min(k, S.shape[0]))
    return scatter_col_topk_dense(cv, cix), cv, cix


class SLIM_BPR(ItemSimilarityRecommender, IncrementalTrainingEarlyStopping):
    RECOMMENDER_NAME = "SLIM_BPR_Recommender"

    def fit(
        self,
        epochs: int = 300,
        positive_threshold: float = 1,
        train_with_sparse_weights: bool = None,  # accepted as in JAX; W is always dense
        symmetric: bool = True,
        random_seed: int = 1234,
        lambda_i: float = 0.0,
        lambda_j: float = 0.0,
        learning_rate: float = 1e-4,
        topK: int = 200,
        sgd_mode: str = "adagrad",
        gamma: float = 0.995,
        beta_1: float = 0.9,
        beta_2: float = 0.999,
        chunk_size: int = 64,
        mesh_plan=None,
        presample: bool = False,  # accepted as in JAX; every epoch's draws are made at once
        **earlystopping_kwargs,
    ):
        if mesh_plan is not None and mesh_plan.device != self.device:
            raise ValueError(f"model on {self.device}, its mesh plan on {mesh_plan.device}")
        self.symmetric = symmetric
        self.topK = topK
        self.sgd_mode = sgd_mode
        self.learning_rate = learning_rate
        self.lambda_i = lambda_i
        self.lambda_j = lambda_j
        self.gamma = gamma
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self._chunk = int(chunk_size)

        urm_mask = self.URM_train.copy()
        if positive_threshold is not None:
            urm_mask.data = (urm_mask.data >= positive_threshold).astype(np.float32)
            urm_mask.eliminate_zeros()
        from ganmf_tpu_torch.parallel.baselines import WHOLE, Shards

        self.mesh_plan = mesh_plan
        self._lay = WHOLE if mesh_plan is None else Shards(mesh_plan, self.n_users, self.n_items)
        self._tables = build_tables(urm_mask, self.device, self._lay)
        # on a mesh, the zero state's shards, made on the host
        self._state = self._lay.shard(
            init_state(self.n_items, beta_1, beta_2, self.device if mesh_plan is None else torch.device("cpu")),
            STATE_ROWS)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(random_seed)
        # one reference epoch = n_users samples (+1 partial batch, pyx:201)
        self._n_chunks = max(1, int(np.ceil(self.n_users / self._chunk)))

        self._train_with_early_stopping(epochs, algorithm_name=self.RECOMMENDER_NAME, **earlystopping_kwargs)
        S2, cv, cix = prune_topk_device(self._full_w(self._S_best), int(self.topK), bool(self.symmetric))
        self.W_sparse = check_matrix(csc_from_col_topk(cv, cix, self.n_items), "csr")
        self._device_w = S2  # the same pruned matrix, already on the device for scoring

    # -- epoch hooks ---------------------------------------------------------
    def _triples(self, n: int):
        """(u, i, j) of ``draw_triples``; on a mesh from this rank's shards
        (collectives every rank calls). One process calls it with its three
        arguments alone, as JAX's draws are passed in."""
        mesh = () if self.mesh_plan is None else (self._lay,)
        return draw_triples(self._tables, n, self._generator, *mesh)

    def _run_epoch(self, num_epoch):
        hyper = dict(learning_rate=self.learning_rate, li_reg=self.lambda_i, lj_reg=self.lambda_j,
                     gamma=self.gamma, beta_1=self.beta_1, beta_2=self.beta_2, sgd_mode=self.sgd_mode,
                     symmetric=self.symmetric)
        triples = tuple(t.view(self._n_chunks, self._chunk) for t in self._triples(self._n_chunks * self._chunk))
        self._state = bpr_epoch(self._state, self._tables.urm, triples, **hyper, lay=self._lay)

    def _full_w(self, W: torch.Tensor) -> torch.Tensor:
        """The full W from this rank's rows (a collective on a mesh)."""
        return self._lay.items.gather(W)

    # -- crash resume (optimizer state and the generator's state); on a mesh
    # the full state, so that a checkpoint resumes on any plan -----------------
    def _checkpoint_state(self):
        return {"state": self._lay.gather(self._state, STATE_ROWS)._asdict(), "generator": self._generator.get_state()}

    def _restore_checkpoint_state(self, state):
        self._state = self._lay.shard(OptState(**{k: v.to(self.device) for k, v in state["state"].items()}),
                                      STATE_ROWS)
        self._generator.set_state(state["generator"])

    def _prepare_model_for_validation(self):
        # validation scores from the pruned W on the device: no [I, I]
        # transfer to the host per validation
        S2, _, _ = prune_topk_device(self._full_w(self._state.W), int(self.topK), bool(self.symmetric))
        self._adopt_device_w(S2)

    def _update_best_model(self):
        self._S_best = self._state.W  # an epoch makes a new W: no copy needed


# the reference's name (SLIM_BPR/Cython/SLIM_BPR_Cython.py:50)
SLIM_BPR_Cython = SLIM_BPR
