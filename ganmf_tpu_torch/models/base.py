"""Recommender base classes.

Port of ganmf_tpu/models/base.py. A recommender holds a CSR ``URM_train``
on the host and its dense copy on its device. ``recommend`` and
``serve_all`` rank on the model's device by one of two routes, chosen by
``_ranks_with_k1`` from the model's type alone:

- K1, the masked top-k scorer (ops/scorer.py), for a factor model (one that
  provides ``_factors_device()``), at any cutoff. The seen items, the
  top-popular and custom items to remove, and the items outside
  ``items_to_compute`` are folded into the scorer's mask.
- The dense route for every other model: ``score_device`` gives the [B, I]
  block, the excluded items go to -inf and a stable top-k ranks it. This is
  the JAX package's route for every model without factors.

Both give the lists of the JAX ``recommend`` and ``serve_all`` (same scores,
ties to the lowest item id). ``recommend_fused`` (:372-399, :642-671) ranks a
factor model through K1 and every other model through ``recommend``: the
lists are ``recommend``'s either way.

``MatrixFactorizationRecommender`` (:514-686) scores U @ V^T from factor
stores that hold host arrays or device tensors, folds the optional bias terms
into the factors and masks cold users; its ``"itemKNN"`` cold-user estimate
adds an item-item model over the item factors and ranks by the dense route
(the estimate scores no user, as in the JAX package: ``score_device``).

``ItemSimilarityRecommender`` and ``UserSimilarityRecommender`` (:688-876)
score URM[u] @ W and W[u] @ URM on the device. W is dense there when its
float32 bytes are within ``_DENSE_W_BYTE_LIMIT``: a fit may leave it only
there (``_adopt_device_w``), and the host CSR ``W_sparse`` is then made when
something reads it. Past the limit W goes to the device as a torch sparse
CSR tensor and is multiplied there; the JAX package multiplies on the host
in that case (:760-764, :853-857). The evaluator and ``recommend_fused`` rank
these models by the similarity route (eval/evaluator.py, ops/simscore.py):
from ``_SIM_SPLIT_MIN_ITEMS`` items on, when every URM value is bf16-exact,
their operands are W's ``_SIM_MATMUL_PASSES`` bf16 planes and the bf16
profile rows or URM, as JAX's (:736-776, :830-872).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.data.device import (
    DeviceURM,
    PaddedCSR,
    csr_rows_dense,
    dense_from_sparse,
    padded_csr_from_sparse,
    padded_rows_dense,
    padded_rows_mask,
    sparse_csr_from_sparse,
)
from ganmf_tpu_torch.ops.scorer import masked_topk_scores
from ganmf_tpu_torch.ops.similarity import csc_from_col_topk
from ganmf_tpu_torch.ops.simscore import masked_topk_matmul, split_bf16_planes
from ganmf_tpu_torch.ops.topk import tiled_topk, topk_lowest_index
from ganmf_tpu_torch.utils.dataio import DataIO
from ganmf_tpu_torch.utils.device import as_device
from ganmf_tpu_torch.utils.profiling import root, span, to_device, to_host


def check_matrix(X, format: str = "csc", dtype=np.float32):
    """Format/dtype coercion (reference Base/Recommender_utils.py:13-45)."""
    if isinstance(X, np.ndarray):
        X = sps.csr_matrix(X, dtype=dtype)
        X.eliminate_zeros()
    converters = {
        "csc": sps.csc_matrix,
        "csr": sps.csr_matrix,
        "coo": sps.coo_matrix,
        "dok": sps.dok_matrix,
        "lil": sps.lil_matrix,
    }
    cls = converters[format]
    if not isinstance(X, cls):
        X = cls(X)
    return X.astype(dtype)


# bf16 planes the similarity family's scoring product splits its float32
# operand W into when the other operand is bf16-exact (JAX :47-52): 2 gives
# about 16 mantissa bits.
_SIM_MATMUL_PASSES = 2

# Catalog size from which that split is taken (JAX :54-62); below it the
# float32 product keeps ``recommend_fused``'s lists equal to ``recommend``'s
# at exact ties.
_SIM_SPLIT_MIN_ITEMS = 20000

# padded host block (elements) above which the sparse column prune runs on
# the device instead (a near-dense column makes the host block quadratic)
_DEVICE_PRUNE_THRESHOLD = 1 << 26


def _device_column_topk(W: sps.spmatrix, k: int, device: torch.device) -> sps.csc_matrix:
    """Column-wise top-k over the stored nonzeros (negatives kept), computed
    on the device (JAX :65-83); only the [n, k] winners come back."""
    n = W.shape[1]
    A = dense_from_sparse(sps.csr_matrix(W), device)
    sent = torch.where(A == 0, float("-inf"), A)
    del A
    vals, idx = tiled_topk(sent.T, min(k, n))  # per column j: its top rows
    return csc_from_col_topk(vals, idx, n)


def row_col_topk(S: torch.Tensor, k: int, l1_normalize: bool = False):
    """The reference's double top-K prune of a square matrix on the device
    (JAX p3alpha.py:38-47, slim_bpr.py:158-180): each row's top k nonzeros
    (-inf keys for exact zeros, so negative weights survive), the rows
    optionally L1-normalized, then each column's top k nonzeros. Returns the
    per-column [n, k] values and row ids, empty slots as 0."""
    n = S.shape[0]
    v, ix = tiled_topk(torch.where(S != 0, S, float("-inf")), k)  # row-wise
    v = torch.where(torch.isfinite(v), v, 0.0)
    S1 = torch.zeros((n, n), dtype=v.dtype, device=v.device).scatter_(1, ix, v)
    if l1_normalize:
        s = torch.sum(torch.abs(S1), dim=1, keepdim=True)
        S1 = torch.where(s > 0, S1 / torch.clamp_min(s, 1e-30), S1)
    sent = torch.where(S1 != 0, S1, float("-inf"))
    del S1
    cv, cix = tiled_topk(sent.T, k)  # column-wise
    return torch.where(torch.isfinite(cv), cv, 0.0), cix


def similarity_matrix_topk(item_weights, k: int = 100, device=None) -> sps.csc_matrix:
    """Column-wise top-K pruning of a square similarity matrix, dense or
    sparse (JAX :86-171; reference Base/Recommender_utils.py:48-115). A large
    sparse matrix with a near-dense column is pruned on ``device`` (the card
    unless the caller asks for the CPU); the rest is the JAX package's host
    code."""
    if item_weights.shape[0] != item_weights.shape[1]:
        raise ValueError(f"the similarity matrix must be square, got {item_weights.shape}")
    n = item_weights.shape[1]
    k = min(k, n)

    if sps.issparse(item_weights) and n <= 8192:
        item_weights = np.asarray(item_weights.todense(), dtype=np.float32)
    elif sps.issparse(item_weights):
        # large sparse: scatter the CSC structure into a padded [n, max_nnz]
        # block with one vectorized write, then one argpartition
        W = check_matrix(item_weights, "csc", np.float32)
        nnz_per_col = np.diff(W.indptr).astype(np.int64)
        max_nnz = int(nnz_per_col.max()) if n else 0
        if max_nnz == 0:
            return sps.csc_matrix((n, n), dtype=np.float32)
        if n * max_nnz > _DEVICE_PRUNE_THRESHOLD:
            return _device_column_topk(W, k, as_device(device))
        col_of = np.repeat(np.arange(n), nnz_per_col)
        slot = np.arange(W.nnz, dtype=np.int64) - np.repeat(W.indptr[:-1], nnz_per_col)
        # padding and stored zeros get a -inf key, so that the top-k runs over
        # the column's nonzeros and keeps negative weights
        # (Recommender_utils.py:98-104)
        padded_v = np.full((n, max_nnz), -np.inf, np.float32)
        padded_r = np.zeros((n, max_nnz), np.int32)
        padded_v[col_of, slot] = W.data
        padded_v[padded_v == 0] = -np.inf
        padded_r[col_of, slot] = W.indices
        if max_nnz > k:
            top = np.argpartition(-padded_v, k - 1, axis=1)[:, :k]
            padded_v = np.take_along_axis(padded_v, top, axis=1)
            padded_r = np.take_along_axis(padded_r, top, axis=1)
        return csc_from_col_topk(padded_v, padded_r, n)

    A = np.asarray(item_weights, dtype=np.float32)
    # zeros -> -inf: selection over the nonzeros, negative weights kept
    A = np.where(A != 0, A, -np.inf)
    if k < n:
        top = np.argpartition(-A, k - 1, axis=0)[:k]  # [k, n] row ids per column
    else:
        top = np.broadcast_to(np.arange(n)[:, None], (n, n))
    return csc_from_col_topk(np.take_along_axis(A, top, axis=0).T, top.T, n)


class Recommender:
    RECOMMENDER_NAME = "Recommender_Base_Class"

    # Above this dense-URM size the [U, I] matrix stays off the device and
    # seen rows are scatter-built per block from padded-CSR storage.
    _DENSE_URM_BYTE_LIMIT = 6 << 30

    def __init__(self, URM_train, *, device: Optional[torch.device] = None):
        """``device`` defaults to the card; without one this raises before any
        work. The CPU runs a model only when it is asked for."""
        self.device = as_device(device)
        self.URM_train = check_matrix(URM_train.copy(), "csr", dtype=np.float32)
        self.URM_train.eliminate_zeros()
        self.n_users, self.n_items = self.URM_train.shape

        self.filterTopPop = False
        self.filterTopPop_ItemsID = np.array([], dtype=np.int64)
        self.items_to_ignore_flag = False
        self.items_to_ignore_ID = np.array([], dtype=np.int64)

        self._cold_user_mask = np.ediff1d(self.URM_train.indptr) == 0
        self._durm: Optional[DeviceURM] = None
        self._seen_padded = None
        self._stream_seen = False  # set by a fit on padded-CSR storage

    # -- device caches ---------------------------------------------------------
    def device_urm(self) -> DeviceURM:
        if self._durm is None:
            self._durm = DeviceURM(self.URM_train, self.device)
        return self._durm

    def _urm_streams(self) -> bool:
        """True when seen rows come from padded-CSR storage: the model trained
        with ``urm_storage="csr"``, or the dense [U, I] URM would not
        reasonably fit on the device."""
        if self._stream_seen:
            return True
        return 4 * self.n_users * self.n_items > self._DENSE_URM_BYTE_LIMIT

    def _padded_urm(self) -> PaddedCSR:
        """The training URM's padded-CSR planes on the device, built once."""
        if self._seen_padded is None:
            self._seen_padded = padded_csr_from_sparse(self.URM_train, self.device)
        return self._seen_padded

    def device_seen_rows(self, uids: torch.Tensor, max_len: int = None) -> torch.Tensor:
        """[B, I] bool seen-mask rows for the given users. ``max_len`` (padded
        storage only) crops the scatter to a row-length bound the caller
        guarantees."""
        if self._urm_streams():
            return padded_rows_mask(self._padded_urm(), uids, self.n_items, max_len=max_len)
        return self.device_urm().mask.index_select(0, uids)

    def device_train_mask(self) -> torch.Tensor:
        """The dense [U, I] bool training mask on the device."""
        return self.device_urm().mask

    def device_profile_rows(self, uids: torch.Tensor, max_len: int = None) -> torch.Tensor:
        """[B, I] float32 rating-profile rows, by ``device_seen_rows``'s
        streaming policy."""
        if self._urm_streams():
            return padded_rows_dense(self._padded_urm(), uids, self.n_items, max_len=max_len)
        return self.device_urm().rows(uids)

    def _urm_values_bf16_exact(self) -> bool:
        """True when every URM value is exactly representable in bfloat16
        (binary data always is; half-star ratings are too)."""
        if getattr(self, "_urm_bf16_exact", None) is None:
            d = torch.from_numpy(np.asarray(self.URM_train.data, dtype=np.float32))
            self._urm_bf16_exact = bool(torch.equal(d.to(torch.bfloat16).float(), d))
        return self._urm_bf16_exact

    def _invalidate_device_cache(self):
        self._durm = None
        self._seen_padded = None

    # -- reference-compatible accessors ---------------------------------------
    def get_URM_train(self):
        return self.URM_train.copy()

    def set_URM_train(self, URM_train_new, **kwargs):
        assert self.URM_train.shape == URM_train_new.shape
        self.URM_train = check_matrix(URM_train_new.copy(), "csr", dtype=np.float32)
        self.URM_train.eliminate_zeros()
        self._cold_user_mask = np.ediff1d(self.URM_train.indptr) == 0
        self._urm_bf16_exact = None
        self._invalidate_device_cache()

    def _get_cold_user_mask(self):
        return self._cold_user_mask

    def set_items_to_ignore(self, items_to_ignore):
        self.items_to_ignore_flag = True
        self.items_to_ignore_ID = np.array(items_to_ignore, dtype=np.int64)

    def reset_items_to_ignore(self):
        self.items_to_ignore_flag = False
        self.items_to_ignore_ID = np.array([], dtype=np.int64)

    def fit(self, *args, **kwargs):
        pass

    # -- scoring ---------------------------------------------------------------
    def score_device(self, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, I] scores on the model's device for a batch of external users.
        Subclasses override."""
        raise NotImplementedError(f"{type(self).__name__} does not override score_device")

    def _compute_item_score(self, user_id_array, items_to_compute=None) -> torch.Tensor:
        """[B, I] scores on the model's device, -inf outside
        ``items_to_compute`` when it is given (JAX base.py:308-317, which
        returns the same block as a numpy array)."""
        scores = self.score_device(self._uids(np.atleast_1d(user_id_array)))
        if items_to_compute is not None:
            keep = torch.zeros(self.n_items, dtype=torch.bool, device=self.device)
            keep[to_device(np.asarray(items_to_compute, dtype=np.int64), self.device, "serve.items")] = True
            scores = scores.masked_fill(~keep, float("-inf"))
        return scores

    def _ranks_with_k1(self) -> bool:
        """The ranking route, chosen from the model's type alone, before any
        launch: a factor model (one that provides ``_factors_device``) ranks
        through K1 at every cutoff; every other model takes the dense route,
        ``score_device`` plus a stable top-k. The dense route is not a
        fallback: a K1 failure raises."""
        return hasattr(self, "_factors_device")

    def _k1_block(self, uids: torch.Tensor, mask: torch.Tensor, k: int):
        """([B, k] vals, [B, k] ids) of a factor model through K1, with the
        cold users' slots at -inf."""
        U, V, cold = self._factors_device()
        vals, ids = masked_topk_scores(U.index_select(0, uids), V, mask, k)
        return vals.masked_fill(cold.index_select(0, uids)[:, None], float("-inf")), ids

    def _uids(self, user_id_array) -> torch.Tensor:
        return to_device(np.asarray(user_id_array, dtype=np.int64), self.device, "serve.ids")

    def _exclusion_mask(self, uids: torch.Tensor, remove_seen_flag: bool,
                        items_to_compute=None, remove_top_pop_flag: bool = False,
                        remove_CustomItems_flag: bool = False) -> torch.Tensor:
        """[B, I] bool: the items that must not be ranked for each user."""
        if remove_seen_flag:
            mask = self.device_seen_rows(uids)  # a fresh tensor: written below
        else:
            mask = torch.zeros((len(uids), self.n_items), dtype=torch.bool, device=self.device)
        columns = []
        if items_to_compute is not None:
            outside = np.ones(self.n_items, dtype=bool)
            outside[np.asarray(items_to_compute, dtype=np.int64)] = False
            columns.append(np.flatnonzero(outside))
        if remove_top_pop_flag:
            columns.append(np.asarray(self.filterTopPop_ItemsID, dtype=np.int64))
        if remove_CustomItems_flag:
            columns.append(np.asarray(self.items_to_ignore_ID, dtype=np.int64))
        if columns:
            cols = to_device(np.concatenate(columns).astype(np.int64), self.device, "serve.columns")
            mask[:, cols] = True
        return mask

    # -- serving ---------------------------------------------------------------
    @torch.no_grad()
    def recommend(
        self,
        user_id_array,
        cutoff: Optional[int] = None,
        remove_seen_flag: bool = True,
        items_to_compute=None,
        remove_top_pop_flag: bool = False,
        remove_CustomItems_flag: bool = False,
        return_scores: bool = False,
    ):
        """Ranked recommendation lists (reference BaseRecommender.py:155-247),
        through K1 or the dense route as ``_ranks_with_k1`` decides. Any
        cutoff works on either device; the default is n_items - 1. Its parts
        are the spans ``serve.ids``, ``serve.mask``, ``serve.rank``,
        ``serve.readback`` and ``serve.lists`` under ``serve.recommend``."""
        with root("serve.recommend"):
            if np.isscalar(user_id_array):
                user_id_array = np.atleast_1d(user_id_array)
                single_user = True
            else:
                user_id_array = np.asarray(user_id_array)
                single_user = False

            if cutoff is None:
                cutoff = self.URM_train.shape[1] - 1
            cutoff = min(cutoff, self.URM_train.shape[1])

            with span("serve.ids"):
                uids = self._uids(user_id_array)
            use_k1 = self._ranks_with_k1()
            scores = None
            if return_scores or not use_k1:
                with span("serve.rank"):
                    scores = self._compute_item_score(user_id_array, items_to_compute=items_to_compute)
                with span("serve.mask"):
                    mask = self._exclusion_mask(uids, remove_seen_flag, None, remove_top_pop_flag,
                                                remove_CustomItems_flag)
                scores = scores.masked_fill(mask, float("-inf"))
            if use_k1:
                with span("serve.mask"):
                    mask = self._exclusion_mask(uids, remove_seen_flag, items_to_compute,
                                                remove_top_pop_flag, remove_CustomItems_flag)
                with span("serve.rank"):
                    vals, ids = self._k1_block(uids, mask, cutoff)
            else:
                with span("serve.rank"):
                    vals, ids = topk_lowest_index(scores, cutoff)
            with span("serve.readback"):
                vals, ids = to_host(vals, "serve.vals").numpy(), to_host(ids, "serve.top_ids").numpy()
            with span("serve.lists"):
                ranking_list = [ids[b][np.isfinite(vals[b])].tolist() for b in range(len(user_id_array))]

            if single_user:
                ranking_list = ranking_list[0]
            if return_scores:
                return ranking_list, to_host(scores, "serve.scores").numpy()
            return ranking_list

    @torch.no_grad()
    def recommend_fused(self, user_id_array, cutoff: int = 20, remove_seen_flag: bool = True,
                        tile=None):
        """The fused-serving call of the JAX package (base.py:372-399,
        :642-671): a factor model ranks through K1, which never writes the
        [B, I] scores, and a cold user gets an empty list; a similarity model
        whose W is dense on the device ranks by ``masked_topk_matmul`` on its
        ``_fused_serving_operands`` (W's bf16 planes from
        ``_SIM_SPLIT_MIN_ITEMS`` items on; below that ``recommend``'s lists);
        every other model returns ``recommend``'s lists. ``tile`` is taken
        for the JAX signature's sake and not used: K1's plan chooses its own
        tiling."""
        ops = getattr(self, "_fused_serving_operands", None)
        if not self._ranks_with_k1() and ops is None:
            return self.recommend(user_id_array, cutoff=cutoff, remove_seen_flag=remove_seen_flag)
        user_id_array = np.atleast_1d(np.asarray(user_id_array))
        uids = self._uids(user_id_array)
        k = min(cutoff, self.n_items)
        if self._ranks_with_k1():
            vals, ids = self._k1_block(uids, self._exclusion_mask(uids, remove_seen_flag), k)
        else:
            operands = ops(uids)
            if operands is None:  # W too large to be dense on the device
                return self.recommend(user_id_array, cutoff=cutoff, remove_seen_flag=remove_seen_flag)
            rows, right = operands
            if remove_seen_flag:
                seen = self.device_seen_rows(uids)
            else:
                seen = torch.zeros((len(user_id_array), self.n_items), dtype=torch.bool, device=self.device)
            pair_ids = torch.zeros((len(user_id_array), 1), dtype=torch.int64, device=self.device)  # probe unused
            vals, ids, _, _ = masked_topk_matmul(rows, right, seen, pair_ids, k)
        vals, ids = to_host(vals, "serve.vals").numpy(), to_host(ids, "serve.top_ids").numpy()
        return [ids[b][np.isfinite(vals[b])].tolist() for b in range(len(user_id_array))]

    def _serve_block(self, uids: torch.Tensor, k: int, remove_seen_flag: bool):
        """([B, k] vals, [B, k] ids) of one serve_all block on the dense
        route (JAX base.py:406-412)."""
        scores = self.score_device(uids)
        if remove_seen_flag:
            scores = scores.masked_fill(self.device_seen_rows(uids), float("-inf"))
        return topk_lowest_index(scores, k)

    @torch.no_grad()
    def serve_all(
        self,
        cutoff: int = 20,
        remove_seen_flag: bool = True,
        block: int = 2048,
        user_id_array=None,
    ):
        """Batch serving export: ranked top-``cutoff`` items for every user (or
        ``user_id_array``) as dense ``(item_ids [n, k] int32, scores [n, k]
        f32)`` arrays, ranked ``block`` users at a time through K1 or the dense
        route (``_ranks_with_k1``). Slots that ``recommend()`` would strip
        come back with a -inf score, so ``np.isfinite(scores[u])`` recovers
        its list."""
        uids_np = (
            np.arange(self.n_users, dtype=np.int64)
            if user_id_array is None
            else np.atleast_1d(np.asarray(user_id_array)).astype(np.int64)
        )
        n = len(uids_np)
        k = min(cutoff, self.n_items)
        if n == 0:
            return np.zeros((0, k), dtype=np.int32), np.zeros((0, k), dtype=np.float32)
        B = max(1, min(block, n))
        use_k1 = self._ranks_with_k1()
        all_vals, all_ids = [], []
        for start in range(0, n, B):
            uids = self._uids(uids_np[start : start + B])
            if use_k1:
                vals, ids = self._k1_block(uids, self._exclusion_mask(uids, remove_seen_flag), k)
            else:
                vals, ids = self._serve_block(uids, k, remove_seen_flag)
            all_vals.append(vals)
            all_ids.append(ids)
        # one device-to-host transfer each
        vals = torch.cat(all_vals).cpu().numpy()
        idx = torch.cat(all_ids).to(torch.int32).cpu().numpy()
        return idx, vals

    # -- persistence -------------------------------------------------------------
    def _save_dict(self):
        """Attributes persisted by saveModel; subclasses extend."""
        return {}

    def saveModel(self, folder_path, file_name=None):
        file_name = file_name or self.RECOMMENDER_NAME
        DataIO(folder_path).save_data(file_name, self._save_dict())

    def loadModel(self, folder_path, file_name=None):
        file_name = file_name or self.RECOMMENDER_NAME
        data = DataIO(folder_path).load_data(file_name)
        for name, value in data.items():
            setattr(self, name, value)
        return data


def compute_W_sparse_from_item_latent_factors(ITEM_factors, topK: int = 100, device=None) -> sps.csr_matrix:
    """Item-item dot-product similarity of the item factors, top-K a column
    (JAX :494-511; reference Base/BaseMatrixFactorizationRecommender.py:17-70):
    one float32 product and ``tiled_topk`` on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = as_device(device)
    V = torch.from_numpy(np.array(ITEM_factors, dtype=np.float32)).to(device)
    vals, idx = tiled_topk((V @ V.T).T, min(topK, V.shape[0]))  # per column
    return csc_from_col_topk(vals, idx, V.shape[0]).tocsr()


class MatrixFactorizationRecommender(Recommender):
    """Dot-product scoring from ``USER_factors`` and ``ITEM_factors`` (JAX
    base.py:514-686; reference Base/BaseMatrixFactorizationRecommender.py),
    ranked through K1, with the cold-user estimate of ``set_URM_train``.

    The factor stores take host arrays or device tensors. A fit that builds
    its factors on the device (PureSVD) stores the tensors, and the host copy
    is made the first time something reads the property, so scoring and
    evaluation never pay the transfer."""

    RECOMMENDER_NAME = "BaseMatrixFactorizationRecommender"

    def __init__(self, URM_train, *, device: Optional[torch.device] = None):
        super().__init__(URM_train, device=device)
        self._USER_factors_store = None
        self._ITEM_factors_store = None
        self.use_bias = False
        # rating-prediction biases (reference :118-124), folded into the
        # device factors so that every scoring path gets them from one product
        self.USER_bias = None
        self.ITEM_bias = None
        self.GLOBAL_bias = 0.0
        self._device_factors = None
        self._cold_user_KNN_model_available = False
        self._ItemKNNRecommender = None
        self._warm_user_KNN_mask = None

    @property
    def USER_factors(self) -> Optional[np.ndarray]:
        if isinstance(self._USER_factors_store, torch.Tensor):
            self._USER_factors_store = self._USER_factors_store.detach().cpu().numpy()
        return self._USER_factors_store

    @USER_factors.setter
    def USER_factors(self, value):
        self._USER_factors_store = value
        self._device_factors = None

    @property
    def ITEM_factors(self) -> Optional[np.ndarray]:
        if isinstance(self._ITEM_factors_store, torch.Tensor):
            self._ITEM_factors_store = self._ITEM_factors_store.detach().cpu().numpy()
        return self._ITEM_factors_store

    @ITEM_factors.setter
    def ITEM_factors(self, value):
        self._ITEM_factors_store = value
        self._device_factors = None

    def _on_device(self, x) -> torch.Tensor:
        """A factor store as a contiguous float32 tensor on the device (K1
        takes contiguous factors; a fit may store a transposed view)."""
        if isinstance(x, torch.Tensor):
            return x.detach().to(self.device, torch.float32).contiguous()
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

    def _factors_device(self):
        """(U, V, cold) on the device. With ``use_bias`` the biases fold in as
        [U | bU | 1] @ [V | 1 | bV + g]^T = U V^T + bU + bV + g (JAX
        :567-587), so K1 ranks the biased scores from one product."""
        if self._device_factors is None:
            U = self._on_device(self._USER_factors_store)
            V = self._on_device(self._ITEM_factors_store)
            if self.use_bias and self.USER_bias is not None:
                bU = self._on_device(self.USER_bias).reshape(-1)
                bV = self._on_device(self.ITEM_bias).reshape(-1)
                g = np.asarray(self.GLOBAL_bias, dtype=np.float32).reshape(-1)[0]
                U = torch.cat([U, bU[:, None], torch.ones_like(bU)[:, None]], dim=1)
                V = torch.cat([V, torch.ones_like(bV)[:, None], (bV + torch.tensor(g))[:, None]], dim=1)
            cold = torch.from_numpy(np.asarray(self._cold_user_mask, dtype=bool)).to(self.device)
            self._device_factors = (U, V, cold)
        return self._device_factors

    def _invalidate_device_cache(self):
        super()._invalidate_device_cache()
        self._device_factors = None

    def _ranks_with_k1(self) -> bool:
        """K1, unless the ``"itemKNN"`` cold-user estimate is on: K1 cannot
        fold its item-item rows into the factor product, and the dense route
        ranks them (the JAX evaluator's ``_can_fuse`` says no there too,
        ganmf_tpu/eval/evaluator.py:243)."""
        return not self._cold_user_KNN_model_available

    @torch.no_grad()
    def score_device(self, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, I] scores; cold users' rows are -inf (JAX :606-618). With the
        ``"itemKNN"`` estimate, the users cold for the factors and warm in the
        estimated item-item model take that model's rows."""
        U, V, cold = self._factors_device()
        scores = U.index_select(0, user_ids) @ V.T
        cold_batch = cold.index_select(0, user_ids)
        if self._cold_user_KNN_model_available:
            # JAX's set_URM_train takes both masks from the same URM, so no
            # user is cold and warm at once and the estimate scores no one
            # (ROADMAP §3); its product is made only when someone takes it
            knn_users = np.asarray(self._cold_user_mask, dtype=bool) & self._warm_user_KNN_mask
            if knn_users.any():
                use_knn = torch.from_numpy(knn_users).to(self.device).index_select(0, user_ids)
                knn_scores = self._ItemKNNRecommender.score_device(user_ids)
                scores = torch.where(use_knn[:, None], knn_scores, scores)
                cold_batch = cold_batch & ~use_knn
        return scores.masked_fill(cold_batch[:, None], float("-inf"))

    def set_URM_train(self, URM_train_new, estimate_model_for_cold_users=None, topK: int = 100, **kwargs):
        """Replace the training URM (JAX :620-640). ``"itemKNN"`` fits an
        item-item model on the new URM from the item factors' dot-product
        similarity (top ``topK`` a column); ``"mean_item_factors"`` estimates
        every user's factors as URM @ ITEM_factors / sqrt(profile length)."""
        super().set_URM_train(URM_train_new)
        if estimate_model_for_cold_users == "itemKNN":
            from ganmf_tpu_torch.models.itemknn import ItemKNNCustomSimilarityRecommender

            W_sparse = compute_W_sparse_from_item_latent_factors(self.ITEM_factors, topK=topK, device=self.device)
            self._ItemKNNRecommender = ItemKNNCustomSimilarityRecommender(self.URM_train, device=self.device)
            self._ItemKNNRecommender.fit(W_sparse, topK=topK)
            self._cold_user_KNN_model_available = True
            self._warm_user_KNN_mask = np.ediff1d(self.URM_train.indptr) > 0
        elif estimate_model_for_cold_users == "mean_item_factors":
            profile_length = np.ediff1d(self.URM_train.indptr)
            sqrt_len = np.sqrt(np.maximum(profile_length, 1))
            self.USER_factors = np.asarray(self.URM_train.dot(self.ITEM_factors), dtype=np.float32)
            self.USER_factors /= sqrt_len[:, None]
            self._cold_user_mask = profile_length == 0
            self._invalidate_device_cache()

    def _save_dict(self):
        out = {
            "USER_factors": np.asarray(self.USER_factors),
            "ITEM_factors": np.asarray(self.ITEM_factors),
            "use_bias": bool(self.use_bias),
        }
        if self.use_bias and self.USER_bias is not None:
            # the reference's artifact keys (:217-219)
            out["USER_bias"] = np.asarray(self.USER_bias)
            out["ITEM_bias"] = np.asarray(self.ITEM_bias)
            out["GLOBAL_bias"] = self.GLOBAL_bias
        return out


class _SimilarityMatrixRecommender(Recommender):
    """The W storage the item-based and user-based models share (JAX
    :688-876): ``W_sparse`` on the host, and on the device either the dense W
    (``_w_device``) or, above ``_DENSE_W_BYTE_LIMIT``,
    a sparse CSR form. A dense W adopted from a fit on the device is
    authoritative: the host CSR is made from it when something reads
    ``W_sparse``."""

    _DENSE_W_BYTE_LIMIT = 4 << 30

    def __init__(self, URM_train, *, device: Optional[torch.device] = None):
        super().__init__(URM_train, device=device)
        self._W_sparse_store: Optional[sps.csr_matrix] = None
        self._drop_device_w()

    def _drop_device_w(self):
        self._device_w = None  # dense W; False above the byte limit
        self._device_w_sparse = None  # the sparse CSR form above the limit
        self._device_w_planes = None  # the dense W's bf16 planes

    def _w_device_split(self):
        """The dense W's ``_SIM_MATMUL_PASSES`` bf16 planes, made once (JAX
        :736-748, :830-842); the caller has checked that W is dense on the
        device."""
        if self._device_w_planes is None:
            self._device_w_planes = split_bf16_planes(self._w_device(), _SIM_MATMUL_PASSES)
        return self._device_w_planes

    def _splits_w(self) -> bool:
        """True when the scoring product takes W's bf16 planes: a catalog of
        at least ``_SIM_SPLIT_MIN_ITEMS`` items whose URM values are all
        bf16-exact (JAX :773, :868)."""
        return self.n_items >= _SIM_SPLIT_MIN_ITEMS and self._urm_values_bf16_exact()

    @property
    def W_sparse(self) -> Optional[sps.csr_matrix]:
        if self._W_sparse_store is None and isinstance(self._device_w, torch.Tensor):
            # the nonzeros' positions in row-major order: CSR as they come
            W = self._device_w
            rc = W.nonzero()
            data = W[rc[:, 0], rc[:, 1]].cpu().numpy()
            rc = rc.cpu().numpy()
            self._W_sparse_store = check_matrix(
                sps.csr_matrix((data, (rc[:, 0], rc[:, 1])), shape=tuple(W.shape)), "csr", np.float32)
        return self._W_sparse_store

    @W_sparse.setter
    def W_sparse(self, value):
        self._W_sparse_store = value
        self._drop_device_w()

    def _adopt_device_w(self, W_dev: torch.Tensor):
        """Make a dense W on the device authoritative."""
        self._W_sparse_store = None
        self._drop_device_w()
        self._device_w = W_dev

    def _w_device(self):
        """The dense W on the device, or False when its float32 bytes pass
        ``_DENSE_W_BYTE_LIMIT``."""
        if self._device_w is None:
            n = self._W_sparse_store.shape[0]
            if 4 * n * n <= self._DENSE_W_BYTE_LIMIT:
                self._device_w = dense_from_sparse(sps.csr_matrix(self._W_sparse_store), self.device)
            else:
                self._device_w = False
        return self._device_w

    def _invalidate_device_cache(self):
        super()._invalidate_device_cache()
        _ = self.W_sparse  # keep a device-only W on the host before dropping it
        self._drop_device_w()

    def _save_dict(self):
        return {"W_sparse": check_matrix(self.W_sparse, "csr", np.float32)}


class ItemSimilarityRecommender(_SimilarityMatrixRecommender):
    """Scores = URM[u] @ W (JAX :688-780; reference
    Base/BaseSimilarityMatrixRecommender.py:73-92)."""

    RECOMMENDER_NAME = "BaseItemSimilarityMatrixRecommender"

    @torch.no_grad()
    def score_device(self, user_ids: torch.Tensor) -> torch.Tensor:
        profiles = self.device_profile_rows(user_ids)
        W = self._w_device()
        if W is False:
            # W^T as sparse CSR on the device: (W^T @ profiles^T)^T
            if self._device_w_sparse is None:
                self._device_w_sparse = sparse_csr_from_sparse(self.W_sparse.T, self.device)
            return torch.sparse.mm(self._device_w_sparse, profiles.T).T
        return profiles @ W

    def _fused_serving_operands(self, uids: torch.Tensor, max_len: int = None):
        """(rows, right) of the similarity route (JAX :768-777): the profile
        rows and W, or, where ``_splits_w``, the rows in bf16 and W's bf16
        planes; None above the dense limit."""
        W = self._w_device()
        if W is False:
            return None
        rows = self.device_profile_rows(uids, max_len=max_len)
        if self._splits_w():
            return rows.to(torch.bfloat16), self._w_device_split()
        return rows, W


class UserSimilarityRecommender(_SimilarityMatrixRecommender):
    """Scores = W[u] @ URM (JAX :783-876; reference
    Base/BaseSimilarityMatrixRecommender.py:97-116)."""

    RECOMMENDER_NAME = "BaseUserSimilarityMatrixRecommender"

    @torch.no_grad()
    def score_device(self, user_ids: torch.Tensor) -> torch.Tensor:
        W = self._w_device()
        if W is False:
            # W's rows from its sparse CSR form, then (URM^T @ rows^T)^T
            if self._device_w_sparse is None:
                self._device_w_sparse = (sparse_csr_from_sparse(self.W_sparse, self.device),
                                         sparse_csr_from_sparse(self.URM_train.T, self.device))
            W_csr, urm_t = self._device_w_sparse
            rows = csr_rows_dense(W_csr, user_ids, self.n_users)
            return torch.sparse.mm(urm_t, rows.T).T
        return W.index_select(0, user_ids) @ self.device_urm().dense

    def _fused_serving_operands(self, uids: torch.Tensor, max_len: int = None):
        """(rows, right) (JAX :861-873): W's rows and the dense URM, or,
        where ``_splits_w``, the bf16 planes of W's rows and the dense URM in
        bf16; None above the dense limit. ``max_len`` bounds profile lengths,
        which W's rows are not."""
        W = self._w_device()
        if W is False:
            return None
        if self._splits_w():
            rows = tuple(p.index_select(0, uids) for p in self._w_device_split())
            return rows, self.device_urm().dense.to(torch.bfloat16)
        return W.index_select(0, uids), self.device_urm().dense
