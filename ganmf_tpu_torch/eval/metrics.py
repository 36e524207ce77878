"""Vectorized ranking metrics.

Port of ganmf_tpu/eval/metrics.py. One block of users is evaluated across all
cutoffs at once from its ranked top-k (the fused scorer's output, or the
stable top-k of a dense score block) and each user's test pairs (``PairsCSR``): the per-user scalar metrics are summed on the
device and the counter metrics count each listed item per cutoff.
``evaluate_pairs`` computes them. On CUDA tensors it launches K3, the
hand-written kernel of csrc/block_metrics.cu; on CPU tensors it takes the
plain version, ``evaluate_pairs_reference``: the JAX package's computation
over a dense [B, I] block of test ratings, with that block's two reads (a
listed item's rating, the ideal DCG's largest values) made from the pairs
instead. The finalizers run once on the host in float64 and are copied from
the JAX package as they are.

Metric definitions follow the reference's Base/Evaluation/metrics.py,
as documented in the JAX module.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.ops._build import check, load_library, on_device, stream_handle
from ganmf_tpu_torch.utils.profiling import count

#: Metric presentation order = the reference's EvaluatorMetrics enum order.
METRIC_ORDER = [
    "ROC_AUC",
    "PRECISION",
    "PRECISION_RECALL_MIN_DEN",
    "RECALL",
    "MAP",
    "MRR",
    "NDCG",
    "F1",
    "HIT_RATE",
    "ARHR",
    "RMSE",
    "NOVELTY",
    "AVERAGE_POPULARITY",
    "DIVERSITY_MEAN_INTER_LIST",
    "DIVERSITY_HERFINDAHL",
    "COVERAGE_ITEM",
    "COVERAGE_USER",
    "DIVERSITY_GINI",
    "SHANNON_ENTROPY",
]

# the scalar sums produced per cutoff for each batch
SCALAR_FIELDS = [
    "ROC_AUC",
    "PRECISION",
    "PRECISION_RECALL_MIN_DEN",
    "RECALL",
    "MAP",
    "MRR",
    "NDCG",
    "HIT_RATE",
    "ARHR",
    "RMSE",
    "NOVELTY",
    "AVERAGE_POPULARITY",
    "_COVERED_USERS",
]


class BatchStats(NamedTuple):
    """Per-cutoff accumulators for one user batch."""

    scalars: torch.Tensor  # [n_cutoffs, len(SCALAR_FIELDS)] summed over users
    counters: torch.Tensor  # [n_cutoffs, n_items] recommendation counts
    user_ap: torch.Tensor  # [n_cutoffs, B] each user's AP (MAP's term)


class PairsCSR(NamedTuple):
    """Each user's test items in CSR form, as K3 reads them: a row's ids
    ascending and unique (duplicates summed in float32, as the dense block's
    scatter-add sums them; exact zeros dropped), their values, and the row's
    values again in descending order."""

    indptr: torch.Tensor  # [U + 1] int64
    ids: torch.Tensor  # [nnz] int32
    vals: torch.Tensor  # [nnz] float32
    desc: torch.Tensor  # [nnz] float32


def pairs_from_sparse(matrix, device: torch.device) -> PairsCSR:
    """The pairs of a scipy matrix's rows, on ``device``."""
    csr = sps.csr_matrix(matrix, dtype=np.float32, copy=True)
    csr.sum_duplicates()
    csr.eliminate_zeros()
    indptr, ids, vals = (torch.from_numpy(a).to(device) for a in
                         (csr.indptr.astype(np.int64), csr.indices.astype(np.int32), csr.data))
    rows = torch.repeat_interleave(torch.arange(csr.shape[0], device=device), indptr.diff(), output_size=csr.nnz)
    by_val = torch.sort(vals, descending=True, stable=True).indices
    by_row = torch.sort(rows[by_val], stable=True).indices
    return PairsCSR(indptr, ids, vals, vals[by_val][by_row])


def average_precision(relm: torch.Tensor, length: torch.Tensor, n_pos: torch.Tensor) -> torch.Tensor:
    """Each user's average precision, MAP's term: ``relm`` [B, K] is the 0/1
    relevance of the ranked list, zero past its ``length`` [B]; the sum of
    precision at each hit is divided by min(n_pos, length), and a user with
    no list scores 0."""
    positions = torch.arange(relm.shape[1], device=relm.device).float()
    p_at_k = relm * relm.cumsum(1) / (positions + 1.0)
    return torch.where(length > 0, p_at_k.sum(1) / torch.minimum(n_pos, length).clamp(min=1.0), 0.0)


def score_rmse(scores: torch.Tensor, test_ratings: torch.Tensor) -> torch.Tensor:
    """[B] each user's RMSE over the test items with a finite score, from a
    dense score block (reference Evaluator.py:298-299); NaN for a user with
    none."""
    test_mask = (test_ratings != 0).float()
    finite_scores = torch.isfinite(scores)
    fin = test_mask * finite_scores.float()
    sq_err = torch.where(finite_scores, (scores - test_ratings) ** 2, 0.0) * fin
    fin_cnt = fin.sum(1)
    return torch.where(fin_cnt > 0, torch.sqrt(sq_err.sum(1) / fin_cnt.clamp(min=1.0)), float("nan"))


def evaluate_batch_from_topk(
    top_vals: torch.Tensor,  # [B, K] ranked scores (from the fused scorer)
    top_idx: torch.Tensor,  # [B, K] ranked item ids, int64
    test_ratings: torch.Tensor,  # [B, I] test interaction values (0 = none)
    n_pos: torch.Tensor,  # [B] number of test interactions per user
    user_valid: torch.Tensor,  # [B] bool, False for rows not to count
    item_novelty: torch.Tensor,  # [I] -log2(pop/n_inter)/I, 0 for cold items
    pop_normalized: torch.Tensor,  # [I] popularity / max popularity
    user_rmse: torch.Tensor,  # [B] per-user RMSE over the test items
    cutoffs: Sequence[int],
    max_cutoff: int,
) -> BatchStats:
    """Metrics from a precomputed ranking and a dense block of test ratings,
    as the JAX package computes them; the evaluator computes them from the
    test pairs (``evaluate_pairs``)."""
    rel_ratings = torch.gather(test_ratings, 1, top_idx)  # [B, K]
    # per-user ideal relevance ordering for NDCG; only the values are used,
    # so any exact top-k serves
    ideal_ratings = torch.topk(test_ratings, max_cutoff, dim=1).values  # [B, K]
    return _metrics_from_ratings(top_vals, top_idx, rel_ratings, ideal_ratings, n_pos, user_valid, item_novelty,
                                 pop_normalized, user_rmse, cutoffs)


def check_pairs_args(top_vals, top_idx, pairs, uids, n_pos, user_valid, item_novelty, pop_normalized,
                     user_rmse, cutoffs) -> None:
    """Raise unless the inputs are what K3 and its plain version take: only
    shapes, types, layouts and devices are checked, on the host."""
    if top_vals.dim() != 2 or tuple(top_idx.shape) != tuple(top_vals.shape):
        raise ValueError(f"top_vals and top_idx must be [B, K], got {tuple(top_vals.shape)} "
                         f"and {tuple(top_idx.shape)}")
    B = top_vals.shape[0]
    per_user = {"uids": uids, "n_pos": n_pos, "user_valid": user_valid, "user_rmse": user_rmse}
    per_item = {"item_novelty": item_novelty, "pop_normalized": pop_normalized}
    for name, t in {**per_user, **per_item, **pairs._asdict()}.items():
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
    for name, t in per_user.items():
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} rows, the lists {B}")
    if item_novelty.shape != pop_normalized.shape or top_vals.shape[1] > item_novelty.shape[0]:
        raise ValueError(f"item_novelty {tuple(item_novelty.shape)} and pop_normalized "
                         f"{tuple(pop_normalized.shape)} must cover the same items, at least K")
    if not pairs.ids.shape == pairs.vals.shape == pairs.desc.shape:
        raise ValueError("the pairs' ids, vals and desc must have one length")
    dtypes = {"top_vals": (top_vals, torch.float32), "top_idx": (top_idx, torch.int64),
              "uids": (uids, torch.int64), "n_pos": (n_pos, torch.int64), "user_valid": (user_valid, torch.bool),
              "user_rmse": (user_rmse, torch.float32), "item_novelty": (item_novelty, torch.float32),
              "pop_normalized": (pop_normalized, torch.float32), "pairs.indptr": (pairs.indptr, torch.int64),
              "pairs.ids": (pairs.ids, torch.int32), "pairs.vals": (pairs.vals, torch.float32),
              "pairs.desc": (pairs.desc, torch.float32)}
    for name, (t, dtype) in dtypes.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != top_vals.device:
            raise ValueError(f"{name} on {t.device}, top_vals on {top_vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not cutoffs or min(cutoffs) < 1:
        raise ValueError(f"cutoffs must be one or more positive ints, got {cutoffs}")


def evaluate_pairs(top_vals, top_idx, pairs: PairsCSR, uids, n_pos, user_valid, item_novelty, pop_normalized,
                   user_rmse, cutoffs: Sequence[int]) -> BatchStats:
    """Every cutoff's metric sums, item counters and per-user AP of one block
    of users. ``top_vals`` [B, K] float32 and ``top_idx`` [B, K] int64 are
    their ranked lists (-inf: no item at that place), ``uids`` [B] int64
    their rows of ``pairs``, ``n_pos`` [B] int64 their test interactions,
    ``user_valid`` [B] bool False for rows not to count, ``item_novelty``
    and ``pop_normalized`` [I] float32, ``user_rmse`` [B] float32. On CUDA
    tensors it launches K3, on CPU tensors it takes the plain version."""
    cutoffs = tuple(int(c) for c in cutoffs)
    args = (top_vals, top_idx, pairs, uids, n_pos, user_valid, item_novelty, pop_normalized, user_rmse, cutoffs)
    if top_vals.device.type == "cpu":
        check_pairs_args(*args)
        return evaluate_pairs_reference(*args)
    return evaluate_pairs_cuda(*args)


def _block_slots(pairs: PairsCSR, uids: torch.Tensor, width: int):
    """Where the first ``width`` pairs of each user's row lie in ``pairs``:
    [B, width] positions (clamped into range past the row's end) and
    [B, width] bool, True where the row holds a pair."""
    start = pairs.indptr.index_select(0, uids)
    n = pairs.indptr.index_select(0, uids + 1) - start
    slots = torch.arange(width, device=uids.device)[None, :]
    return (start[:, None] + slots).clamp(max=max(pairs.ids.shape[0] - 1, 0)), slots < n[:, None]


def _take(values: torch.Tensor, at: torch.Tensor, inside: torch.Tensor, fill) -> torch.Tensor:
    """``values[at]`` where ``inside``, ``fill`` elsewhere."""
    if not values.numel():
        return torch.full(at.shape, fill, dtype=values.dtype, device=at.device)
    return torch.where(inside, values[at], fill)


def block_pairs(pairs: PairsCSR, uids: torch.Tensor, width: int, pad_id: int = 0):
    """[B, width] the first ``width`` test pairs of each user's row: the ids
    (int64, ascending, ``pad_id`` past the row's end), the values (0 past
    it), and True where the row holds a pair."""
    at, inside = _block_slots(pairs, uids, width)
    return _take(pairs.ids, at, inside, pad_id).long(), _take(pairs.vals, at, inside, 0.0), inside


def _ratings_at(ids: torch.Tensor, vals: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
    """[B, K] the test value of each listed item, 0 where the user has none:
    a search over the block's rows of ids, ascending and padded past each
    row's end with an id no list holds."""
    at = torch.searchsorted(ids, top_idx).clamp(max=ids.shape[1] - 1)
    return torch.where(torch.gather(ids, 1, at) == top_idx, torch.gather(vals, 1, at), 0.0)


def _ideal_values(desc: torch.Tensor, n: torch.Tensor, K: int, n_items: int) -> torch.Tensor:
    """[B, K] each user's K largest test values over all items, zeros for
    the unrated ones, as a dense top-k of the row gives them: the positive
    values in descending order, then the I - n zeros, then the negative
    values. ``desc`` [B, P] holds each row's values descending, 0 past its
    ``n`` [B] pairs."""
    q = (desc > 0).sum(1, keepdim=True)
    zeros = (n_items - n)[:, None]
    j = torch.arange(K, device=desc.device)[None, :]
    src = torch.where(j < q, j, j - zeros).clamp(0, desc.shape[1] - 1)
    return torch.where((j < q) | (j >= q + zeros), torch.gather(desc, 1, src), 0.0)


def evaluate_pairs_reference(top_vals, top_idx, pairs, uids, n_pos, user_valid, item_novelty, pop_normalized,
                             user_rmse, cutoffs) -> BatchStats:
    """The plain version of ``evaluate_pairs``: the dense computation with
    its two reads of the test block made from the block's rows of pairs."""
    I, K = item_novelty.shape[0], top_vals.shape[1]
    n = pairs.indptr.index_select(0, uids + 1) - pairs.indptr.index_select(0, uids)
    at, inside = _block_slots(pairs, uids, max(int(n.max()) if n.numel() else 0, 1))
    ids = _take(pairs.ids, at, inside, I).long()  # I sorts past every id and is never listed
    ratings = _ratings_at(ids, _take(pairs.vals, at, inside, 0.0), top_idx)
    ideal = _ideal_values(_take(pairs.desc, at, inside, 0.0), n, K, I)
    return _metrics_from_ratings(top_vals, top_idx, ratings, ideal, n_pos, user_valid, item_novelty,
                                 pop_normalized, user_rmse, cutoffs)


def _metrics_from_ratings(top_vals, top_idx, rel_ratings, ideal_ratings, n_pos, user_valid, item_novelty,
                          pop_normalized, user_rmse, cutoffs) -> BatchStats:
    """The metrics of ranked lists from each listed item's test rating and
    each user's largest test values ([B, K] both)."""
    I, K = item_novelty.shape[0], top_vals.shape[1]
    dev = top_vals.device
    valid = torch.isfinite(top_vals)  # -inf entries are dropped from rankings
    rel = (rel_ratings != 0).float()

    slots = torch.arange(K, device=dev)
    positions = slots.float()
    log_discount = torch.log(positions + 2.0)  # natural log as in dcg()

    n_pos_f = n_pos.float()
    uvalid = user_valid.float()

    per_cutoff_scalars = []
    per_cutoff_counters = []
    per_cutoff_ap = []

    for c in cutoffs:
        m = valid & (slots < c)  # [B, K] effective-list mask
        mf = m.float()
        relm = rel * mf
        length = mf.sum(1)  # = min(c, n_valid)
        has_list = (length > 0).float()

        hits = relm.sum(1)
        precision = torch.where(length > 0, hits / length.clamp(min=1.0), 0.0)
        min_den = torch.minimum(n_pos_f, length)
        prec_min = torch.where(length > 0, hits / min_den.clamp(min=1.0), 0.0)
        recall = hits / n_pos_f.clamp(min=1.0)

        ap = average_precision(relm, length, n_pos_f)

        rr = (relm / (positions + 1.0)).amax(1)
        arhr = (relm / (positions + 1.0)).sum(1)

        # AUC within the recommended list (metrics.py:576-592)
        negm = mf * (1.0 - rel)
        n_neg = negm.sum(1)
        suffix_neg = n_neg[:, None] - negm.cumsum(1)
        auc_num = (relm * suffix_neg).sum(1)
        auc = torch.where(
            n_neg == 0,
            1.0,
            torch.where(hits > 0, auc_num / (hits * n_neg).clamp(min=1.0), 0.0),
        )

        gains = (torch.pow(2.0, rel_ratings) - 1.0) * mf
        rank_dcg = (gains / log_discount).sum(1)
        ideal_mask = (slots[None, :] < length[:, None]).float()
        ideal_gains = (torch.pow(2.0, ideal_ratings) - 1.0) * ideal_mask
        ideal_dcg = (ideal_gains / log_discount).sum(1)
        ndcg = torch.where(rank_dcg == 0.0, 0.0, rank_dcg / ideal_dcg.clamp(min=1e-30))

        novelty = (item_novelty[top_idx] * mf).sum(1)
        avg_pop = torch.where(
            length > 0,
            (pop_normalized[top_idx] * mf).sum(1) / length.clamp(min=1.0),
            0.0,
        )

        scal = torch.stack(
            [auc, precision, prec_min, recall, ap, rr, ndcg, hits, arhr, user_rmse, novelty, avg_pop, has_list],
            dim=1,
        )  # [B, n_fields]
        # rows not counted are zeroed with where() (not multiplication) so a
        # NaN user_rmse there cannot poison the batch sums
        per_cutoff_scalars.append(torch.where(uvalid[:, None] > 0, scal, 0.0).sum(0))

        counter = torch.zeros(I, dtype=torch.float32, device=dev)
        counter.index_add_(0, top_idx.reshape(-1), (mf * uvalid[:, None]).reshape(-1))
        per_cutoff_counters.append(counter)
        per_cutoff_ap.append(ap)

    return BatchStats(torch.stack(per_cutoff_scalars), torch.stack(per_cutoff_counters), torch.stack(per_cutoff_ap))


def evaluate_pairs_cuda(top_vals, top_idx, pairs, uids, n_pos, user_valid, item_novelty, pop_normalized,
                        user_rmse, cutoffs) -> BatchStats:
    """Launch K3 on CUDA tensors (as ``check_pairs_args`` takes them). It
    launches on the current stream, does not synchronize, and raises when a
    launch fails."""
    check_pairs_args(top_vals, top_idx, pairs, uids, n_pos, user_valid, item_novelty, pop_normalized,
                     user_rmse, cutoffs)
    device = top_vals.device
    if device.type != "cuda":
        raise ValueError(f"evaluate_pairs_cuda takes CUDA tensors, not {device}")
    B, K = top_vals.shape
    I, nc, nf = item_novelty.shape[0], len(cutoffs), len(SCALAR_FIELDS)
    scalars = torch.empty((nc, nf), dtype=torch.float32, device=device)
    counters = torch.zeros((nc, I), dtype=torch.float32, device=device)
    user_ap = torch.empty((nc, B), dtype=torch.float32, device=device)
    if B == 0:
        return BatchStats(scalars.zero_(), counters, user_ap)
    lib = load_library()
    group = lib.ganmf_block_metrics_max_cutoffs()
    rows = lib.ganmf_block_metrics_rows()
    partial = torch.empty(-(-B // rows) * min(nc, group) * nf, dtype=torch.float32, device=device)
    with on_device(device):
        stream = stream_handle(device)
        for g in range(0, nc, group):
            part = cutoffs[g : g + group]
            code = lib.ganmf_block_metrics(
                top_vals.data_ptr(), top_idx.data_ptr(), B, K, uids.data_ptr(), pairs.indptr.data_ptr(),
                pairs.ids.data_ptr(), pairs.vals.data_ptr(), pairs.desc.data_ptr(), n_pos.data_ptr(),
                user_valid.data_ptr(), user_rmse.data_ptr(), item_novelty.data_ptr(), pop_normalized.data_ptr(),
                I, (ctypes.c_int * len(part))(*part), len(part), partial.data_ptr(), scalars[g].data_ptr(),
                counters[g].data_ptr(), user_ap[g].data_ptr(), stream)
            check(lib, code, "K3 block_metrics launch")
            count("k3.launches")
    return BatchStats(scalars, counters, user_ap)


def finalize_counter_metrics(counter: np.ndarray, n_users_eval: int, cutoff: int, n_items: int,
                             n_ignore_items: int = 0, ignore_items: np.ndarray = None):
    """Host-side finalization of the counter-based global metrics.

    Follows the get_metric_value implementations in metrics.py:
    Gini_Diversity(:160-178), Shannon_Entropy(:260-280),
    Diversity_Herfindahl(:210-224), Coverage_Item(:45-46),
    Diversity_MeanInterList(:536-551).
    """
    counter = np.asarray(counter, dtype=np.float64)
    if ignore_items is not None and len(ignore_items):
        keep = np.ones(len(counter), dtype=bool)
        keep[np.asarray(ignore_items, dtype=np.int64)] = False
    else:
        keep = np.ones(len(counter), dtype=bool)

    out = {}

    # Coverage_Item
    out["COVERAGE_ITEM"] = (counter > 0).sum() / (n_items - n_ignore_items)

    # Herfindahl (zero-count items kept, only ignored items removed)
    kept = counter[keep]
    total = kept.sum()
    out["DIVERSITY_HERFINDAHL"] = (1.0 - np.sum((kept / total) ** 2)) if total != 0 else np.nan

    # Gini diversity and Shannon entropy drop zero-occurrence items
    nz = kept[kept > 0]
    if len(nz):
        srt = np.sort(nz)
        n = len(srt)
        index = np.arange(1, n + 1)
        out["DIVERSITY_GINI"] = 2 * np.sum((n + 1 - index) / (n + 1) * srt / srt.sum())
        p = nz / nz.sum()
        out["SHANNON_ENTROPY"] = -np.sum(p * np.log2(p))
    else:
        out["DIVERSITY_GINI"] = np.nan
        out["SHANNON_ENTROPY"] = np.nan

    # MeanInterList diversity (full counter, no ignore filter in reference)
    if n_users_eval == 0:
        out["DIVERSITY_MEAN_INTER_LIST"] = 1.0
    else:
        cooc = np.sum(counter**2) - n_users_eval * cutoff
        pairs = n_users_eval**2 - n_users_eval
        out["DIVERSITY_MEAN_INTER_LIST"] = (pairs - cooc / cutoff) / pairs if pairs else 0.0

    return out


def item_counts(urm_train) -> np.ndarray:
    """[I] float64: each item's stored entries in the training URM, the
    column lengths of its CSC form, counted from the column ids of its CSR
    form (no copy of a CSR matrix)."""
    csr = sps.csr_matrix(urm_train)
    return np.bincount(csr.indices, minlength=csr.shape[1]).astype(np.float64)


def item_novelty_terms(urm_train, n_items: int) -> np.ndarray:
    """Per-item novelty contribution -log2(pop/total)/n_items, 0 for cold
    items (metrics.py:298-341)."""
    pop = item_counts(urm_train)
    total = pop.sum()
    out = np.zeros(n_items, dtype=np.float64)
    warm = pop > 0
    out[warm] = -np.log2(pop[warm] / total) / n_items
    return out


def normalized_popularity(urm_train) -> np.ndarray:
    """Popularity normalized by the most popular item (metrics.py:355-374)."""
    pop = item_counts(urm_train)
    mx = pop.max() if pop.size else 1.0
    return pop / (mx if mx > 0 else 1.0)
