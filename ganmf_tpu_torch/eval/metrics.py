"""Vectorized ranking metrics.

Port of ganmf_tpu/eval/metrics.py. One batch of users is evaluated across all
cutoffs at once from its ranked top-k (the fused scorer's output, or the
stable top-k of a dense score block in ``evaluate_batch``); the
per-user scalar metrics are summed on the device and the counter metrics
update a per-cutoff item counter with a scatter-add. The finalizers run once
on the host in float64 and are copied from the JAX package as they are.

Metric definitions follow the reference's Base/Evaluation/metrics.py,
as documented in the JAX module.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ganmf_tpu_torch.ops.topk import topk_lowest_index

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


def average_precision(relm: torch.Tensor, length: torch.Tensor, n_pos: torch.Tensor) -> torch.Tensor:
    """Each user's average precision, MAP's term: ``relm`` [B, K] is the 0/1
    relevance of the ranked list, zero past its ``length`` [B]; the sum of
    precision at each hit is divided by min(n_pos, length), and a user with
    no list scores 0."""
    positions = torch.arange(relm.shape[1], device=relm.device).float()
    p_at_k = relm * relm.cumsum(1) / (positions + 1.0)
    return torch.where(length > 0, p_at_k.sum(1) / torch.minimum(n_pos, length).clamp(min=1.0), 0.0)


def evaluate_batch(
    scores: torch.Tensor,  # [B, I] seen-masked model scores (-inf = removed)
    test_ratings: torch.Tensor,  # [B, I] test interaction values (0 = none)
    n_pos: torch.Tensor,  # [B] number of test interactions per user
    user_valid: torch.Tensor,  # [B] bool, False for rows not to count
    item_novelty: torch.Tensor,  # [I]
    pop_normalized: torch.Tensor,  # [I]
    cutoffs: Sequence[int],
    max_cutoff: int,
    topk=None,
) -> BatchStats:
    """Metrics from a dense score block (the dense route): the top-k with ties
    to the lowest item id, and the per-user RMSE over the test items from the
    scores themselves (reference Evaluator.py:298-299). ``topk`` is a ranking
    made already (e.g. ``sharded_topk``'s merge over item shards)."""
    top_vals, top_idx = topk if topk is not None else topk_lowest_index(scores, max_cutoff)
    test_mask = (test_ratings != 0).float()
    finite_scores = torch.isfinite(scores)
    fin = test_mask * finite_scores.float()
    sq_err = torch.where(finite_scores, (scores - test_ratings) ** 2, 0.0) * fin
    fin_cnt = fin.sum(1)
    user_rmse = torch.where(
        fin_cnt > 0, torch.sqrt(sq_err.sum(1) / fin_cnt.clamp(min=1.0)), float("nan"))
    return _evaluate_core(
        top_vals, top_idx, test_ratings, n_pos, user_valid, item_novelty,
        pop_normalized, user_rmse, cutoffs, max_cutoff,
    )


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
    """Metrics from a precomputed ranking: the [B, I] score matrix never
    exists in device memory."""
    return _evaluate_core(
        top_vals, top_idx, test_ratings, n_pos, user_valid, item_novelty,
        pop_normalized, user_rmse, cutoffs, max_cutoff,
    )


def _evaluate_core(
    top_vals, top_idx, test_ratings, n_pos, user_valid, item_novelty,
    pop_normalized, user_rmse, cutoffs, K,
) -> BatchStats:
    I = test_ratings.shape[1]
    dev = test_ratings.device
    valid = torch.isfinite(top_vals)  # -inf entries are dropped from rankings

    rel_ratings = torch.gather(test_ratings, 1, top_idx)  # [B, K]
    rel = (rel_ratings != 0).float()

    # per-user ideal relevance ordering for NDCG; only the values are used,
    # so any exact top-k serves
    ideal_ratings = torch.topk(test_ratings, K, dim=1).values  # [B, K]

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


def item_novelty_terms(urm_train, n_items: int) -> np.ndarray:
    """Per-item novelty contribution -log2(pop/total)/n_items, 0 for cold
    items (metrics.py:298-341)."""
    pop = np.ediff1d(urm_train.tocsc().indptr).astype(np.float64)
    total = pop.sum()
    out = np.zeros(n_items, dtype=np.float64)
    warm = pop > 0
    out[warm] = -np.log2(pop[warm] / total) / n_items
    return out


def normalized_popularity(urm_train) -> np.ndarray:
    """Popularity normalized by the most popular item (metrics.py:355-374)."""
    pop = np.ediff1d(urm_train.tocsc().indptr).astype(np.float64)
    mx = pop.max() if pop.size else 1.0
    return pop / (mx if mx > 0 else 1.0)
