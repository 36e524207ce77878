"""Ranking and the holdout metrics, in plain PyTorch and NumPy.

``top_lists`` ranks every unseen item of each user by the factor product
U_u . V_i, in blocks of users, ties to the lower item id. ``holdout_metrics``
computes the evaluator's ~20 metrics at each cutoff from those lists, in
float64 on the host, by the definitions of the reference framework's
Base/Evaluation/metrics.py: per-user precision (hits over the list's
length), precision over min(test items, length), recall, average precision
(over min(test items, length)), reciprocal rank, NDCG (gains 2^r - 1,
discount ln(position + 2), the ideal list of the test ratings), hits,
ARHR, the AUC inside the list, the RMSE of the scores of the test items,
novelty (-log2(popularity / interactions) / items, summed over the list)
and average normalised popularity, averaged over the evaluated users; the
user coverage over all users; and from the count of each item's
appearances, item coverage, Herfindahl, Gini and Shannon diversity and the
mean inter-list diversity; F1 from the mean precision and recall.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sps
import torch

from benchmark.reference import set_tf32

BLOCK_ROWS = 4096

METRICS = ["ROC_AUC", "PRECISION", "PRECISION_RECALL_MIN_DEN", "RECALL", "MAP", "MRR", "NDCG", "F1", "HIT_RATE",
           "ARHR", "RMSE", "NOVELTY", "AVERAGE_POPULARITY", "DIVERSITY_MEAN_INTER_LIST", "DIVERSITY_HERFINDAHL",
           "COVERAGE_ITEM", "COVERAGE_USER", "DIVERSITY_GINI", "SHANNON_ENTROPY"]


def seen_block(train: sps.csr_matrix, users: np.ndarray, device: torch.device) -> torch.Tensor:
    """[B, I] bool: the items each of ``users`` has in ``train``."""
    rows = train[users]
    lens = np.diff(rows.indptr)
    r = torch.from_numpy(np.repeat(np.arange(len(users)), lens)).to(device)
    c = torch.from_numpy(rows.indices.astype(np.int64)).to(device)
    mask = torch.zeros((len(users), train.shape[1]), dtype=torch.bool, device=device)
    mask[r, c] = True
    return mask


def top_lists(U: torch.Tensor, V: torch.Tensor, train: sps.csr_matrix, users: np.ndarray,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """([N, k] scores, [N, k] item ids) of ``users``' unseen items, best
    first, ties to the lower id; -inf past a user's unseen items. The
    product runs in full float32 (a control rounds the operands to TF32
    first)."""
    set_tf32(False)
    vals, ids = [], []
    for lo in range(0, len(users), BLOCK_ROWS):
        chunk = users[lo:lo + BLOCK_ROWS]
        u = torch.from_numpy(chunk.astype(np.int64)).to(U.device)
        s = U.index_select(0, u) @ V.T
        s.masked_fill_(seen_block(train, chunk, U.device), float("-inf"))
        top_v, top_i = torch.topk(s, k, dim=1)
        # ties to the lower id: order by id, then stably by value
        by_id = torch.argsort(top_i, dim=1)
        top_v, top_i = torch.gather(top_v, 1, by_id), torch.gather(top_i, 1, by_id)
        by_val = torch.sort(top_v, dim=1, descending=True, stable=True).indices
        vals.append(torch.gather(top_v, 1, by_val))
        ids.append(torch.gather(top_i, 1, by_val))
    return torch.cat(vals), torch.cat(ids)


def pair_scores(U: torch.Tensor, V: torch.Tensor, users: np.ndarray, items: np.ndarray,
                chunk: int = 1 << 20) -> np.ndarray:
    """U_u . V_i of each (user, item) pair, in full float32."""
    set_tf32(False)
    out = []
    for lo in range(0, len(users), chunk):
        u = torch.from_numpy(users[lo:lo + chunk].astype(np.int64)).to(U.device)
        i = torch.from_numpy(items[lo:lo + chunk].astype(np.int64)).to(U.device)
        a, b = U.index_select(0, u), V.index_select(0, i)
        out.append(torch.bmm(a[:, None, :], b[:, :, None]).view(-1).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def holdout_metrics(ids: np.ndarray, finite: np.ndarray, users: np.ndarray, train: sps.csr_matrix,
                    test: sps.csr_matrix, test_scores: np.ndarray,
                    cutoffs: Sequence[int]) -> Dict[int, Dict[str, float]]:
    """The metrics at each cutoff from the ranked ``ids`` [N, k] of
    ``users`` (``finite`` [N, k]: the slot holds an item), with
    ``test_scores`` the model's score of each stored test entry of ``users``
    in CSR order. Test ratings are the stored values of ``test``."""
    n_users, n_items = train.shape
    N, k = ids.shape
    test_u = test[users]
    n_pos = np.diff(test_u.indptr).astype(np.float64)
    # the rating of each listed item in the user's test row (0: not a test item)
    keys = np.repeat(np.arange(N, dtype=np.int64), np.diff(test_u.indptr)) * n_items + test_u.indices
    order = np.argsort(keys)
    keys, tvals = keys[order], test_u.data.astype(np.float64)[order]
    want = (np.arange(N, dtype=np.int64)[:, None] * n_items + ids).ravel()
    at = np.clip(np.searchsorted(keys, want), 0, max(len(keys) - 1, 0))
    hit = (keys[at] == want) if len(keys) else np.zeros(len(want), bool)
    rel_r = np.where(hit, tvals[at] if len(keys) else 0.0, 0.0).reshape(N, k) * finite
    rel = (rel_r != 0).astype(np.float64)

    # RMSE over each user's test items
    err = np.add.reduceat((test_scores - test_u.data) ** 2, test_u.indptr[:-1]) if test_u.nnz else np.zeros(N)
    rmse = np.sqrt(err / np.maximum(n_pos, 1))

    pop = np.bincount(train.indices, minlength=n_items).astype(np.float64)
    novelty_term = np.where(pop > 0, -np.log2(np.maximum(pop, 1) / pop.sum()) / n_items, 0.0)
    pop_norm = pop / (pop.max() if pop.max() > 0 else 1.0)
    disc = 1.0 / np.log(np.arange(k) + 2.0)
    ideal_r = _test_rows_sorted(test_u, k)

    out = {}
    for c in cutoffs:
        m = finite & (np.arange(k)[None, :] < c)
        mf = m.astype(np.float64)
        r = rel * mf
        L = mf.sum(1)
        hits = r.sum(1)
        has = L > 0
        precision = np.where(has, hits / np.maximum(L, 1), 0.0)
        prec_min = np.where(has, hits / np.maximum(np.minimum(n_pos, L), 1), 0.0)
        recall = hits / np.maximum(n_pos, 1)
        pos = np.arange(k) + 1.0
        ap = np.where(has, (r * np.cumsum(r, 1) / pos).sum(1) / np.maximum(np.minimum(n_pos, L), 1), 0.0)
        rr = (r / pos).max(1)
        arhr = (r / pos).sum(1)
        neg = mf * (1 - rel)
        n_neg = neg.sum(1)
        after = n_neg[:, None] - np.cumsum(neg, 1)
        auc = np.where(n_neg == 0, 1.0, np.where(hits > 0, (r * after).sum(1) / np.maximum(hits * n_neg, 1), 0.0))
        dcg = ((2.0 ** (rel_r * mf) - 1.0) * mf * disc).sum(1)
        ideal_mask = (np.arange(k)[None, :] < L[:, None]).astype(np.float64)
        idcg = ((2.0 ** ideal_r - 1.0) * ideal_mask * disc).sum(1)
        ndcg = np.where(dcg == 0.0, 0.0, dcg / np.maximum(idcg, 1e-30))
        novelty = (novelty_term[ids] * mf).sum(1)
        avg_pop = np.where(has, (pop_norm[ids] * mf).sum(1) / np.maximum(L, 1), 0.0)
        res = {"ROC_AUC": auc.mean(), "PRECISION": precision.mean(), "PRECISION_RECALL_MIN_DEN": prec_min.mean(),
               "RECALL": recall.mean(), "MAP": ap.mean(), "MRR": rr.mean(), "NDCG": ndcg.mean(),
               "HIT_RATE": hits.mean(), "ARHR": arhr.mean(), "RMSE": rmse.mean(), "NOVELTY": novelty.mean(),
               "AVERAGE_POPULARITY": avg_pop.mean(), "COVERAGE_USER": has.sum() / n_users}
        p, rc = res["PRECISION"], res["RECALL"]
        res["F1"] = 2 * p * rc / (p + rc) if p + rc != 0 else 0.0
        counts = np.bincount(ids[m], minlength=n_items).astype(np.float64)
        res.update(_counter_metrics(counts, N, c, n_items))
        out[c] = {name: float(res[name]) for name in METRICS}
    return out


def _test_rows_sorted(test_u: sps.csr_matrix, k: int) -> np.ndarray:
    """[N, k]: each user's k largest test ratings, best first, zero-padded."""
    lens = np.diff(test_u.indptr)
    width = max(int(lens.max()) if len(lens) else 0, k)
    dense = np.zeros((test_u.shape[0], width))
    slot = np.arange(test_u.nnz) - np.repeat(test_u.indptr[:-1], lens)
    dense[np.repeat(np.arange(test_u.shape[0]), lens), slot] = test_u.data
    return -np.sort(-dense, axis=1)[:, :k]


def _counter_metrics(counts: np.ndarray, n_eval: int, cutoff: int, n_items: int) -> Dict[str, float]:
    total = counts.sum()
    nz = np.sort(counts[counts > 0])
    n = len(nz)
    idx = np.arange(1, n + 1)
    p = nz / nz.sum() if n else nz
    pairs = n_eval * n_eval - n_eval
    cooc = (counts ** 2).sum() - n_eval * cutoff
    return {
        "COVERAGE_ITEM": (counts > 0).sum() / n_items,
        "DIVERSITY_HERFINDAHL": 1.0 - ((counts / total) ** 2).sum() if total else float("nan"),
        "DIVERSITY_GINI": 2 * ((n + 1 - idx) / (n + 1) * nz / nz.sum()).sum() if n else float("nan"),
        "SHANNON_ENTROPY": -(p * np.log2(p)).sum() if n else float("nan"),
        "DIVERSITY_MEAN_INTER_LIST": (pairs - cooc / cutoff) / pairs if pairs else 0.0,
    }


def id_gaps(ids: np.ndarray, users: np.ndarray, ref_top: np.ndarray, U: torch.Tensor, V: torch.Tensor,
            train: sps.csr_matrix) -> np.ndarray:
    """For each row of served item ids ``ids`` [N, k] of ``users`` [N], the
    widest gap by which the reference score of its j-th item lies below
    ``ref_top`` [N, k], the reference's j-th best score of that user, over
    the positions, relative to the user's best score; inf for a row with an
    id outside the items, a repeated item or a seen item."""
    N, k = ids.shape
    n_items = train.shape[1]
    if N == 0:
        return np.zeros(0)
    ids = ids.astype(np.int64)
    outside = (ids < 0) | (ids >= n_items)
    safe = np.where(outside, 0, ids)
    srt = np.sort(safe, axis=1)
    bad = outside.any(1) | (srt[:, 1:] == srt[:, :-1]).any(1)
    flat_u = np.repeat(users.astype(np.int64), k)
    sc = pair_scores(U, V, flat_u, safe.ravel()).reshape(N, k)
    # seen: the (user, item) key among the training matrix's, sorted on the device
    dev = U.device
    seen_keys = torch.from_numpy(np.repeat(np.arange(train.shape[0], dtype=np.int64), np.diff(train.indptr))
                                 * n_items + train.indices).to(dev)
    seen_keys = torch.sort(seen_keys).values
    want = torch.from_numpy(flat_u * n_items + safe.ravel()).to(dev)
    at = torch.clamp(torch.searchsorted(seen_keys, want), max=max(len(seen_keys) - 1, 0))
    seen = (seen_keys[at] == want) if len(seen_keys) else torch.zeros_like(want, dtype=torch.bool)
    bad |= seen.view(N, k).any(1).cpu().numpy()
    scale = np.maximum(np.abs(ref_top[:, 0]), 1e-30)
    gaps = np.maximum(0.0, (ref_top - sc).max(1)) / scale
    gaps[bad] = np.inf
    return gaps


def list_gaps(served: List[List[int]], users: np.ndarray, U: torch.Tensor, V: torch.Tensor,
              train: sps.csr_matrix, k: int) -> np.ndarray:
    """``id_gaps`` of served lists against the reference's ranking of their
    users; inf for a list of another length than ``k``."""
    gaps = np.full(len(served), np.inf)
    full = np.array([len(s) == k for s in served], dtype=bool)
    if not full.any():
        return gaps
    ids = np.array([s for s, f in zip(served, full) if f], dtype=np.int64).reshape(-1, k)
    uniq, inv = np.unique(users[full], return_inverse=True)
    ref_v, _ = top_lists(U, V, train, uniq, k)
    gaps[full] = id_gaps(ids, users[full], ref_v.double().cpu().numpy()[inv], U, V, train)
    return gaps
