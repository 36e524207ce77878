"""Holdout top-K ranking evaluator.

Port of ``EvaluatorHoldout`` (ganmf_tpu/eval/evaluator.py): users with at
least ``minRatingsPerUser`` test interactions are scored in blocks, seen items
are masked out, rankings are truncated per cutoff and the ~20 metrics are
accumulated on the device; only the finalization runs on the host. It returns
the reference's (results_dict, results_string) pair, with the same metric
order and formatting.

Each block ranks by a route picked from the model before any launch, as the
JAX evaluator's ``_can_fuse`` and ``_can_fuse_sim`` pick it
(ganmf_tpu/eval/evaluator.py:231-306,435-438):

- a factor model (``Recommender._ranks_with_k1``) ranks through the masked
  top-k scorer K1 (ops/scorer.py) at every cutoff. On a CUDA model the
  kernel runs; on a CPU model the scorer takes its plain version;
- an item-based or user-based similarity model whose W is dense on the
  device takes the similarity route (:308-356): ``masked_topk_matmul``
  (ops/simscore.py) scores the block with one float32 product, masks it and
  ranks it with ``tiled_topk``, and its test-pair probe gives the RMSE. An
  item-based model's seen mask comes from its own profile rows;
- every other model takes the dense route of the JAX evaluator
  (:209-222,496-535, without the mesh): ``score_device`` gives the masked
  [B, I] block and ``evaluate_batch`` ranks it with a stable top-k.

No route is a fallback: a failure raises.

The constructor takes the JAX package's positional order (URM_test,
cutoff_list, minRatingsPerUser, exclude_seen, diversity_object, ignore_items,
ignore_users, mesh_plan). ``diversity_object`` and ``mesh_plan`` are not
ported and raise when given.

Not ported: the mesh plan, the diversity object,
``EvaluatorNegativeItemSample``, and the two RESOURCE_EXHAUSTED degrades of
the JAX evaluator. An out-of-memory error raises instead of falling back to
another path.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.data.device import padded_csr_from_sparse, padded_rows_dense
from ganmf_tpu_torch.eval.metrics import (
    METRIC_ORDER,
    SCALAR_FIELDS,
    evaluate_batch,
    evaluate_batch_from_topk,
    finalize_counter_metrics,
    item_novelty_terms,
    normalized_popularity,
)
from ganmf_tpu_torch.ops.scorer import masked_topk_scores
from ganmf_tpu_torch.ops.simscore import masked_topk_matmul
from ganmf_tpu_torch.utils.device import as_device


def _pair_rmse(U_b, V, cold_b, ids, tvals, pvalid, seen_pairs):
    """Per-user RMSE over the user's test items from factor dot products: the
    raw scores the fused ranking does not produce (reference
    Evaluator.py:298-299 semantics, equal to the dense [B, I] computation
    restricted to the test pairs)."""
    ve = V[ids]  # [B, P, K]
    s = torch.einsum("bk,bpk->bp", U_b, ve)
    s = s.masked_fill(cold_b[:, None] | seen_pairs, float("-inf"))
    fin = torch.isfinite(s)
    return _pair_rmse_from_probe(torch.where(fin, s, 0.0), fin.float(), tvals, pvalid)


def _pair_rmse_from_probe(ps, pf, tvals, pvalid):
    """Per-user RMSE from the similarity route's test-pair probe (JAX
    :83-91): ps[b, p] is the masked score at test item p (0 where masked),
    pf[b, p] > 0 where that score was finite."""
    fin = pvalid & (pf > 0)
    sq = torch.where(fin, (ps - tvals) ** 2, 0.0)
    cnt = fin.sum(1).float()
    return torch.where(cnt > 0, torch.sqrt(sq.sum(1) / cnt.clamp(min=1.0)), float("nan"))


def _pow2_crop(max_needed: int, full: int) -> int:
    """Smallest power of two >= max_needed (floor 8), capped at full: the
    per-block gather and scatter width."""
    m = max(8, int(max_needed))
    return min(int(full), 1 << (m - 1).bit_length())


def get_result_string(results_run: Dict, n_decimals: int = 7) -> str:
    """Reference-identical result formatting (Evaluator.py:95-110)."""
    output = ""
    for cutoff in results_run.keys():
        output += "CUTOFF: {} - ".format(cutoff)
        for metric, value in results_run[cutoff].items():
            output += "{}: {:.{n_decimals}f}, ".format(metric, value, n_decimals=n_decimals)
        output += "\n"
    return output


class EvaluatorHoldout:
    """Evaluates on every item (reference EvaluatorHoldout, Evaluator.py:214)."""

    EVALUATOR_NAME = "EvaluatorHoldout"

    def __init__(
        self,
        URM_test,
        cutoff_list: Sequence[int],
        minRatingsPerUser: int = 1,
        exclude_seen: bool = True,
        diversity_object=None,
        ignore_items=None,
        ignore_users=None,
        mesh_plan=None,
        *,
        device: Optional[torch.device] = None,
    ):
        if diversity_object is not None:
            raise NotImplementedError("diversity_object is not ported")
        if mesh_plan is not None:
            raise NotImplementedError("mesh_plan is not ported")
        # the card unless the caller asks for the CPU; raises without a card
        self.device = as_device(device)
        if isinstance(URM_test, list):
            raise ValueError("List of URM_test not supported")

        self.URM_test = sps.csr_matrix(URM_test).copy()
        self.URM_test.eliminate_zeros()
        self.cutoff_list = list(cutoff_list)
        # ranking length is capped by the item count
        self.max_cutoff = min(max(self.cutoff_list), URM_test.shape[1])
        self.minRatingsPerUser = minRatingsPerUser
        self.exclude_seen = exclude_seen

        self.n_users, self.n_items = self.URM_test.shape

        self.ignore_items_flag = ignore_items is not None
        self.ignore_items_ID = np.asarray(ignore_items if ignore_items is not None else [], dtype=np.int64)
        self.ignore_users_ID = np.asarray(ignore_users if ignore_users is not None else [], dtype=np.int64)

        n_ratings = np.ediff1d(self.URM_test.indptr)
        users = np.arange(self.n_users)[n_ratings >= minRatingsPerUser]
        if len(self.ignore_users_ID):
            users = np.array(sorted(set(users.tolist()) - set(self.ignore_users_ID.tolist())))
        self.usersToEvaluate = list(users)

        # test ratings in padded-CSR form, O(nnz) on the device; blocks
        # densify their [B, I] rows by scatter
        self._test_padded = padded_csr_from_sparse(self.URM_test, self.device)
        self._n_pos = torch.from_numpy(n_ratings.astype(np.int64)).to(self.device)

        if len(self.ignore_items_ID):
            ign = torch.zeros(self.n_items, dtype=torch.bool, device=self.device)
            ign[torch.from_numpy(self.ignore_items_ID).to(self.device)] = True
            self._ignore_items_mask = ign
        else:
            self._ignore_items_mask = None

        self._test_pairs = None  # lazy [U, P] padded test (ids, vals, mask)
        self._nov_pop_key = None

    def _padded_test_arrays(self):
        """Padded per-user test pairs for the RMSE gather."""
        if self._test_pairs is None:
            csr = self.URM_test
            U = self.n_users
            nnz = np.diff(csr.indptr)
            P = max(1, int(nnz.max()) if len(nnz) else 1)
            ids = np.zeros((U, P), np.int64)
            vals = np.zeros((U, P), np.float32)
            msk = np.zeros((U, P), bool)
            row_of = np.repeat(np.arange(U), nnz)
            slot = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.indptr[:-1], nnz)
            ids[row_of, slot] = csr.indices
            vals[row_of, slot] = csr.data
            msk[row_of, slot] = True
            self._test_pairs = tuple(torch.from_numpy(a).to(self.device) for a in (ids, vals, msk))
        return self._test_pairs

    def _seen_block(self, model, uids: torch.Tensor, max_len: int = None) -> torch.Tensor:
        """[B, I] bool: the seen and ignored items of a block of users."""
        if self.exclude_seen:
            seen = model.device_seen_rows(uids, max_len=max_len)
        else:
            seen = torch.zeros((len(uids), self.n_items), dtype=torch.bool, device=self.device)
        if self._ignore_items_mask is not None:
            seen = seen | self._ignore_items_mask[None, :]
        return seen

    def _score_block(self, model, uids: torch.Tensor, max_len: int = None) -> torch.Tensor:
        """[B, I] device scores with the seen and ignored items at -inf."""
        return model.score_device(uids).masked_fill(
            self._seen_block(model, uids, max_len=max_len), float("-inf"))

    def _fused_block(self, model, uids: torch.Tensor, max_len: int = None, pair_len: int = None):
        """(top values, top ids, per-user RMSE) of one block through K1."""
        U, V, cold = model._factors_device()
        U_b = U.index_select(0, uids)
        seen = self._seen_block(model, uids, max_len=max_len)
        vals, idx = masked_topk_scores(U_b, V, seen, k=self.max_cutoff)
        cold_b = cold.index_select(0, uids)
        vals = vals.masked_fill(cold_b[:, None], float("-inf"))

        ids, tvals, pvalid = self._padded_test_arrays()
        tp = pair_len if pair_len is not None else ids.shape[1]
        pair_ids = ids.index_select(0, uids)[:, :tp]
        seen_pairs = torch.gather(seen, 1, pair_ids)
        user_rmse = _pair_rmse(
            U_b, V, cold_b, pair_ids,
            tvals.index_select(0, uids)[:, :tp],
            pvalid.index_select(0, uids)[:, :tp], seen_pairs,
        )
        return vals, idx, user_rmse

    def _can_fuse_sim(self, model) -> bool:
        """True for an item-based or user-based similarity model whose W is
        dense on the device (JAX :283-306). A W adopted on the device is
        checked first, so that the host CSR is not made just to decide."""
        from ganmf_tpu_torch.models.base import ItemSimilarityRecommender, UserSimilarityRecommender

        if not isinstance(model, (ItemSimilarityRecommender, UserSimilarityRecommender)):
            return False
        if not isinstance(model._device_w, torch.Tensor) and model.W_sparse is None:
            return False
        return model._w_device() is not False

    def _fused_sim_block(self, model, uids: torch.Tensor, max_len: int = None, pair_len: int = None):
        """(top values, top ids, per-user RMSE) of one block by the
        similarity route (JAX :308-356)."""
        from ganmf_tpu_torch.models.base import ItemSimilarityRecommender

        rows, right = model._fused_serving_operands(uids, max_len=max_len)
        # an item-based model scores with the very profile that defines
        # "seen": the mask comes from the left operand
        mask_from_rows = (
            self.exclude_seen
            and self._ignore_items_mask is None
            and isinstance(model, ItemSimilarityRecommender)
        )
        seen = None if mask_from_rows else self._seen_block(model, uids, max_len=max_len)

        ids, tvals, pvalid = self._padded_test_arrays()
        tp = pair_len if pair_len is not None else ids.shape[1]
        pair_ids = ids.index_select(0, uids)[:, :tp]
        vals, idx, ps, pf = masked_topk_matmul(rows, right, seen, pair_ids, k=self.max_cutoff,
                                               mask_from_rows=mask_from_rows)
        user_rmse = _pair_rmse_from_probe(
            ps, pf, tvals.index_select(0, uids)[:, :tp], pvalid.index_select(0, uids)[:, :tp])
        return vals, idx, user_rmse

    # -- main entry ------------------------------------------------------------

    @torch.no_grad()
    def evaluateRecommender(self, recommender_object):
        cutoffs = self.cutoff_list
        scalar_acc = torch.zeros((len(cutoffs), len(SCALAR_FIELDS)), dtype=torch.float32, device=self.device)
        counter_acc = torch.zeros((len(cutoffs), self.n_items), dtype=torch.float32, device=self.device)
        for _, stats in self._blocks(recommender_object):
            scalar_acc += stats.scalars
            counter_acc += stats.counters

        # one device-to-host transfer
        packed = torch.cat([scalar_acc.ravel(), counter_acc.ravel()]).cpu().numpy()
        ns = scalar_acc.numel()
        return self._finalize(
            packed[:ns].astype(np.float64).reshape(tuple(scalar_acc.shape)),
            packed[ns:].astype(np.float64).reshape(tuple(counter_acc.shape)),
            len(self.usersToEvaluate),
        )

    @torch.no_grad()
    def per_user_ap(self, recommender_object, cutoff: int):
        """(users, AP@cutoff of each) for the evaluated users in ascending
        id order: the terms whose mean is ``evaluateRecommender``'s MAP, from
        the same ranking route."""
        ci = self.cutoff_list.index(cutoff)
        users, aps = [np.zeros(0, np.int64)], []
        for chunk, stats in self._blocks(recommender_object):
            users.append(chunk)
            aps.append(stats.user_ap[ci])
        users = np.concatenate(users)
        ap = torch.cat(aps).cpu().numpy().astype(np.float64) if aps else np.zeros(0)
        order = np.argsort(users, kind="stable")
        return users[order], ap[order]

    def _blocks(self, recommender_object):
        """(users, BatchStats) of each block of the evaluated users, ranked
        by K1, by the similarity route or from dense scores."""
        if recommender_object.device != self.device:
            raise ValueError(
                f"model on {recommender_object.device}, evaluator on {self.device}")
        if self.ignore_items_flag and hasattr(recommender_object, "set_items_to_ignore"):
            recommender_object.set_items_to_ignore(self.ignore_items_ID)

        urm_train = recommender_object.get_URM_train()
        # novelty and popularity depend only on the training URM: keep them
        # across repeated evaluations of the same model
        key_obj = getattr(recommender_object, "URM_train", None)
        if key_obj is None:
            key_obj = urm_train
        if self._nov_pop_key is not key_obj:
            self._nov_pop = tuple(
                torch.from_numpy(a.astype(np.float32)).to(self.device)
                for a in (item_novelty_terms(urm_train, self.n_items), normalized_popularity(urm_train))
            )
            self._nov_pop_key = key_obj
        novelty_terms, pop_norm = self._nov_pop

        # at most 4096 rows per block, and equal blocks over the evaluated
        # users, rounded to a multiple of 8
        block_size = int(min(4096, max(1, 1e8 / max(self.n_items, 1))))
        users = np.asarray(self.usersToEvaluate, dtype=np.int64)
        n_eval = len(users)
        # evaluate users in training-profile-length order, so that each block
        # crops its seen-row and test-row scatters to its own length class
        # (power-of-two quantized); the metric sums do not depend on the order
        train_lens = np.ediff1d(urm_train.indptr).astype(np.int64)
        test_lens = np.ediff1d(self.URM_test.indptr).astype(np.int64)
        if n_eval:
            users = users[np.argsort(train_lens[users], kind="stable")]
            n_blocks = -(-n_eval // block_size)
            per_block = -(-n_eval // n_blocks)
            block_size = min(block_size, -(-per_block // 8) * 8)
        cutoffs = tuple(self.cutoff_list)
        use_k1 = recommender_object._ranks_with_k1()
        use_sim = not use_k1 and self._can_fuse_sim(recommender_object)

        # blocks are not padded to block_size: the last one is just shorter
        for start in range(0, n_eval, block_size):
            chunk = users[start : start + block_size]
            crop_train = _pow2_crop(train_lens[chunk].max(), train_lens.max())
            crop_test = _pow2_crop(test_lens[chunk].max(), test_lens.max())

            uids = torch.from_numpy(chunk).to(self.device)
            test_rows = padded_rows_dense(self._test_padded, uids, self.n_items, max_len=crop_test)
            n_pos = self._n_pos.index_select(0, uids)
            valid = torch.ones(len(chunk), dtype=torch.bool, device=self.device)
            if use_k1 or use_sim:
                block = self._fused_block if use_k1 else self._fused_sim_block
                top_vals, top_idx, user_rmse = block(
                    recommender_object, uids, max_len=crop_train, pair_len=crop_test)
                stats = evaluate_batch_from_topk(
                    top_vals, top_idx, test_rows, n_pos, valid, novelty_terms, pop_norm,
                    user_rmse, cutoffs=cutoffs, max_cutoff=self.max_cutoff,
                )
            else:
                scores = self._score_block(recommender_object, uids, max_len=crop_train)
                stats = evaluate_batch(
                    scores, test_rows, n_pos, valid, novelty_terms, pop_norm,
                    cutoffs=cutoffs, max_cutoff=self.max_cutoff,
                )
            yield chunk, stats

        if self.ignore_items_flag and hasattr(recommender_object, "reset_items_to_ignore"):
            recommender_object.reset_items_to_ignore()

    def _finalize(self, scalar_acc, counter_acc, n_eval):
        results_dict: Dict[int, Dict[str, float]] = {}
        n_ignore_items = len(self.ignore_items_ID)
        n_ignore_users = len(self.ignore_users_ID)

        for ci, cutoff in enumerate(self.cutoff_list):
            sums = dict(zip(SCALAR_FIELDS, scalar_acc[ci]))
            counters = finalize_counter_metrics(
                counter_acc[ci],
                n_users_eval=n_eval,
                cutoff=cutoff,
                n_items=self.n_items,
                n_ignore_items=n_ignore_items,
                ignore_items=self.ignore_items_ID,
            )

            res: Dict[str, float] = {}
            for metric in METRIC_ORDER:
                if metric == "F1":
                    res[metric] = 0.0
                elif metric in sums:
                    res[metric] = sums[metric] / n_eval if n_eval else 0.0
                elif metric == "COVERAGE_USER":
                    res[metric] = (sums["_COVERED_USERS"] / (self.n_users - n_ignore_users)) if self.n_users else 0.0
                elif metric in counters:
                    res[metric] = counters[metric]

            precision_, recall_ = res["PRECISION"], res["RECALL"]
            if precision_ + recall_ != 0:
                res["F1"] = 2 * (precision_ * recall_) / (precision_ + recall_)

            results_dict[cutoff] = res

        if n_eval == 0:
            print("WARNING: No users had a sufficient number of relevant items")

        return results_dict, get_result_string(results_dict)
