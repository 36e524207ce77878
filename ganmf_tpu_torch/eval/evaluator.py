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
  (ops/simscore.py) scores the block with one float32 product (from
  20,000 items on, bf16 products of W's planes with float32 accumulation, as
  the model's operands say), masks it and ranks it with ``tiled_topk``, and
  its test-pair probe gives the RMSE. An item-based model's seen mask comes
  from its own profile rows, unless its operands are planes;
- every other model takes the dense route of the JAX evaluator
  (:209-222,496-535, without the mesh): ``score_device`` gives the masked
  [B, I] block, a stable top-k ranks it, and the block's dense test rows
  give the RMSE.

Whatever the route, a block's metrics come from its ranked lists and its
users' test pairs in CSR form (``evaluate_pairs``, eval/metrics.py): one
launch of K3 (csrc/block_metrics.cu) on the card, the plain version on the
CPU. No dense block of test ratings is made but for the RMSE of the dense
route and of a model's own columns.

No route is a fallback: a failure raises. K1 and the similarity route
serve plain holdout evaluation only: with a ``diversity_object`` or in
``EvaluatorNegativeItemSample``, which restricts the candidates, every model
takes the dense route, as the JAX evaluator decides.

The constructor takes the JAX package's positional order (URM_test,
cutoff_list, minRatingsPerUser, exclude_seen, diversity_object, ignore_items,
ignore_users, mesh_plan). ``diversity_object`` (an [I, I] item similarity,
dense or sparse) adds DIVERSITY_SIMILARITY after AVERAGE_POPULARITY: each
user's intra-list similarity (JAX :58-82, :565-582). Under
``GANMF_TPU_DEBUG`` a block whose scores hold a NaN raises
``FloatingPointError`` (JAX :479-503).

``mesh_plan`` (a ganmf_tpu_torch.parallel ``MeshPlan``) evaluates as the
JAX evaluator does under a mesh (:422-425, :506-527), as one SPMD program
whose every rank calls ``evaluateRecommender``: the block size is rounded up
to a multiple of ``n_user_shards`` and each data rank takes its part of each
block (padded with user 0 at valid False, as JAX pads). Where the items
divide over the model axis and the largest cutoff fits one shard, each
model rank ranks its item shard (K1 on a factor model's factors, a stable
top-k of its columns of the dense scores otherwise) and ``merge_shard_topk``
merges the candidates; otherwise each model rank ranks every item. A factor
model's tables are fetched once per evaluation (``_factors_device``, which
gathers a mesh-trained model's shards), the test rows stay whole on each
data rank, and the metric sums are reduced over the user axes once, after
the last block. The similarity route is not taken under a plan (JAX :293).

Not ported: the two RESOURCE_EXHAUSTED degrades of the JAX evaluator. An
out-of-memory error raises instead of falling back to another path.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.eval.metrics import (
    METRIC_ORDER,
    SCALAR_FIELDS,
    block_pairs,
    evaluate_pairs,
    finalize_counter_metrics,
    item_novelty_terms,
    normalized_popularity,
    pairs_from_sparse,
    score_rmse,
)
from ganmf_tpu_torch.ops.scorer import masked_topk_scores
from ganmf_tpu_torch.ops.simscore import masked_topk_matmul
from ganmf_tpu_torch.ops.topk import merge_shard_topk, sharded_topk, topk_lowest_index
from ganmf_tpu_torch.utils.debug import debug_enabled
from ganmf_tpu_torch.utils.device import as_device
from ganmf_tpu_torch.utils.profiling import count, root, span, to_device, to_host


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


def _diversity_block(M: torch.Tensor, top_idx: torch.Tensor, top_val: torch.Tensor,
                     cutoffs: Sequence[int], valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n_cutoffs] sums over a block's users of the intra-list diversity (JAX
    :58-82; the reference's per-user, per-position loop,
    Base/Evaluation/metrics.py:405-458): over list positions p < L - 1 and
    every other position j < L, M[item_p, item_j], divided by L (L - 1);
    0 for lists of one item and rows not ``valid``. -inf scores rank last, so
    a row's finite prefix is its list. The [B, c, c] block is gathered from M directly."""
    finite = torch.isfinite(top_val)
    out = []
    for c in cutoffs:
        items = top_idx[:, :c]
        c = items.shape[1]
        L = finite[:, :c].sum(1)
        G = M[items[:, :, None], items[:, None, :]]  # G[b, p, j] = M[items[p], items[j]]
        p = torch.arange(c, device=M.device)
        Lb = L[:, None, None]
        pair = (p[:, None] < Lb - 1) & (p[None, :] < Lb) & (p[:, None] != p[None, :])
        total = torch.where(pair, G, 0.0).sum((1, 2))
        keep = L > 1 if valid is None else (L > 1) & valid
        per_user = torch.where(keep, total / (L * (L - 1)).float().clamp(min=1.0), 0.0)
        out.append(per_user.sum())
    return torch.stack(out)


def _shard_rmse(scores: torch.Tensor, test_rows: torch.Tensor, plan) -> torch.Tensor:
    """Each row's RMSE over its test items with finite scores (metrics.py
    ``score_rmse``'s), from this rank's item columns of both: the squared
    errors and counts summed over the model axis."""
    from ganmf_tpu_torch.parallel import comm

    finite = torch.isfinite(scores)
    fin = (test_rows != 0).float() * finite.float()
    sq_err = torch.where(finite, (scores - test_rows) ** 2, 0.0) * fin
    sums = comm.psum(torch.stack([sq_err.sum(1), fin.sum(1)]), plan, "model")
    return torch.where(sums[1] > 0, torch.sqrt(sums[0] / sums[1].clamp(min=1.0)), float("nan"))


def _raise_on_nan_scores(scores: torch.Tensor, start: int) -> None:
    if bool(torch.isnan(scores).any()):
        raise FloatingPointError(
            f"NaN model scores in evaluation block starting at user index {start} (GANMF_TPU_DEBUG=1)")


def _pow2_crop(max_needed: int, full: int) -> int:
    """Smallest power of two >= max_needed (floor 8), capped at full: the
    per-block gather and scatter width."""
    m = max(8, int(max_needed))
    return min(int(full), 1 << (m - 1).bit_length())


class _Block(NamedTuple):
    """One block of an evaluation: its first place in the evaluation's
    order, its crop widths, and its users, their test counts and its valid
    rows on the device."""

    start: int
    crop_train: int
    crop_test: int
    uids: torch.Tensor
    n_pos: torch.Tensor
    valid: torch.Tensor


class _BlockPlan(NamedTuple):
    """An evaluation's blocks and the item terms of its metrics, built from
    one training matrix. ``urm`` (that matrix, by identity) and ``key`` (the
    block size, this data rank's part of a block and the matrix's stored
    entries, which a fit's in-place ``eliminate_zeros`` changes) are what it
    was built for."""

    urm: object
    key: tuple
    novelty: torch.Tensor
    popularity: torch.Tensor
    blocks: List[_Block]


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
        self._plan = mesh_plan
        # the card unless the caller asks for the CPU (a plan's device by
        # default); raises without a card
        if mesh_plan is not None:
            self.device = as_device(device if device is not None else mesh_plan.device)
            if self.device != mesh_plan.device:
                raise ValueError(f"evaluator on {self.device}, its mesh plan on {mesh_plan.device}")
        else:
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

        # each user's test pairs, O(nnz) on the device: the one device form
        # of the test ratings, which every block's metrics (K3 on the card),
        # pair RMSE and dense test rows read
        self._pairs = pairs_from_sparse(self.URM_test, self.device)
        self._max_test_len = max(1, int(n_ratings.max()) if len(n_ratings) else 1)
        self._n_pos = torch.from_numpy(n_ratings.astype(np.int64)).to(self.device)

        if len(self.ignore_items_ID):
            ign = torch.zeros(self.n_items, dtype=torch.bool, device=self.device)
            ign[torch.from_numpy(self.ignore_items_ID).to(self.device)] = True
            self._ignore_items_mask = ign
        else:
            self._ignore_items_mask = None

        self._block_plan_cache: Optional[_BlockPlan] = None
        self.diversity_object = diversity_object
        self._diversity_dev = None  # the dense [I, I] float32 matrix, made at first use

    def _dense_test_rows(self, uids: torch.Tensor, max_len: int) -> torch.Tensor:
        """[B, I] the test ratings of a block of users (0 = none), for the
        RMSE of the routes that score every item; ``max_len`` is at least
        the block's longest test row."""
        ids, vals, _ = block_pairs(self._pairs, uids, max_len)
        return torch.zeros((uids.shape[0], self.n_items), dtype=torch.float32,
                           device=self.device).scatter_add_(1, ids, vals)

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

    def _restrict_candidates(self, scores: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
        """The hook where ``EvaluatorNegativeItemSample`` masks every
        non-candidate item; the holdout evaluator ranks every item."""
        return scores

    def _plain_holdout(self) -> bool:
        """True when K1 and the similarity route may rank: no diversity
        object and no candidate restriction (JAX :231-245, :283-295)."""
        return (self.diversity_object is None
                and type(self)._restrict_candidates is EvaluatorHoldout._restrict_candidates)

    def _diversity_matrix(self) -> torch.Tensor:
        if self._diversity_dev is None:
            M = self.diversity_object
            dense = M.toarray() if sps.issparse(M) else np.asarray(M)
            self._diversity_dev = torch.from_numpy(np.asarray(dense, dtype=np.float32)).to(self.device)
        return self._diversity_dev

    def _item_split(self) -> Optional[tuple]:
        """[i0, i1) of this model rank's item shard when the blocks rank by
        item shards (JAX :509-513): a plan with more than one model rank that
        divides the items, and the largest cutoff within one shard."""
        plan = self._plan
        if plan is None or plan.n_model == 1 or self.n_items % plan.n_model:
            return None
        width = self.n_items // plan.n_model
        if self.max_cutoff > width:
            return None
        i0 = plan.coords["model"] * width
        return i0, i0 + width

    def _fused_block(self, model, factors, uids: torch.Tensor, max_len: int = None, pair_len: int = None):
        """(top values, top ids, per-user RMSE) of one block through K1, from
        the model's ``factors`` (U, V, cold); with an item split, K1 ranks
        this rank's item shard and the shards' candidates are merged."""
        U, V, cold = factors
        U_b = U.index_select(0, uids)
        seen = self._seen_block(model, uids, max_len=max_len)
        split = self._item_split()
        if split is None:
            vals, idx = masked_topk_scores(U_b, V, seen, k=self.max_cutoff)
        else:
            i0, i1 = split
            vals, idx = masked_topk_scores(U_b, V[i0:i1], seen[:, i0:i1].contiguous(), k=self.max_cutoff,
                                           id_offset=i0)
            vals, idx = merge_shard_topk(vals, idx, self.max_cutoff, self._plan)
        cold_b = cold.index_select(0, uids)
        vals = vals.masked_fill(cold_b[:, None], float("-inf"))

        pair_ids, tvals, pvalid = block_pairs(self._pairs, uids,
                                              pair_len if pair_len is not None else self._max_test_len)
        user_rmse = _pair_rmse(U_b, V, cold_b, pair_ids, tvals, pvalid, torch.gather(seen, 1, pair_ids))
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
            and not isinstance(rows, tuple)
        )
        seen = None if mask_from_rows else self._seen_block(model, uids, max_len=max_len)

        pair_ids, tvals, pvalid = block_pairs(self._pairs, uids,
                                              pair_len if pair_len is not None else self._max_test_len)
        vals, idx, ps, pf = masked_topk_matmul(rows, right, seen, pair_ids, k=self.max_cutoff,
                                               mask_from_rows=mask_from_rows)
        user_rmse = _pair_rmse_from_probe(ps, pf, tvals, pvalid)
        return vals, idx, user_rmse

    # -- main entry ------------------------------------------------------------

    @torch.no_grad()
    def evaluateRecommender(self, recommender_object):
        """(results by cutoff, their string). The call is the root span
        ``eval.evaluate``: ``eval.order`` sets the blocks up, each block is
        an ``eval.block`` span with three children (``eval.prep``,
        ``eval.rank``, ``eval.metrics``), and ``eval.finalize`` reads the sums
        back and finishes the metrics on the host."""
        with root("eval.evaluate"):
            cutoffs = self.cutoff_list
            scalar_acc = torch.zeros((len(cutoffs), len(SCALAR_FIELDS)), dtype=torch.float32,
                                     device=self.device)
            counter_acc = torch.zeros((len(cutoffs), self.n_items), dtype=torch.float32, device=self.device)
            # each block's float32 sums added in float64, as the JAX evaluator
            # adds them into Python floats
            diversity_acc = torch.zeros(len(cutoffs), dtype=torch.float64, device=self.device)
            scored = torch.zeros(1, dtype=torch.float32, device=self.device)  # exact below 2^24 users
            for block, stats, diversity in self._blocks(recommender_object):
                scalar_acc += stats.scalars
                counter_acc += stats.counters
                scored += block.valid.sum()
                if diversity is not None:
                    diversity_acc += diversity
            if self._plan is not None:
                # the data ranks' sums, reduced once after the last block
                from ganmf_tpu_torch.parallel import comm

                axes = self._plan.user_axes
                scalar_acc, counter_acc, scored = (comm.psum(t, self._plan, axes)
                                                   for t in (scalar_acc, counter_acc, scored))
                diversity_acc = comm.psum(diversity_acc, self._plan, axes)

            with span("eval.finalize"):
                # one device-to-host transfer, and the diversity sums'
                packed = to_host(torch.cat([scalar_acc.ravel(), counter_acc.ravel(), scored]),
                                 "eval.sums").numpy()
                diversity_values = to_host(diversity_acc, "eval.diversity").numpy()
                ns = scalar_acc.numel()
                #: the users the last evaluation ranked and scored (all ranks'
                #: under a plan): every one of ``usersToEvaluate`` when nothing
                #: was dropped
                self.users_scored = int(packed[-1])
                return self._finalize(
                    packed[:ns].astype(np.float64).reshape(tuple(scalar_acc.shape)),
                    packed[ns:-1].astype(np.float64).reshape(tuple(counter_acc.shape)),
                    len(self.usersToEvaluate), diversity_values,
                )

    @torch.no_grad()
    def per_user_ap(self, recommender_object, cutoff: int):
        """(users, AP@cutoff of each) for the evaluated users in ascending
        id order: the terms whose mean is ``evaluateRecommender``'s MAP, from
        the same ranking route. Under a plan every rank gets every user's."""
        ci = self.cutoff_list.index(cutoff)
        users, valid, aps = [torch.zeros(0, dtype=torch.int64, device=self.device)], [], []
        for block, stats, _ in self._blocks(recommender_object):
            users.append(block.uids)
            valid.append(block.valid)
            aps.append(stats.user_ap[ci])
        users = torch.cat(users)
        valid = torch.cat(valid) if valid else torch.zeros(0, dtype=torch.bool, device=self.device)
        ap = torch.cat(aps) if aps else torch.zeros(0, device=self.device)
        if self._plan is not None:
            from ganmf_tpu_torch.parallel import comm

            axes = self._plan.user_axes
            users, valid, ap = (comm.all_gather(t, self._plan, axes) for t in (users, valid, ap))
        users, ap = users[valid].cpu().numpy(), ap[valid].cpu().numpy().astype(np.float64)
        order = np.argsort(users, kind="stable")
        return users[order], ap[order]

    def block_rows(self) -> int:
        """Users a block ranks (before a plan rounds it to its data ranks):
        at most 4096 and about 1e8 scores, the evaluated users split into
        equal blocks, rounded up to a multiple of 8."""
        block_size = int(min(4096, max(1, 1e8 / max(self.n_items, 1))))
        n_eval = len(self.usersToEvaluate)
        if n_eval:
            n_blocks = -(-n_eval // block_size)
            per_block = -(-n_eval // n_blocks)
            block_size = min(block_size, -(-per_block // 8) * 8)
        return block_size

    def _block_plan(self, recommender_object, block_size: int, mine: Optional[tuple]) -> _BlockPlan:
        """The blocks of an evaluation of ``recommender_object`` and its
        metrics' item terms, from its training matrix read in place
        (``get_URM_train`` only for an object without ``URM_train``).
        ``mine`` is this data rank's (start, length) in a block under a mesh
        plan. A model's plan serves its later evaluations while its
        ``URM_train`` is the same object with as many stored entries and
        ``block_size`` and ``mine`` are the same; an object without ``URM_train`` gets a new plan every time,
        and none is kept. A build makes two counted uploads: every block's
        users and valid rows, and the item terms."""
        urm = getattr(recommender_object, "URM_train", None)
        key = (block_size, mine, None if urm is None else urm.nnz)
        kept = self._block_plan_cache
        if urm is not None and kept is not None and kept.urm is urm and kept.key == key:
            count("eval.plan.hits")
            return kept
        count("eval.plan.builds")
        keep = urm is not None
        if urm is None:
            urm = recommender_object.get_URM_train()

        users = np.asarray(self.usersToEvaluate, dtype=np.int64)
        # evaluate users in training-profile-length order, so that each block
        # crops its seen-row and test-row scatters to its own length class
        # (power-of-two quantized); the metric sums do not depend on the order
        train_lens = np.ediff1d(urm.indptr).astype(np.int64)
        test_lens = np.ediff1d(self.URM_test.indptr).astype(np.int64)
        if len(users):
            users = users[np.argsort(train_lens[users], kind="stable")]
        # blocks are not padded to block_size but under a mesh plan: the last
        # one is just shorter
        starts = range(0, len(users), block_size)
        chunks, oks, crops = [], [], []
        for start in starts:
            chunk = users[start : start + block_size]
            crops.append((_pow2_crop(train_lens[chunk].max(), train_lens.max()),
                          _pow2_crop(test_lens[chunk].max(), test_lens.max())))
            ok = np.ones(len(chunk), bool)
            if mine is not None:
                lo, part = mine
                ranked = chunk[lo : lo + part]
                chunk = np.concatenate([ranked, np.zeros(part - len(ranked), np.int64)])
                ok = np.arange(part) < len(ranked)
            chunks.append(chunk)
            oks.append(ok)

        packed = np.zeros((2, sum(map(len, chunks))), np.int64)
        if chunks:
            packed[0], packed[1] = np.concatenate(chunks), np.concatenate(oks)
        packed = to_device(packed, self.device, "eval.plan")
        uids, valid = packed[0], packed[1] != 0
        n_pos = self._n_pos.index_select(0, uids)
        blocks, at = [], 0
        for start, chunk, (crop_train, crop_test) in zip(starts, chunks, crops):
            rows = slice(at, at + len(chunk))
            blocks.append(_Block(start, crop_train, crop_test, uids[rows], n_pos[rows], valid[rows]))
            at += len(chunk)
        terms = np.stack([item_novelty_terms(urm, self.n_items), normalized_popularity(urm)]).astype(np.float32)
        novelty, popularity = to_device(terms, self.device, "eval.plan")
        plan = _BlockPlan(urm, key, novelty, popularity, blocks)
        self._block_plan_cache = plan if keep else None
        return plan

    def _blocks(self, recommender_object):
        """(``_Block``, BatchStats, diversity sums or None) of each block of
        the evaluated users (under a plan, this data rank's part of it, padded
        with user 0 at valid False), ranked by K1, by the similarity route or
        from dense scores."""
        if recommender_object.device != self.device:
            raise ValueError(
                f"model on {recommender_object.device}, evaluator on {self.device}")
        if self.ignore_items_flag and hasattr(recommender_object, "set_items_to_ignore"):
            recommender_object.set_items_to_ignore(self.ignore_items_ID)

        with span("eval.order"):
            block_size, mine = self.block_rows(), None
            plan = self._plan
            if plan is not None:
                # each data rank scores an equal part of every block
                block_size = -(-block_size // plan.n_user_shards) * plan.n_user_shards
                part = block_size // plan.n_user_shards
                mine = (plan.axis_index(plan.user_axes) * part, part)
            order = self._block_plan(recommender_object, block_size, mine)
            cutoffs = tuple(self.cutoff_list)
            plain = self._plain_holdout()
            use_k1 = plain and recommender_object._ranks_with_k1()
            use_sim = plain and not use_k1 and plan is None and self._can_fuse_sim(recommender_object)
            # a factor model's tables, fetched once for the whole evaluation
            factors = recommender_object._factors_device() if use_k1 else None
            split = self._item_split()
            # a mesh-trained model that scores this rank's item columns itself
            # (CFGAN, CAAE) hands them over where the blocks rank by item shards
            own_cols = None
            if (split is not None and not use_k1
                    and type(self)._restrict_candidates is EvaluatorHoldout._restrict_candidates
                    and getattr(recommender_object, "mesh_plan", None) is not None):
                own_cols = getattr(recommender_object, "score_device_columns", None)
            debug = debug_enabled()

        for block in order.blocks:
            with span("eval.block"):
                with span("eval.prep"):
                    count("eval.blocks." + self.device.type)
                    start, crop_train, crop_test = block.start, block.crop_train, block.crop_test
                    uids, n_pos, valid = block.uids, block.n_pos, block.valid
                # the ranking and each user's RMSE, from K1, the similarity
                # route, a model's own columns or the dense route's scores
                with span("eval.rank"):
                    if use_k1 or use_sim:
                        if use_k1:
                            top_vals, top_idx, user_rmse = self._fused_block(
                                recommender_object, factors, uids, max_len=crop_train, pair_len=crop_test)
                        else:
                            top_vals, top_idx, user_rmse = self._fused_sim_block(
                                recommender_object, uids, max_len=crop_train, pair_len=crop_test)
                        if debug:
                            _raise_on_nan_scores(top_vals, start)
                        topk = top_vals, top_idx
                    elif own_cols is not None:
                        # a mesh-trained model hands over this rank's item columns
                        i0, i1 = split
                        seen = self._seen_block(recommender_object, uids, max_len=crop_train)[:, i0:i1]
                        own = own_cols(uids, i0, i1).masked_fill(seen, float("-inf"))
                        if debug:
                            _raise_on_nan_scores(own, start)
                        topk = sharded_topk(own, self.max_cutoff, plan)
                        test_rows = self._dense_test_rows(uids, crop_test)
                        user_rmse = _shard_rmse(own, test_rows[:, i0:i1], plan)
                    else:
                        scores = self._score_block(recommender_object, uids, max_len=crop_train)
                        scores = self._restrict_candidates(scores, uids)
                        if debug:
                            _raise_on_nan_scores(scores, start)
                        if split is not None:
                            topk = sharded_topk(scores[:, split[0] : split[1]], self.max_cutoff, plan)
                        else:
                            topk = topk_lowest_index(scores, self.max_cutoff)
                        user_rmse = score_rmse(scores, self._dense_test_rows(uids, crop_test))
                with span("eval.metrics"):
                    # K3 takes float32 lists and RMSEs; a model may score in another type
                    stats = evaluate_pairs(topk[0].float(), topk[1], self._pairs, uids, n_pos, valid,
                                           order.novelty, order.popularity, user_rmse.float(), cutoffs)
                    diversity = None
                    if self.diversity_object is not None and not (use_k1 or use_sim):
                        top_val, top_idx = topk
                        diversity = _diversity_block(self._diversity_matrix(), top_idx, top_val, cutoffs, valid)
            yield block, stats, diversity

        if self.ignore_items_flag and hasattr(recommender_object, "reset_items_to_ignore"):
            recommender_object.reset_items_to_ignore()

    def _finalize(self, scalar_acc, counter_acc, n_eval, diversity_values):
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
                if metric == "AVERAGE_POPULARITY" and self.diversity_object is not None:
                    # the reference's enum order (JAX :614-619)
                    res["DIVERSITY_SIMILARITY"] = diversity_values[ci] / n_eval if n_eval else 0.0

            precision_, recall_ = res["PRECISION"], res["RECALL"]
            if precision_ + recall_ != 0:
                res["F1"] = 2 * (precision_ * recall_) / (precision_ + recall_)

            results_dict[cutoff] = res

        if n_eval == 0:
            print("WARNING: No users had a sufficient number of relevant items")

        return results_dict, get_result_string(results_dict)


class EvaluatorNegativeItemSample(EvaluatorHoldout):
    """Ranks only each user's test items plus a fixed negative sample
    (reference Evaluator.py:419-620; JAX :644-661). The candidate mask is a
    dense [U, I] bool on the device; every model takes the dense route."""

    EVALUATOR_NAME = "EvaluatorNegativeItemSample"

    def __init__(self, URM_test, URM_test_negative, cutoff_list, **kwargs):
        super().__init__(URM_test, cutoff_list, **kwargs)
        candidates = (self.URM_test + sps.csr_matrix(URM_test_negative)).tocsr()
        self._candidate_mask = torch.from_numpy(candidates.toarray() != 0).to(self.device)

    def _restrict_candidates(self, scores: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
        return scores.masked_fill(~self._candidate_mask.index_select(0, uids), float("-inf"))
