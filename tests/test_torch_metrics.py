"""Ranking metrics: the port against ganmf_tpu.eval.metrics.

The same top-k lists, test rows, novelty, popularity and RMSE inputs go
through the JAX ``evaluate_batch_from_topk`` and the port's; the per-cutoff
scalar sums and item counters must agree within 1e-6 (float32 sums taken in
another order).

The evaluator computes a block's metrics from each user's test pairs in CSR
form (``evaluate_pairs``; K3 on the card, its plain version here). The plain
version is held bitwise to ``evaluate_batch_from_topk``, the computation over
a dense [B, I] block of test ratings that the evaluator made before, on
cases that reach every branch of the sparse reads, and to the JAX package's
within 1e-6; an evaluator on the CPU gives bitwise the results_dict of the
dense computation on the K1, similarity and dense routes, with and without a
1 x 1 mesh plan.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from ganmf_tpu.eval import evaluator as jax_evaluator
from ganmf_tpu.eval import metrics as jax_metrics
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.eval import evaluator as torch_evaluator
from ganmf_tpu_torch.eval import metrics as torch_metrics
from ganmf_tpu_torch.models import GANMF, TopPop, init_params
from ganmf_tpu_torch.models.itemknn import ItemKNNCFRecommender
from ganmf_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _batch(seed, B=24, I=70, K=20, explicit=False):
    rng = np.random.RandomState(seed)
    test = (rng.rand(B, I) < 0.1).astype(np.float32)
    if explicit:
        test *= rng.randint(1, 6, size=test.shape).astype(np.float32)
    test[3] = 0.0  # a user with no test items
    n_pos = (test != 0).sum(1).astype(np.int32)
    scores = rng.randn(B, K).astype(np.float32)
    vals = -np.sort(-scores, axis=1)
    vals[5, 12:] = -np.inf  # a short list
    vals[6, :] = -np.inf  # an empty list
    idx = np.stack([rng.permutation(I)[:K] for _ in range(B)]).astype(np.int32)
    valid = np.ones(B, bool)
    valid[-2:] = False  # rows that must not count
    train = sps.csr_matrix((rng.rand(50, I) < 0.2).astype(np.float32))
    novelty = jax_metrics.item_novelty_terms(train, I).astype(np.float32)
    pop = jax_metrics.normalized_popularity(train).astype(np.float32)
    rmse = rng.rand(B).astype(np.float32)
    rmse[-1] = np.nan  # NaN in a row that does not count must not poison sums
    return vals, idx, test, n_pos, valid, novelty, pop, rmse


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_batch_from_topk_matches_jax(seed, explicit):
    vals, idx, test, n_pos, valid, novelty, pop, rmse = _batch(seed, explicit=explicit)
    cutoffs = (5, 10, 20)
    want = jax_metrics.evaluate_batch_from_topk(
        *(jnp.asarray(a) for a in (vals, idx, test, n_pos, valid, novelty, pop, rmse)),
        cutoffs=cutoffs, max_cutoff=20,
    )
    got = torch_metrics.evaluate_batch_from_topk(
        *(torch.from_numpy(a) for a in (vals, idx.astype(np.int64), test, n_pos, valid, novelty, pop, rmse)),
        cutoffs=cutoffs, max_cutoff=20,
    )
    np.testing.assert_allclose(got.scalars.numpy(), np.asarray(want.scalars), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.counters.numpy(), np.asarray(want.counters), rtol=1e-6, atol=1e-6)


def test_uncounted_nan_rows_do_not_poison_sums():
    vals, idx, test, n_pos, valid, novelty, pop, rmse = _batch(2)
    got = torch_metrics.evaluate_batch_from_topk(
        *(torch.from_numpy(a) for a in (vals, idx.astype(np.int64), test, n_pos, valid, novelty, pop, rmse)),
        cutoffs=(5,), max_cutoff=20,
    )
    assert torch.isfinite(got.scalars).all()


def test_host_pieces_are_the_reference_ones():
    assert torch_metrics.METRIC_ORDER == jax_metrics.METRIC_ORDER
    assert torch_metrics.SCALAR_FIELDS == jax_metrics.SCALAR_FIELDS
    rng = np.random.RandomState(4)
    counter = rng.randint(0, 5, 70).astype(np.float64)
    for ignore in (None, np.array([1, 5, 9])):
        kw = dict(n_users_eval=24, cutoff=10, n_items=70,
                  n_ignore_items=0 if ignore is None else len(ignore), ignore_items=ignore)
        assert torch_metrics.finalize_counter_metrics(counter, **kw) == \
            jax_metrics.finalize_counter_metrics(counter, **kw)
    for crop in [(3, 100), (9, 100), (200, 100), (64, 64)]:
        assert torch_evaluator._pow2_crop(*crop) == jax_evaluator._pow2_crop(*crop)
    res = {5: {"MAP": 0.25, "NDCG": 1 / 3}, 10: {"MAP": 0.125, "NDCG": 0.0}}
    assert torch_evaluator.get_result_string(res) == jax_evaluator.get_result_string(res)


def test_item_terms_are_the_references_on_any_sparse_form():
    """Novelty and popularity from the CSR's column ids equal the JAX
    package's from the CSC form, bitwise: on a CSR holding duplicate ids, an
    explicit zero and unsorted rows, on its COO and CSC forms, and with a
    cold item."""
    rng = np.random.RandomState(6)
    dense = (rng.rand(30, 40) < 0.2) * rng.randint(1, 6, (30, 40)).astype(np.float32)
    dense[:, 7] = 0.0  # a cold item
    odd = _shuffled_csr(dense, rng)
    for urm in (sps.csr_matrix(dense), odd, odd.tocoo(), odd.tocsc()):
        np.testing.assert_array_equal(torch_metrics.item_novelty_terms(urm, 40),
                                      jax_metrics.item_novelty_terms(urm, 40))
        np.testing.assert_array_equal(torch_metrics.normalized_popularity(urm),
                                      jax_metrics.normalized_popularity(urm))


def _shuffled_csr(dense, rng, split=True):
    """A CSR of ``dense`` whose rows hold their ids out of order, and (with
    ``split``) some values split into two entries of one id, plus a pair of
    entries that sum to zero: a CSR that is not canonical."""
    indptr, indices, data = [0], [], []
    for row in dense:
        cols = list(np.flatnonzero(row))
        ids, vals = [], []
        for c in cols:
            v = float(row[c])
            if split and rng.rand() < 0.3:
                ids += [c, c]
                vals += [v - 1.0, 1.0]
            else:
                ids.append(c)
                vals.append(v)
        if split and rng.rand() < 0.2:
            free = np.flatnonzero(row == 0)
            c = int(free[rng.randint(len(free))])
            ids += [c, c]
            vals += [2.0, -2.0]
        order = rng.permutation(len(ids))
        indices += [ids[i] for i in order]
        data += [vals[i] for i in order]
        indptr.append(len(indices))
    return sps.csr_matrix((np.array(data, np.float32), np.array(indices, np.int32), np.array(indptr)),
                          shape=dense.shape)


#: name: (ratings, density, K, cutoffs), and what the case changes
PAIR_CASES = {
    "implicit": ("implicit", 0.1, 20, (5, 10, 20)),
    "explicit": ("explicit", 0.1, 20, (5, 10, 20)),
    "negative": ("negative", 0.15, 20, (5, 10, 20)),
    "npos_above_k": ("explicit", 0.6, 20, (5, 10, 20)),
    "short_lists": ("explicit", 0.1, 20, (5, 10, 20)),
    "invalid_nan": ("explicit", 0.1, 20, (5, 10, 20)),
    "ignored_items": ("explicit", 0.2, 20, (5, 10, 20)),
    "cutoff_beyond_list": ("negative", 0.3, 70, (5, 20, 100)),
    "unsorted_duplicates": ("explicit", 0.2, 20, (5, 10, 20)),
}


def _pair_case(name, seed=0, B=24, I=70):
    kind, density, K, cutoffs = PAIR_CASES[name]
    rng = np.random.RandomState(seed)
    test = (rng.rand(B, I) < density).astype(np.float32)
    if kind == "explicit":
        test *= rng.randint(1, 6, size=test.shape)
    elif kind == "negative":
        test *= rng.choice([-3.0, -1.0, 1.0, 2.0, 4.0], size=test.shape)
    test[3] = 0.0  # a user with no test items
    test[4] = np.where(rng.rand(I) < 0.9, test[4] + (test[4] == 0), test[4])  # nearly every item a test item
    vals = -np.sort(-rng.randn(B, K).astype(np.float32), axis=1)
    candidates = np.arange(I)
    if name == "ignored_items":
        candidates = np.setdiff1d(candidates, [1, 2, 30])
        test[:, [1, 2, 30]] = 2.0
    idx = np.stack([rng.permutation(candidates)[:K] for _ in range(B)]).astype(np.int64)
    # lists that hit: each row's first places on its test items where it has them
    for b in range(B):
        hit = np.intersect1d(np.flatnonzero(test[b]), candidates)[:3]
        rest = [i for i in idx[b] if i not in hit]
        idx[b] = np.concatenate([hit, rest])[:K]
    if name == "short_lists":
        vals[5, 12:] = -np.inf
        vals[6, :] = -np.inf
        vals[7, 1:] = -np.inf
    valid = np.ones(B, bool)
    rmse = rng.rand(B).astype(np.float32)
    if name == "invalid_nan":
        valid[[0, 9, B - 1]] = False
        rmse[[9, B - 1]] = np.nan
    csr = _shuffled_csr(test, rng, split=name == "unsorted_duplicates")
    n_pos = np.diff(csr.indptr).astype(np.int64)  # the entries, as the evaluator counts them
    train = sps.csr_matrix((rng.rand(50, I) < 0.2).astype(np.float32))
    novelty = jax_metrics.item_novelty_terms(train, I).astype(np.float32)
    pop = jax_metrics.normalized_popularity(train).astype(np.float32)
    return vals, idx, csr, n_pos, valid, novelty, pop, rmse, cutoffs


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_sparse_pairs_match_the_dense_core(case, seed):
    """The plain version from the test pairs, built as the evaluator builds
    them, is bitwise the dense computation, and agrees with the JAX
    package's."""
    vals, idx, csr, n_pos, valid, novelty, pop, rmse, cutoffs = _pair_case(case, seed)
    dense = csr.toarray().astype(np.float32)  # duplicates summed
    K = vals.shape[1]
    t = {k: torch.from_numpy(a) for k, a in dict(vals=vals, idx=idx, dense=dense, n_pos=n_pos, valid=valid,
                                                 novelty=novelty, pop=pop, rmse=rmse).items()}
    want = torch_metrics.evaluate_batch_from_topk(
        t["vals"], t["idx"], t["dense"], t["n_pos"], t["valid"], t["novelty"], t["pop"], t["rmse"],
        cutoffs=cutoffs, max_cutoff=K)
    got = torch_metrics.evaluate_pairs(t["vals"], t["idx"], torch_metrics.pairs_from_sparse(csr, CPU),
                                       torch.arange(len(vals)), t["n_pos"], t["valid"], t["novelty"], t["pop"],
                                       t["rmse"], cutoffs)
    for field in ("scalars", "counters", "user_ap"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), getattr(want, field).numpy(), field)
    jax_want = jax_metrics.evaluate_batch_from_topk(
        *(jnp.asarray(a) for a in (vals, idx.astype(np.int32), dense, n_pos.astype(np.int32), valid, novelty,
                                   pop, rmse)),
        cutoffs=cutoffs, max_cutoff=K)
    np.testing.assert_allclose(got.scalars.numpy(), np.asarray(jax_want.scalars), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.counters.numpy(), np.asarray(jax_want.counters), rtol=1e-6, atol=1e-6)


def test_pairs_are_canonical_with_values_descending_beside():
    rng = np.random.RandomState(5)
    dense = ((rng.rand(6, 30) < 0.3) * rng.choice([-2.0, 1.0, 3.0], size=(6, 30))).astype(np.float32)
    csr = _shuffled_csr(dense, rng)
    got = torch_metrics.pairs_from_sparse(csr, CPU)
    indptr = got.indptr.numpy()
    np.testing.assert_array_equal(np.diff(indptr), (dense != 0).sum(1))
    for r in range(dense.shape[0]):
        ids = got.ids[indptr[r]:indptr[r + 1]].numpy()
        np.testing.assert_array_equal(ids, np.flatnonzero(dense[r]))
        np.testing.assert_array_equal(got.vals[indptr[r]:indptr[r + 1]].numpy(), dense[r, ids])
        np.testing.assert_array_equal(got.desc[indptr[r]:indptr[r + 1]].numpy(), -np.sort(-dense[r, ids]))


def test_block_pairs_and_dense_rows_come_from_the_pairs():
    """A block's rows of pairs, cropped and padded as the ranking routes
    gather them, and the dense test rows the dense route densifies from
    them, from an out-of-order CSR with split entries."""
    train, test = _route_split()
    ev = EvaluatorHoldout(test, [5], device=CPU)
    dense = test.toarray().astype(np.float32)  # duplicates summed
    uids = torch.tensor([7, 0, 33, 7, 59])
    width = int((dense[uids.numpy()] != 0).sum(1).max())
    np.testing.assert_array_equal(ev._dense_test_rows(uids, width).numpy(), dense[uids.numpy()])
    for w in (width, width + 3, 2):
        ids, vals, inside = torch_metrics.block_pairs(ev._pairs, uids, w, pad_id=-1)
        assert ids.dtype == torch.int64 and ids.shape == vals.shape == inside.shape == (len(uids), w)
        for b, u in enumerate(uids.numpy()):
            want = np.flatnonzero(dense[u])[:w]
            n = len(want)
            np.testing.assert_array_equal(inside[b].numpy(), np.arange(w) < n)
            np.testing.assert_array_equal(ids[b].numpy(), np.concatenate([want, np.full(w - n, -1)]))
            np.testing.assert_array_equal(vals[b].numpy(), np.concatenate([dense[u, want], np.zeros(w - n)]))


def _route_split():
    """Train and explicit test ratings, the test CSR out of order and with
    split entries, as the evaluator may be handed it."""
    rng = np.random.RandomState(11)
    full = (rng.rand(60, 90) < 0.25) * rng.randint(1, 6, size=(60, 90))
    held = rng.rand(60, 90) < 0.3
    train = sps.csr_matrix((full * ~held).astype(np.float32))
    test = _shuffled_csr((full * held).astype(np.float32), rng)
    return train, test


def _route_model(route, train):
    if route in ("k1", "k1_mesh"):
        model = GANMF(train, device=CPU)
        n_rows, n_cols = model._train_matrix().shape
        model.params = init_params(n_rows, n_cols, 8, 16, torch.Generator().manual_seed(3), CPU)
    elif route == "similarity":
        model = ItemKNNCFRecommender(train, device=CPU)
        model.fit(topK=20, shrink=10)
    else:
        model = TopPop(train, device=CPU)
        model.fit()
    return model


@pytest.mark.parametrize("route", ["k1", "similarity", "dense", "k1_mesh", "dense_mesh"])
def test_evaluator_results_as_the_dense_computation_gave_them(route, monkeypatch):
    """Every block's metrics through the test pairs give bitwise the
    results_dict of the dense computation, on each route, with ignored items
    and users."""
    train, test = _route_split()
    model = _route_model(route, train)
    kw = dict(ignore_items=[1, 2, 30], ignore_users=[0, 4], device=CPU)
    if route.endswith("_mesh"):
        kw["mesh_plan"] = make_mesh(device="cpu")
    ev = EvaluatorHoldout(test, [5, 10, 20, 50, 100], **kw)
    ranked = []
    real = torch_evaluator.evaluate_pairs

    def counted(*args):
        ranked.append(int(args[5].sum()))  # the block's valid rows
        return real(*args)

    monkeypatch.setattr(torch_evaluator, "evaluate_pairs", counted)
    got, _ = ev.evaluateRecommender(model)

    def dense_stand_in(top_vals, top_idx, pairs, uids, n_pos, valid, novelty, pop, rmse, cutoffs):
        rows = torch.from_numpy(ev.URM_test[uids.numpy()].toarray().astype(np.float32))
        return torch_metrics.evaluate_batch_from_topk(top_vals, top_idx, rows, n_pos, valid, novelty, pop, rmse,
                                                      cutoffs, top_vals.shape[1])

    monkeypatch.setattr(torch_evaluator, "evaluate_pairs", dense_stand_in)
    want, _ = ev.evaluateRecommender(model)
    assert sum(ranked) == len(ev.usersToEvaluate)
    assert list(got) == list(want)
    for c in want:
        assert list(got[c]) == list(want[c])
        np.testing.assert_equal([got[c][m] for m in want[c]], [want[c][m] for m in want[c]])
