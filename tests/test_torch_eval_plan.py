"""The evaluator's block plan (ganmf_tpu_torch/eval/evaluator.py
``_block_plan``), on the CPU.

An evaluation's users in training-profile-length order, cut into blocks with
their crop widths, their users and valid rows on the device and the metrics'
item terms, is built once for a model's training matrix and serves that
model's later evaluations. Held here: repeated evaluations give bitwise the
results of a fresh evaluator on every route (K1, similarity, dense, a 1 x 1
mesh plan, the negative-item sample, ``per_user_ap``); a model given a new
training matrix, or whose matrix a fit changed in place, gets a new plan; an
object with ``get_URM_train`` alone builds a plan each time and none is
kept; a model's matrix is read in place, never through ``get_URM_train``'s
copy; and the benchmark's reader of the hit share.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from benchmark.registry import Registry
from ganmf_tpu_torch.eval import EvaluatorHoldout, EvaluatorNegativeItemSample
from ganmf_tpu_torch.models import GANMF, TopPop, init_params
from ganmf_tpu_torch.models.base import Recommender
from ganmf_tpu_torch.models.itemknn import ItemKNNCFRecommender
from ganmf_tpu_torch.models.p3alpha import P3alphaRecommender
from ganmf_tpu_torch.parallel import make_mesh
from ganmf_tpu_torch.utils import profiling

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20]
BLOCK = 24  # several blocks of ~100 users, the last one shorter


def _split(seed=5, n_users=100, n_items=70):
    rng = np.random.RandomState(seed)
    full = rng.rand(n_users, n_items) < 0.2
    held = rng.rand(n_users, n_items) < 0.3
    train = sps.csr_matrix((full & ~held).astype(np.float32))
    test = sps.csr_matrix((full & held).astype(np.float32) * rng.randint(1, 6, (n_users, n_items)))
    return train, test


def _model(route, train):
    if route.startswith("k1"):
        model = GANMF(train, device=CPU)
        model.params = init_params(*train.shape, 8, 16, torch.Generator().manual_seed(3), CPU)
    elif route == "similarity":
        model = ItemKNNCFRecommender(train, device=CPU)
        model.fit(topK=20, shrink=10)
    else:
        model = TopPop(train, device=CPU)
        model.fit()
    return model


def _evaluator(route, test):
    if route == "negative_sample":
        negatives = sps.csr_matrix((np.random.RandomState(9).rand(*test.shape) < 0.2).astype(np.float32))
        ev = EvaluatorNegativeItemSample(test, negatives, CUTOFFS, device=CPU)
    else:
        kw = dict(mesh_plan=make_mesh(device="cpu")) if route.endswith("mesh") else {}
        ev = EvaluatorHoldout(test, CUTOFFS, ignore_items=[2, 7], device=CPU, **kw)
    ev.block_rows = lambda: BLOCK
    return ev


def _changes(counts_before):
    after = profiling.counters()
    return {k: after.get(k, 0) - counts_before.get(k, 0) for k in ("eval.plan.builds", "eval.plan.hits")}


def _assert_bitwise(got, want):
    assert list(got) == list(want)
    for c in want:
        assert list(got[c]) == list(want[c])
        np.testing.assert_equal([got[c][m] for m in want[c]], [want[c][m] for m in want[c]])


@pytest.mark.parametrize("route", ["k1", "similarity", "dense", "k1_mesh", "dense_mesh", "negative_sample"])
def test_repeated_evaluations_equal_a_fresh_evaluators(route):
    train, test = _split()
    model = _model(route, train)
    ev = _evaluator(route, test)
    before = profiling.counters()
    runs = [ev.evaluateRecommender(model)[0] for _ in range(3)]
    assert _changes(before) == {"eval.plan.builds": 1, "eval.plan.hits": 2}
    fresh = _evaluator(route, test).evaluateRecommender(model)[0]
    for got in runs:
        _assert_bitwise(got, fresh)
    aps = [ev.per_user_ap(model, 10) for _ in range(2)]
    want_users, want_ap = _evaluator(route, test).per_user_ap(model, 10)
    for users, ap in aps:
        np.testing.assert_array_equal(users, want_users)
        np.testing.assert_array_equal(ap, want_ap)
    assert np.mean(want_ap) * len(want_ap) / len(ev.usersToEvaluate) == pytest.approx(fresh[10]["MAP"], rel=1e-6)


def test_a_new_training_matrix_builds_a_new_plan():
    train, test = _split()
    model = _model("k1", train)
    ev = _evaluator("k1", test)
    ev.evaluateRecommender(model)
    # fewer seen items and other profile lengths: another order and other crops
    thinned = train.tolil()
    thinned[np.arange(0, 100, 3), :] = 0
    model.set_URM_train(sps.csr_matrix(thinned))
    before = profiling.counters()
    got = ev.evaluateRecommender(model)[0]
    again = ev.evaluateRecommender(model)[0]
    assert _changes(before) == {"eval.plan.builds": 1, "eval.plan.hits": 1}
    fresh = _evaluator("k1", test).evaluateRecommender(model)[0]
    _assert_bitwise(got, fresh)
    _assert_bitwise(again, fresh)


class _ScoresOnly:
    """A recommender with ``get_URM_train`` and no ``URM_train``: scores from
    a table, its seen rows from the matrix it hands back."""

    device = CPU

    def __init__(self, train, scores):
        self._train = train
        self._scores = torch.from_numpy(scores)
        self._seen = torch.from_numpy(train.toarray() != 0)

    def get_URM_train(self):
        return self._train.copy()

    def _ranks_with_k1(self):
        return False

    def score_device(self, uids):
        return self._scores.index_select(0, uids)

    def device_seen_rows(self, uids, max_len=None):
        return self._seen.index_select(0, uids)


class _Scores(Recommender):
    def __init__(self, train, scores):
        super().__init__(train, device=CPU)
        self._scores = torch.from_numpy(scores)

    def score_device(self, uids):
        return self._scores.index_select(0, uids)


def test_an_object_without_urm_train_builds_each_time_and_keeps_none():
    train, test = _split()
    scores = np.random.RandomState(4).randn(*train.shape).astype(np.float32)
    ev = _evaluator("dense", test)
    before = profiling.counters()
    runs = [ev.evaluateRecommender(_ScoresOnly(train, scores))[0] for _ in range(2)]
    assert _changes(before) == {"eval.plan.builds": 2, "eval.plan.hits": 0}
    assert ev._block_plan_cache is None
    want = _evaluator("dense", test).evaluateRecommender(_Scores(train, scores))[0]
    for got in runs:
        _assert_bitwise(got, want)


def test_a_models_matrix_is_read_in_place(monkeypatch):
    train, test = _split()
    model = _model("k1", train)
    calls = []
    monkeypatch.setattr(model, "get_URM_train", lambda: calls.append(1) or train.copy())
    ev = _evaluator("k1", test)
    ev.evaluateRecommender(model)
    ev.per_user_ap(model, 5)
    assert calls == []
    assert ev._block_plan_cache.urm is model.URM_train


def test_a_matrix_changed_in_place_builds_a_new_plan():
    """P3alpha's ``min_rating`` drops entries of the model's own matrix in
    place: the next evaluation builds its plan anew (other item terms) and
    equals a fresh evaluator's."""
    train, test = _split()
    train = sps.csr_matrix(train.multiply(np.random.RandomState(2).randint(1, 6, train.shape)).astype(np.float32))
    model = P3alphaRecommender(train, device=CPU)
    model.fit(topK=20, alpha=0.8)
    ev = _evaluator("similarity", test)
    ev.evaluateRecommender(model)
    urm = model.URM_train
    model.fit(topK=20, alpha=0.8, min_rating=3)
    assert model.URM_train is urm and urm.nnz < train.nnz
    before = profiling.counters()
    got = ev.evaluateRecommender(model)[0]
    assert _changes(before) == {"eval.plan.builds": 1, "eval.plan.hits": 0}
    _assert_bitwise(got, _evaluator("similarity", test).evaluateRecommender(model)[0])


def test_plan_hit_share_reader(monkeypatch):
    reader = Registry().reader("eval.plan_hit_share")
    counts = {"eval.plan.builds": 1, "eval.plan.hits": 19, "eval.evaluate.calls": 20}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert reader.read({}) == pytest.approx(95.0)
    counts.update({"eval.plan.builds": 0, "eval.plan.hits": 0})
    assert reader.read({}) is None
    monkeypatch.delattr(profiling, "counters")  # a program without the counters
    assert reader.read({}) is None

