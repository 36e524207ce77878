"""The port's non-personalized recommenders (models/toppop.py) against the
JAX package's, on the CPU.

TopPop, GlobalEffects and Random rank by the dense route. From the same
training URM: scores equal, ``recommend`` (cutoff 5 and the default) and
``serve_all`` ids equal, with TopPop's many popularity ties going to the
lowest item id in both; Random draws the same scores from one seed. The
evaluation agrees within 1e-6 (float32 metric sums in another order). TopPop's
score block is its popularity row expanded over the users, so no route may
write into it: its version counter and values stay as they were.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import toppop as jtp
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import GlobalEffects, Random, TopPop

CPU = torch.device("cpu")


def _split():
    rng = np.random.RandomState(5)
    dense = (rng.rand(40, 30) < 0.25).astype(np.float32)
    dense *= rng.randint(1, 6, dense.shape).astype(np.float32)  # ratings: GlobalEffects' biases differ
    dense[7] = 0  # a user with no training row
    mask = rng.rand(40, 30) < 0.8
    return sps.csr_matrix(dense * mask), sps.csr_matrix(dense * ~mask)


@pytest.mark.parametrize("name", ["TopPop", "GlobalEffects"])
def test_scores_and_lists_match_jax(name):
    train, test = _split()
    mine = {"TopPop": TopPop, "GlobalEffects": GlobalEffects}[name](train, device=CPU)
    theirs = getattr(jtp, name)(train)
    mine.fit()
    theirs.fit()
    users = np.arange(train.shape[0])
    np.testing.assert_array_equal(mine.score_device(torch.from_numpy(users)).numpy(),
                                  np.asarray(theirs.score_device(users)))
    for cutoff in (5, None):
        assert mine.recommend(users, cutoff=cutoff) == theirs.recommend(users, cutoff=cutoff)
    assert mine.recommend(3, cutoff=4) == theirs.recommend(3, cutoff=4)
    ids, vals = mine.serve_all(cutoff=7, block=16)
    jids, jvals = theirs.serve_all(cutoff=7)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(vals, np.asarray(jvals))
    got, _ = EvaluatorHoldout(test, [2, 5], device=CPU).evaluateRecommender(mine)
    want, _ = JaxEvaluatorHoldout(test, [2, 5]).evaluateRecommender(theirs)
    for c in (2, 5):
        for metric, value in want[c].items():
            assert got[c][metric] == pytest.approx(value, abs=1e-6, nan_ok=True), (c, metric)
    assert sorted(mine._save_dict()) == sorted(theirs._save_dict())
    for key, value in theirs._save_dict().items():
        np.testing.assert_array_equal(mine._save_dict()[key], value)


def test_toppop_ties_go_to_the_lowest_item():
    train, _ = _split()
    model = TopPop(train, device=CPU)
    model.fit()
    pop = model.item_pop
    ranked = model.recommend(0, cutoff=train.shape[1], remove_seen_flag=False)
    assert ranked == sorted(range(train.shape[1]), key=lambda i: (-pop[i], i))
    assert len(set(pop.tolist())) < len(pop)  # the split has ties to break


def test_no_route_writes_into_the_popularity_row():
    train, test = _split()
    model = TopPop(train, device=CPU)
    model.fit()
    row = model._pop_device
    before, version = row.clone(), row._version
    model.recommend(np.arange(5), cutoff=3)
    model.recommend(np.arange(5), return_scores=True, items_to_compute=[1, 2, 3])
    model.recommend_fused(np.arange(5), cutoff=3)
    model.serve_all(cutoff=3, block=8)
    EvaluatorHoldout(test, [5], device=CPU).evaluateRecommender(model)
    assert row._version == version
    assert torch.equal(row, before)


def test_random_draws_the_jax_scores():
    train, test = _split()
    mine, theirs = Random(train, device=CPU), jtp.Random(train)
    mine.fit(random_seed=7)
    theirs.fit(random_seed=7)
    for block in (np.arange(5), np.arange(5, 40)):
        np.testing.assert_array_equal(mine.score_device(torch.from_numpy(block)).numpy(),
                                      np.asarray(theirs.score_device(block)))
    # the same draw sequence through recommend
    assert mine.recommend(np.arange(3), cutoff=5) == theirs.recommend(np.arange(3), cutoff=5)


def test_the_card_is_the_default(monkeypatch):
    train, _ = _split()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TopPop, Random, GlobalEffects):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(train)
