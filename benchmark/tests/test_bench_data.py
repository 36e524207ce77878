"""The seeded generator hits its published counts, gives every seed the same
amount of work, and the model tensors come from the seed alone."""

import json

import numpy as np
import pytest
import torch

from benchmark.data import derive_seed, ganmf_weights, movielens_shaped
from benchmark.registry import ROOT
from benchmark.tests import tiny  # noqa: F401

SMALL = dict(n_users=500, n_items=300, n_ratings=30011, min_per_user=20, max_per_user=200,
             activity_lognormal=[4.0, 1.0], zipf_exponent=0.9, n_clusters=8, cluster_boost=60.0, test_share=0.2)


@pytest.mark.parametrize("config", ["ganmf-ml1m", "ganmf-ml20m"])
def test_published_activities(config):
    spec = json.loads((ROOT / "benchmark/configs" / f"{config}.json").read_text())["data"]
    acts = movielens_shaped.activities(spec)
    assert len(acts) == spec["n_users"] and acts.sum() == spec["n_ratings"]
    assert acts.min() >= spec["min_per_user"] and acts.max() <= spec["max_per_user"]


@pytest.mark.parametrize("seed", [0, 7, (1 << 31) + 5, (1 << 40) + 3])
def test_small_matrix_counts(seed):
    r = movielens_shaped.generate(SMALL, seed, torch.device("cpu"))
    assert r.train.shape == r.test.shape == (500, 300)
    assert r.train.nnz + r.test.nnz == SMALL["n_ratings"]
    both = r.train + r.test
    assert both.max() == 1.0 and both.nnz == SMALL["n_ratings"]  # train and test are disjoint
    per_user = np.diff(both.indptr)
    assert per_user.min() >= 20 and per_user.max() <= 200
    np.testing.assert_array_equal(np.diff(r.test.indptr), np.round(per_user * 0.2).astype(int))
    # every seed: the same activities, in another order
    np.testing.assert_array_equal(np.sort(per_user), movielens_shaped.activities(SMALL))


def test_same_seed_same_data_other_seed_other_data():
    a = movielens_shaped.generate(SMALL, 11, torch.device("cpu"))
    b = movielens_shaped.generate(SMALL, 11, torch.device("cpu"))
    c = movielens_shaped.generate(SMALL, 12, torch.device("cpu"))
    assert (a.train != b.train).nnz == 0 and (a.test != b.test).nnz == 0
    assert (a.train != c.train).nnz > 0


def test_popularity_and_clusters_skew_the_draws():
    r = movielens_shaped.generate(SMALL, 3, torch.device("cpu"))
    both = (r.train + r.test).tocoo()
    uc, ic = r.user_cluster.numpy(), r.item_cluster.numpy()
    in_cluster = (uc[both.row] == ic[both.col]).mean()
    assert in_cluster > 2.0 / SMALL["n_clusters"]  # a uniform draw gives 1/8
    pop = np.sort(np.bincount(both.col, minlength=300))[::-1]
    assert pop[:30].sum() > 2 * pop[-30:].sum()


def test_derive_seed_streams():
    assert derive_seed(5, 0) != derive_seed(5, 1) != derive_seed(6, 0)
    assert 0 <= derive_seed((1 << 63) + 1, 3) < (1 << 63)


def test_weights_from_the_seed():
    uc, ic = torch.arange(40) % 4, torch.arange(30) % 4
    a = ganmf_weights.make(40, 30, 6, 10, uc, ic, 9, torch.device("cpu"))
    b = ganmf_weights.make(40, 30, 6, 10, uc, ic, 9, torch.device("cpu"))
    shapes = [tuple(t.shape) for t in a]
    assert shapes == [(40, 6), (30, 6), (30, 10), (10,), (10, 30), (30,)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    s = a[0] @ a[1].T
    own = (uc[:, None] == ic[None, :])
    assert s[own].mean() > s[~own].mean() + 0.5
