"""The port's NMF, EASE-R and PredefinedList (models/extras.py) against the
JAX package's, on the CPU.

A seeded 90 x 70 binary split with a cold user. Tolerances:

- NMF from JAX's initial W and H (drawn by ``_nmf_multiplicative``'s own
  key splits), 60 Lee-Seung iterations: W and H within rtol 1e-4 / atol 1e-7
  (each iteration's float32 products run in another order and the
  multiplicative steps carry that on), every metric at cutoffs 5/10/20/50
  within 1e-6; the port's own init: JAX's scale, nonnegative, the same from
  the same seed;
- EASE-R's dense W against ``_ease_r_weights``: within 1e-5 of max|B| (a
  float32 Cholesky inverse in another order differs by about cond(G) * eps
  of it), each user's top 50 equal to JAX's but at near ties (JAX's scores
  of the two items within 1e-5 of the largest: at lambda = 1e3 the scores
  crowd, and ROC_AUC@50 moves by 1.4e-4 with the ties); the pruned W
  against ``_ease_r_weights_topk``: ``assert_topk_close`` at rtol 1e-4 plus
  1e-5 of max|B|, every metric within 1e-6; the device prune bitwise equal to the host CSC branch;
- EASE-R's ``mesh_plan`` as JAX's: an object that is no plan fails with
  ``topK`` (AttributeError) and is not read without it; the 1 x 1 plan
  (one model rank) takes the one-device route, bitwise (the sharded build on
  4 ranks: tests/test_torch_parallel_linalg.py);
- PredefinedList's lists equal to JAX's; its scoring raises.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import EASE_R_Recommender as JaxEASE
from ganmf_tpu.models import NMFRecommender as JaxNMF
from ganmf_tpu.models import PredefinedListRecommender as JaxPredefined
from ganmf_tpu.models import extras as jx
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import EASE_R_Recommender, NMFRecommender, PredefinedListRecommender
from ganmf_tpu_torch.models import extras as px
from test_torch_itemknn import assert_metrics_close
from test_torch_similarity import assert_topk_close

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20, 50]


@pytest.fixture(scope="module")
def split():
    rng = np.random.RandomState(6)
    full = (rng.rand(90, 70) < 0.15).astype(np.float32)
    held = (rng.rand(90, 70) < 0.2) & (full != 0)
    train, test = full * ~held, full * held
    train[7] = 0  # a cold user
    return sps.csr_matrix(train), sps.csr_matrix(test)


def _metrics(model, jax_model, test):
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(model)
    want, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jax_model)
    assert_metrics_close(got, want)


def _jax_nmf_init(A, key, K):
    """The initial (W, H) of ``_nmf_multiplicative`` (JAX :32-36)."""
    k1, k2 = jax.random.split(key)
    scale = jnp.sqrt(jnp.mean(A) / K)
    return (np.asarray(jax.random.uniform(k1, (A.shape[0], K)) * scale + 1e-4),
            np.asarray(jax.random.uniform(k2, (K, A.shape[1])) * scale + 1e-4))


def test_nmf_from_jax_init(split):
    train, test = split
    K, n_iter = 6, 60
    jax_model = JaxNMF(train)
    jax_model.fit(num_factors=K, n_iter=n_iter, random_seed=5)
    init = _jax_nmf_init(jnp.asarray(train.toarray()), jax.random.PRNGKey(5), K)
    model = NMFRecommender(train, device=CPU)
    model.fit(num_factors=K, n_iter=n_iter, init=init)
    np.testing.assert_allclose(model.USER_factors, jax_model.USER_factors, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(model.ITEM_factors, jax_model.ITEM_factors, rtol=1e-4, atol=1e-7)
    _metrics(model, jax_model, test)


def test_nmf_own_init(split):
    train, _ = split
    A = torch.from_numpy(train.toarray())
    W, H = px.nmf_init(A, 4, torch.Generator().manual_seed(3))
    scale = float(np.sqrt(train.toarray().mean() / 4))
    for x in (W, H):
        assert float(x.min()) >= 1e-4 and float(x.max()) < scale + 1e-4
        assert abs(float(x.mean()) - (scale / 2 + 1e-4)) < 0.1 * scale
    W2, H2 = px.nmf_init(A, 4, torch.Generator().manual_seed(3))
    assert torch.equal(W, W2) and torch.equal(H, H2)
    model = NMFRecommender(train, device=CPU)
    model.fit(num_factors=4, n_iter=20, random_seed=3)
    again = NMFRecommender(train, device=CPU)
    again.fit(num_factors=4, n_iter=20, random_seed=3)
    assert (model.USER_factors >= 0).all() and (model.ITEM_factors >= 0).all()
    np.testing.assert_array_equal(model.USER_factors, again.USER_factors)


@pytest.mark.parametrize("l2_norm", [10.0, 1e3])
def test_ease_r_dense_w_matches_jax(split, l2_norm):
    train, _ = split
    want = np.asarray(jx._ease_r_weights(jnp.asarray(train.toarray()), l2_norm))
    model = EASE_R_Recommender(train, device=CPU)
    model.fit(l2_norm=l2_norm)
    got = model._device_w.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert np.all(np.diag(got) == 0)
    jax_model = JaxEASE(train)
    jax_model.fit(l2_norm=l2_norm)
    assert_rankings_agree(model, jax_model, 1e-5)


def assert_rankings_agree(model, jax_model, rel, cutoff=50):
    """Every user's top ``cutoff`` list equal to JAX's, but where JAX's
    scores of the two items lie within ``rel`` of the largest score (a near
    tie that two summation orders may break either way)."""
    users = np.arange(model.n_users)
    got, want = model.recommend(users, cutoff=cutoff), jax_model.recommend(users, cutoff=cutoff)
    scores = np.asarray(jax_model._compute_item_score(users))
    tol = rel * np.abs(scores[np.isfinite(scores)]).max()
    for u, (a, b) in enumerate(zip(got, want)):
        assert len(a) == len(b), u
        for x, y in zip(a, b):
            assert x == y or abs(scores[u, x] - scores[u, y]) <= tol, (u, x, y)


@pytest.mark.parametrize("topK", [5, 30])
def test_ease_r_pruned_w_matches_jax_and_the_host_branch(split, topK, monkeypatch):
    train, test = split
    A = jnp.asarray(train.toarray())
    scale = float(np.abs(np.asarray(jx._ease_r_weights(A, 50.0))).max())
    jax_model = JaxEASE(train)
    jax_model.fit(topK=topK, l2_norm=50.0)
    model = EASE_R_Recommender(train, device=CPU)
    model.fit(topK=topK, l2_norm=50.0)
    assert isinstance(model._device_w, torch.Tensor)  # the device prune
    assert_topk_close(model.W_sparse, jax_model.W_sparse, 1e-4, atol=1e-5 * scale)
    _metrics(model, jax_model, test)
    # past the dense limit, W is assembled on the host as a CSC: the same W
    monkeypatch.setattr(EASE_R_Recommender, "_DENSE_W_BYTE_LIMIT", 0)
    host = EASE_R_Recommender(train, device=CPU)
    host.fit(topK=topK, l2_norm=50.0)
    assert host._device_w is None
    np.testing.assert_array_equal(host.W_sparse.toarray(), model._device_w.numpy())
    assert (host.W_sparse != model.W_sparse).nnz == 0


def test_ease_r_mesh_plan_follows_jax(split):
    from ganmf_tpu_torch.parallel import make_mesh

    train, _ = split
    with pytest.raises(AttributeError):
        JaxEASE(train).fit(topK=5, l2_norm=50.0, mesh_plan=object())
    with pytest.raises(AttributeError):
        EASE_R_Recommender(train, device=CPU).fit(topK=5, l2_norm=50.0, mesh_plan=object())
    dense = EASE_R_Recommender(train, device=CPU)
    dense.fit(l2_norm=50.0, mesh_plan=object())  # without topK the plan is not read, as in JAX
    plain = EASE_R_Recommender(train, device=CPU)
    plain.fit(l2_norm=50.0)
    assert torch.equal(dense._device_w, plain._device_w)
    plain.fit(topK=5, l2_norm=50.0)
    one = EASE_R_Recommender(train, device=CPU)
    one.fit(topK=5, l2_norm=50.0, mesh_plan=make_mesh(device="cpu"))
    assert torch.equal(one._device_w, plain._device_w)


def test_predefined_list_serves_jax_lists_and_has_no_scores(split):
    train, test = split
    rng = np.random.RandomState(0)
    lists = np.stack([rng.permutation(69)[:12] + 1 for _ in range(90)]).astype(np.int32)
    lists[3, 5:] = 0  # a shorter list: zeros are not stored
    rec = sps.csr_matrix(np.pad(lists, ((0, 0), (0, 58))))  # the shape of the URM: 70 columns
    model, jax_model = PredefinedListRecommender(rec, device=CPU), JaxPredefined(rec)
    model.fit()
    for args in ((0, 2), ([0, 1], 1), (np.arange(90), None), (3, 10)):
        assert model.recommend(*args) == jax_model.recommend(*args)
    assert model.recommend(3, cutoff=10) == list(lists[3, :5])
    with pytest.raises(NotImplementedError):
        model.score_device(torch.arange(2))
    with pytest.raises(NotImplementedError):
        model.serve_all(cutoff=5)
    with pytest.raises(NotImplementedError):
        EvaluatorHoldout(test, [5], device=CPU).evaluateRecommender(model)
