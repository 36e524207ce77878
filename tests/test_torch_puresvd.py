"""PureSVD and the matrix-factorization base class: the port against the JAX
package, on the CPU.

A 60 x 90 binary URM with three cold users (empty training rows) is
factorized by both packages from the same Omega (JAX's ``jax.random.normal``
draw, passed to the port's ``fit``), on each of the three routes: dense, the
resident bf16 matrix and the streamed padded-CSR products, forced by lowering
``_DENSE_URM_BYTE_LIMIT`` (and the resident budget). The factors' signs are
free, so the comparison is of U @ V^T and of the metrics.

Tolerances:
- U @ V^T: 2e-5 absolute on scores of order 1 (float32 range finders whose
  sums run in another order; the dense route agrees with its float64
  counterpart to about 3e-6 at this size, so 1e-5 holds it there);
- every metric at cutoffs 5/10/20/50: 1e-5 (the rankings are equal; the
  float32 metric sums run in another order, most in NOVELTY@50);
- the biased scores, the mean-item-factors estimate, the itemKNN
  estimate's W and the saved arrays: 1e-6 relative (one float32 product
  either way).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import puresvd as jsvd
from ganmf_tpu.models.base import MatrixFactorizationRecommender as JaxMF
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import MatrixFactorizationRecommender
from ganmf_tpu_torch.models import puresvd as psvd
from ganmf_tpu_torch.models.puresvd import PureSVDRecommender

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20, 50]
SEED = 7
COLD = [3, 17, 41]
F = 5


@pytest.fixture(scope="module")
def split():
    rng = np.random.RandomState(11)
    full = (rng.rand(60, 90) < 0.2).astype(np.float32)
    held = rng.rand(60, 90) < 0.2
    train, test = full * ~held, full * held
    train[COLD] = 0.0
    for u in COLD:  # the cold users still have test items
        test[u, rng.choice(90, 3, replace=False)] = 1.0
    return sps.csr_matrix(train), sps.csr_matrix(test)


def _omega(n_items, k=F + psvd.N_OVERSAMPLE):
    return np.array(jax.random.normal(jax.random.PRNGKey(SEED), (n_items, k), dtype=jnp.float32))


def _fit_both(split, route, monkeypatch):
    train, _ = split
    jm = jsvd.PureSVDRecommender(train)
    pm = PureSVDRecommender(train, device=CPU)
    if route != "dense":
        jm._DENSE_URM_BYTE_LIMIT = pm._DENSE_URM_BYTE_LIMIT = 0
    if route == "streamed":
        monkeypatch.setattr(jsvd, "_RESIDENT_BF16_LIMIT", 0)
        monkeypatch.setattr(psvd, "RESIDENT_BF16_BYTES", 0)
    jm.fit(num_factors=F, random_seed=SEED)
    pm.fit(num_factors=F, random_seed=SEED, omega=_omega(train.shape[1]))
    return jm, pm


@pytest.mark.parametrize("route", ["dense", "resident", "streamed"])
def test_fit_routes_match_jax(route, split, monkeypatch):
    train, test = split
    jm, pm = _fit_both(split, route, monkeypatch)
    assert pm._urm_streams() == (route != "dense")
    assert isinstance(pm._USER_factors_store, torch.Tensor)  # the factors stay on the device
    U, V, _ = pm._factors_device()
    assert U.is_contiguous() and V.is_contiguous()  # as K1 takes them on the card
    users = np.arange(train.shape[0])
    got = pm.score_device(torch.from_numpy(users)).numpy()
    want = np.asarray(jm.score_device(jnp.asarray(users, dtype=jnp.int32)))
    assert np.isneginf(got[COLD]).all() and np.isneginf(want[COLD]).all()
    warm = np.setdiff1d(users, COLD)
    assert np.abs(want[warm]).max() > 0.5
    np.testing.assert_allclose(got[warm], want[warm], rtol=0, atol=2e-5)

    got_r, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(pm)
    want_r, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jm)
    for c in CUTOFFS:
        for metric, value in want_r[c].items():
            assert got_r[c][metric] == pytest.approx(value, abs=1e-5, nan_ok=True), (route, c, metric)

    # serving: cold users get nothing, everyone else recommend's lists
    lists = pm.recommend(users, cutoff=10)
    assert lists == jm.recommend(users, cutoff=10)
    assert pm.recommend_fused(users, cutoff=10) == lists == jm.recommend_fused(users, cutoff=10)
    assert all(lists[u] == [] for u in COLD)
    idx, vals = pm.serve_all(cutoff=10)
    assert np.isneginf(vals[COLD]).all() and np.isfinite(vals[warm]).all()
    np.testing.assert_array_equal(idx[warm], np.asarray(lists, dtype=object)[warm].tolist())


def test_dense_route_is_float32_exact_to_its_float64_twin(split):
    """The range finder itself: the port's dense route against the same
    computation in float64 (the subspace is well separated at this size)."""
    train, _ = split
    A = torch.from_numpy(train.toarray())
    om = torch.from_numpy(_omega(train.shape[1]))
    U, V = psvd.puresvd_factors(A, om, F, 7)
    U64, V64 = psvd.puresvd_factors(A.double(), om.double(), F, 7)
    np.testing.assert_allclose((U @ V.T).numpy(), (U64 @ V64.T).numpy(), rtol=0, atol=1e-5)
    Q = psvd._cholqr2(torch.randn(200, 15, generator=torch.Generator().manual_seed(0)))
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(15), atol=1e-5)


def test_fit_draws_its_own_omega_and_rejects_a_wrong_one(split):
    train, _ = split
    a, b = PureSVDRecommender(train, device=CPU), PureSVDRecommender(train, device=CPU)
    a.fit(num_factors=F, random_seed=3)
    b.fit(num_factors=F, omega=psvd.draw_omega(train.shape[1], F + 10, 3, CPU))
    np.testing.assert_array_equal(a.USER_factors, b.USER_factors)
    assert isinstance(a.USER_factors, np.ndarray) and a.USER_factors.shape == (60, F)
    with pytest.raises(ValueError):
        a.fit(num_factors=F, omega=np.zeros((90, F)))


def _mf_pair(train, rng, use_bias):
    U = rng.randn(train.shape[0], 4).astype(np.float32)
    V = rng.randn(train.shape[1], 4).astype(np.float32)
    jm, pm = JaxMF(train), MatrixFactorizationRecommender(train, device=CPU)
    for m in (jm, pm):
        m.USER_factors, m.ITEM_factors = U.copy(), V.copy()
        if use_bias:
            m.use_bias = True
            m.USER_bias = (np.arange(train.shape[0]) * 0.01).astype(np.float32)
            m.ITEM_bias = np.linspace(-1, 1, train.shape[1]).astype(np.float32)
            m.GLOBAL_bias = np.float32(0.25)
    return jm, pm


@pytest.mark.parametrize("use_bias", [False, True], ids=["plain", "bias_fold"])
def test_mf_base_scores_and_metrics_match(use_bias, split):
    """The MF base: U @ V^T, or the biased score folded into the factors,
    with cold users at -inf; K1's route gives JAX's metrics and lists (its
    evaluator takes the dense route for a biased model)."""
    train, test = split
    jm, pm = _mf_pair(train, np.random.RandomState(5), use_bias)
    U, V, cold = pm._factors_device()
    assert U.shape[1] == V.shape[1] == (6 if use_bias else 4)
    assert cold[COLD].all() and int(cold.sum()) == len(COLD)
    users = np.arange(train.shape[0])
    got = pm.score_device(torch.from_numpy(users)).numpy()
    want = np.asarray(jm.score_device(jnp.asarray(users, dtype=jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got_r, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(pm)
    want_r, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jm)
    for c in CUTOFFS:
        for metric, value in want_r[c].items():
            assert got_r[c][metric] == pytest.approx(value, abs=1e-5, nan_ok=True), (c, metric)
    for flag in (True, False):
        assert pm.recommend(users, cutoff=12, remove_seen_flag=flag) == jm.recommend(
            users, cutoff=12, remove_seen_flag=flag)


def test_mean_item_factors_and_itemknn(split):
    train, _ = split
    jm, pm = _mf_pair(train, np.random.RandomState(6), False)
    new = train.tolil()
    new[COLD[0], [1, 2, 5]] = 1.0  # one cold user gets a profile
    new = sps.csr_matrix(new)
    for m in (jm, pm):
        m.set_URM_train(new, estimate_model_for_cold_users="mean_item_factors")
    np.testing.assert_allclose(pm.USER_factors, jm.USER_factors, rtol=1e-6)
    np.testing.assert_array_equal(pm._get_cold_user_mask(), jm._get_cold_user_mask())
    assert pm._get_cold_user_mask().sum() == len(COLD) - 1
    assert pm.recommend([COLD[0]], cutoff=5) == jm.recommend([COLD[0]], cutoff=5) != [[]]
    # the itemKNN estimate (ported with the similarity family): JAX's
    # item-item model, and the dense route in place of K1
    for m in (jm, pm):
        m.set_URM_train(new, estimate_model_for_cold_users="itemKNN", topK=10)
    assert pm._cold_user_KNN_model_available and not pm._ranks_with_k1()
    np.testing.assert_allclose(pm._ItemKNNRecommender.W_sparse.toarray(),
                               jm._ItemKNNRecommender.W_sparse.toarray(), rtol=1e-6, atol=1e-7)
    users = list(range(8)) + COLD
    assert pm.recommend(users, cutoff=5) == jm.recommend(users, cutoff=5)


@pytest.mark.parametrize("use_bias", [False, True], ids=["plain", "bias"])
def test_save_dict_and_zip_roundtrip(use_bias, split, tmp_path):
    train, _ = split
    jm, pm = _mf_pair(train, np.random.RandomState(8), use_bias)
    got, want = pm._save_dict(), jm._save_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(np.asarray(got[key], dtype=np.float64), np.asarray(value, dtype=np.float64))
    pm.saveModel(str(tmp_path), "mf")
    back = JaxMF(train)
    back.loadModel(str(tmp_path), "mf")
    users = jnp.arange(train.shape[0], dtype=jnp.int32)
    np.testing.assert_allclose(np.asarray(back.score_device(users)), np.asarray(jm.score_device(users)),
                               rtol=1e-6, atol=1e-6)
    jm.saveModel(str(tmp_path), "jax_mf")
    port = MatrixFactorizationRecommender(train, device=CPU)
    port.loadModel(str(tmp_path), "jax_mf")
    np.testing.assert_array_equal(port.score_device(torch.arange(train.shape[0])).numpy(),
                                  pm.score_device(torch.arange(train.shape[0])).numpy())
