"""The port's KNN recommenders (models/itemknn.py), the similarity base classes
and the evaluator's similarity route against the JAX package's, on the CPU.

One seeded 80 x 120 binary train/test split with a cold user and a cold
item. Tolerances:

- W_sparse of ItemKNN-CF, UserKNN-CF and ItemKNN-CBF: ``assert_topk_close``
  (tests/test_torch_similarity.py) at rtol 1e-6 on 0/1 data and 1e-5 with
  BM25 or TF-IDF weights; ItemKNNCustomSimilarity and the hybrid run the JAX
  package's host code on the same input: bitwise;
- every metric at cutoffs 5/10/20/50 through the evaluator's similarity
  route: within 1e-6 of JAX's (the rankings are equal; float32 metric sums
  run in another order);
- the sparse-W route (the dense byte limit lowered to 1): scores within 1e-6
  of the dense route's, metrics within 1e-6;
- PureSVD's ``"itemKNN"`` cold-user estimate from JAX's factors: the
  estimated W within rtol 1e-6, metrics within 1e-6 by the dense route.
  Both packages take the cold and the warm masks from the same URM, so the
  estimate scores no user; with users marked cold by hand it scores them,
  within 1e-6 of JAX's scores.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import ganmf_tpu.models as jm
from ganmf_tpu.models import itemknn as jknn
from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import base as jbase
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.eval import evaluator as pev
import ganmf_tpu_torch.models as pm
from ganmf_tpu_torch.models import base as pbase
from test_torch_similarity import assert_topk_close

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20, 50]
METRIC_TOL = 1e-6


@pytest.fixture(scope="module")
def split():
    rng = np.random.RandomState(5)
    full = (rng.rand(80, 120) < 0.12).astype(np.float32)
    held = rng.rand(80, 120) < 0.2
    train, test = full * ~held, full * held
    train[4] = 0  # a cold user with test items
    test[4, [1, 9, 30]] = 1
    train[:, 11] = 0  # a cold item
    return sps.csr_matrix(train), sps.csr_matrix(test)


def _icm(n_items=120, n_features=25, seed=3):
    """Feature weights in (0, 1]: a binary ICM makes many items' scores equal
    sums of equal similarities, which two summation orders rank either way."""
    rng = np.random.RandomState(seed)
    return sps.csr_matrix(((rng.rand(n_items, n_features) < 0.15) * rng.rand(n_items, n_features)).astype(np.float32))


def assert_metrics_close(got, want, tol=METRIC_TOL):
    assert list(got) == list(want)
    for cutoff, metrics in want.items():
        assert list(got[cutoff]) == list(metrics)
        for name, value in metrics.items():
            assert got[cutoff][name] == pytest.approx(value, abs=tol, nan_ok=True), (cutoff, name)


def _evaluate_both(model, jax_model, test):
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(model)
    want, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jax_model)
    assert_metrics_close(got, want)
    return got


@pytest.fixture
def sim_route(monkeypatch):
    """Counts the evaluator's similarity-route blocks."""
    calls = []
    original = pev.EvaluatorHoldout._fused_sim_block

    def counting(self, *args, **kwargs):
        calls.append(1)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(pev.EvaluatorHoldout, "_fused_sim_block", counting)
    return calls


CF_CASES = [
    ("ItemKNNCFRecommender", dict()),
    ("ItemKNNCFRecommender", dict(topK=20, shrink=10, similarity="asymmetric", asymmetric_alpha=0.7)),
    ("ItemKNNCFRecommender", dict(topK=15, shrink=0, similarity="jaccard")),
    ("ItemKNNCFRecommender", dict(topK=25, shrink=5, similarity="euclidean")),
    ("ItemKNNCFRecommender", dict(topK=20, shrink=10, feature_weighting="BM25")),
    ("ItemKNNCFRecommender", dict(topK=20, shrink=10, feature_weighting="TF-IDF")),
    ("UserKNNCFRecommender", dict(topK=15, shrink=5)),
    ("UserKNNCFRecommender", dict(topK=10, shrink=2, similarity="dice")),
    ("UserKNNCFRecommender", dict(topK=12, shrink=5, feature_weighting="BM25")),
]


@pytest.mark.parametrize("cls,params", CF_CASES, ids=[f"{c}-{'-'.join(map(str, p.values()))}" for c, p in CF_CASES])
def test_knn_cf_matches_jax(cls, params, split, sim_route):
    train, test = split
    model = getattr(pm, cls)(train, device=CPU)
    model.fit(**params)
    jax_model = getattr(jm, cls)(train)
    jax_model.fit(**params)
    assert isinstance(model._device_w, torch.Tensor) and model._W_sparse_store is None  # W only on the device
    rtol = 1e-5 if "feature_weighting" in params else 1e-6
    assert_topk_close(model.W_sparse, jax_model.W_sparse, rtol)
    _evaluate_both(model, jax_model, test)
    assert sim_route  # ranked by the similarity route
    # recommend and serve_all give JAX's lists
    users = np.arange(10)
    assert model.recommend(users, cutoff=10) == jax_model.recommend(users, cutoff=10)
    idx, vals = model.serve_all(cutoff=10)
    jidx, jvals = jax_model.serve_all(cutoff=10)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(vals, jvals, rtol=rtol)


@pytest.mark.parametrize("weighting", ["none", "BM25", "TF-IDF"])
def test_itemknn_cbf_matches_jax(weighting, split, sim_route):
    train, test = split
    model = pm.ItemKNNCBFRecommender(_icm(), train, device=CPU)
    model.fit(topK=20, shrink=5, feature_weighting=weighting)
    jax_model = jm.ItemKNNCBFRecommender(_icm(), train)
    jax_model.fit(topK=20, shrink=5, feature_weighting=weighting)
    assert_topk_close(model.W_sparse, jax_model.W_sparse, 1e-6 if weighting == "none" else 1e-5)
    _evaluate_both(model, jax_model, test)
    assert sim_route
    with pytest.raises(ValueError, match="ICM has"):
        pm.ItemKNNCBFRecommender(_icm(n_items=7), train, device=CPU)


def _random_w(n=120, seed=8, density=0.1):
    rng = np.random.RandomState(seed)
    return sps.csr_matrix(((rng.rand(n, n) < density) * (rng.rand(n, n) - 0.2)).astype(np.float32))


@pytest.mark.parametrize("select", [False, True])
def test_custom_similarity_matches_jax(select, split, sim_route):
    train, test = split
    model = pm.ItemKNNCustomSimilarityRecommender(train, device=CPU)
    model.fit(_random_w(), selectTopK=select, topK=6)
    jax_model = jknn.ItemKNNCustomSimilarityRecommender(train)
    jax_model.fit(_random_w(), selectTopK=select, topK=6)
    assert (model.W_sparse != jax_model.W_sparse).nnz == 0
    _evaluate_both(model, jax_model, test)
    assert sim_route


def test_similarity_hybrid_matches_jax(split):
    train, test = split
    model = pm.ItemKNNSimilarityHybridRecommender(train, _random_w(seed=1), _random_w(seed=2), device=CPU)
    model.fit(topK=8, alpha=0.3)
    jax_model = jknn.ItemKNNSimilarityHybridRecommender(train, _random_w(seed=1), _random_w(seed=2))
    jax_model.fit(topK=8, alpha=0.3)
    assert (model.W_sparse != jax_model.W_sparse).nnz == 0
    _evaluate_both(model, jax_model, test)
    with pytest.raises(ValueError, match="different shapes"):
        pm.ItemKNNSimilarityHybridRecommender(train, _random_w(), _random_w(n=60), device=CPU)


@pytest.mark.parametrize("case", ["dense", "sparse_small", "sparse_padded", "sparse_device"])
def test_similarity_matrix_topk_matches_jax(case, monkeypatch):
    if case == "dense":
        W = _random_w().toarray()
    elif case == "sparse_small":
        W = _random_w()
    else:
        W = _random_w(n=8200, density=0.0005)
        if case == "sparse_device":
            monkeypatch.setattr(pbase, "_DEVICE_PRUNE_THRESHOLD", 1)
            monkeypatch.setattr(jbase, "_DEVICE_PRUNE_THRESHOLD", 1)
    got = pbase.similarity_matrix_topk(W, k=3, device=CPU)
    want = jbase.similarity_matrix_topk(W, k=3)
    assert got.shape == want.shape and (got != want).nnz == 0


@pytest.mark.parametrize("cls", ["ItemKNNCFRecommender", "UserKNNCFRecommender"])
def test_sparse_w_route_matches_dense(cls, split, monkeypatch, sim_route):
    train, test = split
    dense = getattr(pm, cls)(train, device=CPU)
    dense.fit(topK=15, shrink=5)
    model = getattr(pm, cls)(train, device=CPU)
    monkeypatch.setattr(type(model), "_DENSE_W_BYTE_LIMIT", 1)
    model.fit(topK=15, shrink=5)
    assert model._device_w is None and model._w_device() is False
    assert (model.W_sparse != dense.W_sparse).nnz == 0
    users = torch.arange(train.shape[0])
    torch.testing.assert_close(model.score_device(users), dense.score_device(users), rtol=1e-6, atol=1e-6)
    calls_before = len(sim_route)
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(model)
    assert len(sim_route) == calls_before  # the dense route: W is not dense on the device
    monkeypatch.setattr(type(model), "_DENSE_W_BYTE_LIMIT", 4 << 30)
    want, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(dense)
    assert_metrics_close(got, want)


def test_w_sparse_is_made_from_the_device_w_and_saved(split, tmp_path):
    train, _ = split
    model = pm.ItemKNNCFRecommender(train, device=CPU)
    model.fit(topK=10, shrink=3)
    W = model.W_sparse
    np.testing.assert_array_equal(W.toarray(), model._device_w.numpy())
    model.saveModel(str(tmp_path))
    loaded = pm.ItemKNNCFRecommender(train, device=CPU)
    loaded.loadModel(str(tmp_path))
    assert (loaded.W_sparse != W).nnz == 0
    users = torch.arange(20)
    assert torch.equal(loaded.score_device(users), model.score_device(users))
    # a new training URM drops the device W and keeps its host copy
    model.set_URM_train(train)
    assert model._device_w is None and (model.W_sparse != W).nnz == 0


def test_mf_itemknn_cold_estimate_matches_jax(split, monkeypatch):
    train, test = split
    jax_model = jm.PureSVDRecommender(train)
    jax_model.fit(num_factors=6)
    model = pm.PureSVDRecommender(train, device=CPU)
    model.USER_factors, model.ITEM_factors = jax_model.USER_factors, jax_model.ITEM_factors
    for m in (model, jax_model):
        m.set_URM_train(train, estimate_model_for_cold_users="itemKNN", topK=20)
    assert model._cold_user_KNN_model_available and not model._ranks_with_k1()
    assert_topk_close(model._ItemKNNRecommender.W_sparse, jax_model._ItemKNNRecommender.W_sparse, 1e-6)
    W = pbase.compute_W_sparse_from_item_latent_factors(jax_model.ITEM_factors, topK=20, device=CPU)
    assert (W != model._ItemKNNRecommender.W_sparse).nnz == 0

    def no_k1(*args, **kwargs):
        raise AssertionError("K1 ranked a model with the itemKNN estimate")

    monkeypatch.setattr(pev, "masked_topk_scores", no_k1)
    monkeypatch.setattr(pbase, "masked_topk_scores", no_k1)
    users = torch.arange(train.shape[0])
    np.testing.assert_allclose(model.score_device(users).numpy(), np.asarray(jax_model.score_device(users.numpy())),
                               rtol=1e-6, atol=1e-6)
    _evaluate_both(model, jax_model, test)
    assert model.recommend(np.arange(8), cutoff=10) == jax_model.recommend(np.arange(8), cutoff=10)


def _estimated_pair(train):
    jax_model = jm.PureSVDRecommender(train)
    jax_model.fit(num_factors=6)
    model = pm.PureSVDRecommender(train, device=CPU)
    model.USER_factors, model.ITEM_factors = jax_model.USER_factors, jax_model.ITEM_factors
    for m in (model, jax_model):
        m.set_URM_train(train, estimate_model_for_cold_users="itemKNN", topK=20)
    return model, jax_model


def test_mf_itemknn_cold_estimate_scores_no_user_and_skips_its_product(split, monkeypatch):
    train, _ = split
    model, jax_model = _estimated_pair(train)
    assert not (model._cold_user_mask & model._warm_user_KNN_mask).any()

    def no_product(*args, **kwargs):
        raise AssertionError("the estimate's product was made for a batch no user of which takes it")

    monkeypatch.setattr(model._ItemKNNRecommender, "score_device", no_product)
    users = torch.arange(train.shape[0])
    U, V = model.USER_factors, model.ITEM_factors
    want = np.where(model._cold_user_mask[:, None], -np.inf, U @ V.T)
    np.testing.assert_allclose(model.score_device(users).numpy(), want, rtol=1e-6, atol=1e-6)


def test_mf_itemknn_cold_estimate_scores_users_marked_cold_like_jax(split):
    train, _ = split
    model, jax_model = _estimated_pair(train)
    # the reference keeps the cold mask of the URM the model was fitted on;
    # users marked cold by hand while warm in the new URM take the estimate
    marked = np.ediff1d(train.indptr) == 0
    marked[[0, 7, 21]] = True
    for m in (model, jax_model):
        m._cold_user_mask = marked.copy()
        m._invalidate_device_cache()
    users = torch.arange(train.shape[0])
    got = model.score_device(users).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_model.score_device(users.numpy())), rtol=1e-6, atol=1e-6)
    knn = model._ItemKNNRecommender.score_device(torch.tensor([0, 7, 21])).numpy()
    np.testing.assert_array_equal(got[[0, 7, 21]], knn)
    assert np.isneginf(got[4]).all()  # cold in the new URM too: masked
