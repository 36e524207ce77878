"""The port's P3alpha and RP3beta (models/p3alpha.py) against the JAX
package's, on the CPU.

A seeded 70 x 90 split (binary, and 1-5 ratings for ``min_rating`` and
``implicit``) with a cold user and a cold item. Tolerances:

- the scipy L1 row normalization against scikit-learn's ``normalize``
  (the only import of scikit-learn on the port's side is here): bitwise, on
  0/1 data, ratings and real values with empty rows;
- W_sparse: ``assert_topk_close`` (tests/test_torch_similarity.py) at rtol
  1e-5: the walk's products are real-valued (1 / degree terms) and summed in
  another order than JAX's;
- every metric at cutoffs 5/10/20/50 through the evaluator's similarity
  route: within 1e-6 of JAX's;
- W past the dense byte limit (the host CSR route): equal to the dense
  route's W.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from sklearn.preprocessing import normalize

import ganmf_tpu.models as jm
import ganmf_tpu_torch.models as pm
from ganmf_tpu_torch.models.p3alpha import l1_normalize_rows
from test_torch_itemknn import _evaluate_both
from test_torch_similarity import assert_topk_close

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _split(ratings=False, seed=4):
    rng = np.random.RandomState(seed)
    full = (rng.rand(70, 90) < 0.15).astype(np.float32)
    if ratings:
        full *= rng.randint(1, 6, full.shape).astype(np.float32)
    held = rng.rand(70, 90) < 0.2
    train, test = full * ~held, (full * held != 0).astype(np.float32)
    train[6] = 0  # a cold user
    train[:, 13] = 0  # a cold item
    return sps.csr_matrix(train), sps.csr_matrix(test)


@pytest.mark.parametrize("kind", ["binary", "ratings", "real"])
def test_l1_normalize_rows_matches_sklearn(kind):
    rng = np.random.RandomState(len(kind))
    dense = (rng.rand(40, 30) < 0.2).astype(np.float32)
    if kind == "ratings":
        dense *= rng.randint(1, 6, dense.shape)
    elif kind == "real":
        dense *= rng.randn(40, 30)
    dense[[0, 17, 38, 39]] = 0  # empty rows, the last two at the end
    X = sps.csr_matrix(dense.astype(np.float32))
    got, want = l1_normalize_rows(X), normalize(X, norm="l1", axis=1)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    np.testing.assert_array_equal(l1_normalize_rows(X.T).toarray(), normalize(X.T, norm="l1", axis=1).toarray())


P3_CASES = [
    ("P3alphaRecommender", dict(topK=30, alpha=0.642, normalize_similarity=False), False),
    ("P3alphaRecommender", dict(topK=25, alpha=1.0, normalize_similarity=True), False),
    ("P3alphaRecommender", dict(topK=30, alpha=0.8, min_rating=3, implicit=True), True),
    ("P3alphaRecommender", dict(topK=30, alpha=0.8, min_rating=2, implicit=False), True),
    ("RP3betaRecommender", dict(topK=30, alpha=0.9, beta=0.4, normalize_similarity=True), False),
    ("RP3betaRecommender", dict(topK=20, alpha=1.0, beta=0.7, normalize_similarity=False), False),
    ("RP3betaRecommender", dict(topK=30, alpha=0.6, beta=0.3, min_rating=3, implicit=True), True),
]


@pytest.mark.parametrize("cls,params,ratings", P3_CASES,
                         ids=[f"{c}-{'-'.join(map(str, p.values()))}" for c, p, _ in P3_CASES])
def test_walk_matches_jax(cls, params, ratings):
    train, test = _split(ratings=ratings)
    model = getattr(pm, cls)(train, device=CPU)
    model.fit(**params)
    jax_model = getattr(jm, cls)(train)
    jax_model.fit(**params)
    assert isinstance(model._device_w, torch.Tensor) and model._W_sparse_store is None
    assert_topk_close(model.W_sparse, jax_model.W_sparse, 1e-5)
    assert (model.URM_train != jax_model.URM_train).nnz == 0  # min_rating and implicit applied alike
    _evaluate_both(model, jax_model, test)


def test_walk_past_the_dense_limit_builds_host_csr(monkeypatch):
    train, _ = _split()
    dense = pm.RP3betaRecommender(train, device=CPU)
    dense.fit(topK=20, alpha=0.9, beta=0.5)
    model = pm.RP3betaRecommender(train, device=CPU)
    monkeypatch.setattr(type(model), "_DENSE_W_BYTE_LIMIT", 1)
    model.fit(topK=20, alpha=0.9, beta=0.5)
    assert model._W_sparse_store is not None and model._w_device() is False
    assert (model.W_sparse != dense.W_sparse).nnz == 0
