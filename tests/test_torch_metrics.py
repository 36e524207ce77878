"""Ranking metrics: the port against ganmf_tpu.eval.metrics.

The same top-k lists, test rows, novelty, popularity and RMSE inputs go
through the JAX ``evaluate_batch_from_topk`` and the port's; the per-cutoff
scalar sums and item counters must agree within 1e-6 (float32 sums taken in
another order).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from ganmf_tpu.eval import evaluator as jax_evaluator
from ganmf_tpu.eval import metrics as jax_metrics
from ganmf_tpu_torch.eval import evaluator as torch_evaluator
from ganmf_tpu_torch.eval import metrics as torch_metrics

torch.set_num_threads(1)


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
