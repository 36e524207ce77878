"""The two ranking routes of the port: K1 for every factor model at every
cutoff, the dense route (score_device plus a stable top-k) for every other
model.

The route is chosen from the model's type before any launch, as the JAX
evaluator's ``_can_fuse`` chooses it. A factor model asked for more than
MAX_K items (K1's wide form on the card) must still rank through K1 and give
the lists of the dense route on the same scores; a K1 failure must raise,
never fall through to the dense route. Tolerance on metrics: 1e-6 (float32
sums in another order); lists equal.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.eval import evaluator as evaluator_mod
from ganmf_tpu_torch.models import CFGAN, GANMF, Recommender, init_params
from ganmf_tpu_torch.models import base as base_mod
from ganmf_tpu_torch.ops.scorer import MAX_K, masked_topk_scores_reference

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _split():
    rng = np.random.RandomState(11)
    full = (rng.rand(60, 150) < 0.1).astype(np.float32)
    held = rng.rand(60, 150) < 0.25
    return sps.csr_matrix(full * ~held), sps.csr_matrix(full * held)


def _ganmf(mode="user"):
    train, _ = _split()
    m = GANMF(train, mode=mode, device=CPU)
    n_rows, n_cols = m._train_matrix().shape
    m.params = init_params(n_rows, n_cols, 6, 12, torch.Generator().manual_seed(2), CPU)
    return m


def _count_k1(monkeypatch, *modules):
    """Wrap the K1 wrapper seen by ``modules``; return the list of the k of
    every call."""
    ks = []
    real = base_mod.masked_topk_scores

    def counted(U, V, mask, k):
        ks.append(k)
        return real(U, V, mask, k)

    for mod in modules:
        monkeypatch.setattr(mod, "masked_topk_scores", counted)
    return ks


def test_route_is_chosen_by_model_and_k():
    """By the model alone: a factor model takes K1 at every k, CFGAN never."""
    m = _ganmf()
    assert m._ranks_with_k1()
    train, _ = _split()
    assert not CFGAN(train, device=CPU)._ranks_with_k1()  # no factors: always dense
    with pytest.raises(NotImplementedError):
        Recommender(train, device=CPU).score_device(torch.arange(3))


@pytest.mark.parametrize("mode", ["user", "item"])
def test_dense_route_above_max_k_gives_k1_plain_lists(mode, monkeypatch):
    """Above MAX_K a factor model still ranks through K1, and its lists equal
    both K1's plain lists and those of the dense route on the same scores."""
    m = _ganmf(mode)
    users = np.arange(m.n_users)
    uids = torch.from_numpy(users)
    k = MAX_K + 36
    U, V, _ = m._factors_device()
    _, want = masked_topk_scores_reference(U[uids], V, m.device_seen_rows(uids), k)
    _, dense = Recommender._serve_block(m, uids, k, True)
    np.testing.assert_array_equal(dense.numpy(), want.numpy())
    ks = _count_k1(monkeypatch, base_mod)
    got = m.recommend(users, cutoff=k)
    for b, lst in enumerate(got):
        assert lst == want[b, : len(lst)].tolist()
    idx, vals = m.serve_all(cutoff=k, block=25)
    np.testing.assert_array_equal(idx, want.numpy().astype(np.int32))
    assert np.isfinite(vals).sum(1).tolist() == [len(lst) for lst in got]
    # the default cutoff (n_items - 1) takes K1 too
    assert m.recommend(3) == m.recommend(3, cutoff=m.n_items - 1)
    assert ks == [k] + [k] * 3 + [m.n_items - 1] * 2  # recommend, 3 serve blocks, 2 recommends


def test_evaluator_above_max_k_takes_the_dense_route(monkeypatch):
    """Cutoffs up to 100 on a factor model rank through K1 (the JAX evaluator
    fuses MF models at any cutoff), and give the metrics of the dense route
    on the same scores, at every cutoff."""
    m = _ganmf()
    _, test = _split()
    ks = _count_k1(monkeypatch, evaluator_mod)
    k1, _ = EvaluatorHoldout(test, [5, 20, 100], device=CPU).evaluateRecommender(m)
    assert ks and set(ks) == {100}
    n_calls = len(ks)
    monkeypatch.setattr(GANMF, "_ranks_with_k1", lambda self: False)
    dense, _ = EvaluatorHoldout(test, [5, 20, 100], device=CPU).evaluateRecommender(m)
    assert len(ks) == n_calls  # the dense evaluation did not call K1
    for c in (5, 20, 100):
        for metric, value in dense[c].items():
            assert k1[c][metric] == pytest.approx(value, abs=1e-6, nan_ok=True), (c, metric)
    assert k1[100]["RECALL"] >= k1[20]["RECALL"]


def test_a_k1_failure_raises(monkeypatch):
    """No fallback: when K1 fails, recommend, serve_all and the evaluator
    raise, below and above MAX_K."""
    def broken(*args, **kwargs):
        raise RuntimeError("K1 launch failed")

    monkeypatch.setattr(base_mod, "masked_topk_scores", broken)
    monkeypatch.setattr(evaluator_mod, "masked_topk_scores", broken)
    m = _ganmf()
    _, test = _split()
    for k in (10, MAX_K + 1):
        with pytest.raises(RuntimeError, match="K1"):
            m.recommend(np.arange(5), cutoff=k)
        with pytest.raises(RuntimeError, match="K1"):
            m.serve_all(cutoff=k)
        with pytest.raises(RuntimeError, match="K1"):
            EvaluatorHoldout(test, [5, k], device=CPU).evaluateRecommender(m)
