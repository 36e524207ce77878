"""The evaluator's extras against the JAX package's, on the CPU: the
diversity object, ``EvaluatorNegativeItemSample``, the GANMF_TPU_DEBUG NaN
checks of the evaluator and of the four GAN epochs, and the profiling hooks.

Both modes of evaluation take the dense route in both packages, so K1 is not
launched even for a factor model (counted). Tolerances: metrics within 1e-6
of JAX's from the same scores (float32 sums in another order; the rankings
are equal, both stable with ties to the lowest id); DIVERSITY_SIMILARITY
within rtol 1e-5 of the reference loop in float64 (as
tests/test_eval_extras.py:298 holds JAX's).
"""

import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.eval import EvaluatorNegativeItemSample as JaxNegativeSample
from ganmf_tpu.eval.evaluator import _diversity_block as jax_diversity_block
from ganmf_tpu.models import GANMF as JaxGANMF
from ganmf_tpu.models import ganmf as jgm
from ganmf_tpu.models.base import Recommender as JaxRecommender
from ganmf_tpu_torch.eval import EvaluatorHoldout, EvaluatorNegativeItemSample
from ganmf_tpu_torch.eval import evaluator as pev
from ganmf_tpu_torch.models import CAAE, CFGAN, GANMF, DisGANMF
from ganmf_tpu_torch.models import ganmf as pgm
from ganmf_tpu_torch.models.base import Recommender
from ganmf_tpu_torch.utils import debug, profiling

CPU = torch.device("cpu")
CUTOFFS = [3, 5, 10]


class Stub(Recommender):
    def __init__(self, train, scores):
        super().__init__(train, device=CPU)
        self._scores = torch.from_numpy(np.asarray(scores, np.float32))

    def score_device(self, user_ids):
        return self._scores.index_select(0, user_ids)


class JaxStub(JaxRecommender):
    def __init__(self, train, scores):
        super().__init__(train)
        self._scores = np.asarray(scores, np.float32)

    def score_device(self, user_ids):
        return jnp.asarray(self._scores)[user_ids]


def _scores(train, seed=3, grid=False):
    rng = np.random.RandomState(seed)
    s = rng.randn(*train.shape).astype(np.float32)
    return np.round(s * 2) / 2 if grid else s  # a grid of halves: many exact ties


def _close(got, want, tol=1e-6):
    assert list(got) == list(want)
    for c in want:
        assert list(got[c]) == list(want[c]), c  # the metric order, DIVERSITY_SIMILARITY's place too
        for metric, value in want[c].items():
            assert got[c][metric] == pytest.approx(value, abs=tol, rel=tol, nan_ok=True), (c, metric)


def _count_k1(monkeypatch):
    calls = []
    orig = pev.masked_topk_scores
    monkeypatch.setattr(pev, "masked_topk_scores", lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def _ganmf_pair(train):
    jm = JaxGANMF(train, seed=2, is_experiment=True)
    jm.params = jgm._init_params(jax.random.PRNGKey(2), *train.shape, 4, 8)
    pm = GANMF(train, device=CPU)
    pm.params = pgm.params_from_jax([np.asarray(x) for x in jm.params], CPU)
    return jm, pm


@pytest.mark.parametrize("grid", [False, True], ids=["continuous", "ties"])
@pytest.mark.parametrize("sparse", [True, False])
def test_diversity_matches_jax_and_the_reference_loop(urm_pair, grid, sparse):
    train, test = urm_pair
    scores = _scores(train, grid=grid)
    M = np.random.RandomState(3).rand(train.shape[1], train.shape[1]).astype(np.float32)
    div = sps.csr_matrix(M) if sparse else M
    ev = EvaluatorHoldout(test, CUTOFFS, diversity_object=div, device=CPU)
    got, text = ev.evaluateRecommender(Stub(train, scores))
    want, want_text = JaxEvaluatorHoldout(test, CUTOFFS, diversity_object=div).evaluateRecommender(
        JaxStub(train, scores))
    _close(got, want)
    keys = list(got[5])
    assert keys[keys.index("AVERAGE_POPULARITY") + 1] == "DIVERSITY_SIMILARITY"
    assert "DIVERSITY_SIMILARITY" in text

    # the reference's loop (Base/Evaluation/metrics.py:405-458), ties to the lowest id
    dense_train = train.toarray()
    expected = {c: 0.0 for c in CUTOFFS}
    for u in ev.usersToEvaluate:
        s = scores[u].astype(np.float64)
        s[dense_train[u] != 0] = -np.inf
        order = np.argsort(-s, kind="stable")
        for c in CUTOFFS:
            items = order[:c][np.isfinite(s[order[:c]])]
            L = len(items)
            if L > 1:
                total = sum(M[items[p], items].astype(np.float64).sum() - M[items[p], items[p]]
                            for p in range(L - 1))
                expected[c] += total / (L * (L - 1))
    for c in CUTOFFS:
        assert got[c]["DIVERSITY_SIMILARITY"] == pytest.approx(expected[c] / len(ev.usersToEvaluate), rel=1e-5)


def test_diversity_block_gathers_like_the_full_rows():
    rng = np.random.RandomState(0)
    M = torch.from_numpy(rng.rand(30, 30).astype(np.float32))
    vals = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
    vals[2, 3:] = float("-inf")  # a short list
    vals[4, 1:] = float("-inf")  # one item: no pair
    ids = torch.from_numpy(rng.randint(0, 30, (6, 8)))
    got = pev._diversity_block(M, ids, vals, (3, 5, 8))
    want = jax_diversity_block(jnp.asarray(M.numpy()), jnp.asarray(ids.numpy()), jnp.asarray(vals.numpy()),
                     jnp.ones(6, bool), (3, 5, 8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_diversity_takes_the_dense_route_for_a_factor_model(urm_pair, monkeypatch):
    train, test = urm_pair
    jm, pm = _ganmf_pair(train)
    calls = _count_k1(monkeypatch)
    M = np.random.RandomState(5).rand(train.shape[1], train.shape[1]).astype(np.float32)
    got, _ = EvaluatorHoldout(test, CUTOFFS, diversity_object=M, device=CPU).evaluateRecommender(pm)
    assert calls == []
    want, _ = JaxEvaluatorHoldout(test, CUTOFFS, diversity_object=M).evaluateRecommender(jm)
    _close(got, want, tol=1e-5)
    EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(pm)
    assert calls  # plain holdout ranks the factor model through K1


def _negatives(train, test, seed=0, n=5):
    rng = np.random.RandomState(seed)
    dense_train, dense_test = train.toarray(), test.toarray()
    neg = np.zeros(train.shape, np.float32)
    for u in range(train.shape[0]):
        allowed = np.where((dense_train[u] == 0) & (dense_test[u] == 0))[0]
        neg[u, rng.choice(allowed, n, replace=False)] = 1
    return sps.csr_matrix(neg)


@pytest.mark.parametrize("grid", [False, True], ids=["continuous", "ties"])
def test_negative_item_sample_matches_jax(urm_pair, grid):
    train, test = urm_pair
    scores = _scores(train, seed=4, grid=grid)
    neg = _negatives(train, test)
    got, _ = EvaluatorNegativeItemSample(test, neg, CUTOFFS, device=CPU).evaluateRecommender(Stub(train, scores))
    want, _ = JaxNegativeSample(test, neg, CUTOFFS).evaluateRecommender(JaxStub(train, scores))
    _close(got, want)
    full, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(Stub(train, scores))
    assert got[5]["MAP"] >= full[5]["MAP"]  # among test items and 5 negatives: an easier task
    assert EvaluatorNegativeItemSample.EVALUATOR_NAME == JaxNegativeSample.EVALUATOR_NAME


def test_negative_item_sample_takes_the_dense_route(urm_pair, monkeypatch):
    train, test = urm_pair
    jm, pm = _ganmf_pair(train)
    neg = _negatives(train, test, seed=1)
    calls = _count_k1(monkeypatch)
    got, _ = EvaluatorNegativeItemSample(test, neg, CUTOFFS, device=CPU).evaluateRecommender(pm)
    assert calls == []
    want, _ = JaxNegativeSample(test, neg, CUTOFFS).evaluateRecommender(jm)
    _close(got, want, tol=1e-5)


class NaNModel(Recommender):
    def score_device(self, user_ids):
        return torch.full((len(user_ids), self.n_items), float("nan"))


def test_evaluator_nan_guard(urm_pair, monkeypatch):
    train, test = urm_pair
    monkeypatch.delenv("GANMF_TPU_DEBUG", raising=False)
    EvaluatorHoldout(test, [5], device=CPU).evaluateRecommender(NaNModel(train, device=CPU))  # silent
    monkeypatch.setenv("GANMF_TPU_DEBUG", "1")
    with pytest.raises(FloatingPointError, match="NaN model scores"):
        EvaluatorHoldout(test, [5], device=CPU).evaluateRecommender(NaNModel(train, device=CPU))
    # the K1 route checks its values too
    _, pm = _ganmf_pair(train)
    with torch.no_grad():
        pm.params.user_emb.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="NaN model scores"):
        EvaluatorHoldout(test, [5], device=CPU).evaluateRecommender(pm)


FITS = {
    "GANMF": (GANMF, dict(num_factors=4, emb_dim=8, epochs=1, batch_size=16), "d_reg"),
    "DisGANMF": (DisGANMF, dict(num_factors=4, d_nodes=8, epochs=1, batch_size=16), "d_reg"),
    "CFGAN": (CFGAN, dict(d_nodes=8, g_nodes=8, epochs=1, d_batch_size=16, g_batch_size=16), "d_reg"),
    "CFGAN csr": (CFGAN, dict(d_nodes=8, g_nodes=8, epochs=1, d_batch_size=16, g_batch_size=16,
                              urm_storage="csr", scheme="ZP", zr_ratio=0.3, zp_ratio=0.3), "g_reg"),
    "CAAE": (CAAE, dict(epochs=1, d_steps=1, g_steps=1, gpr_steps=1, g_layers=1, g_units=8, num_factors=4,
                        d_bsize=64, m_batch=8), "lr"),
    "CAAE dedup": (CAAE, dict(epochs=1, d_steps=1, g_steps=1, gpr_steps=1, g_layers=1, g_units=8,
                              num_factors=4, d_bsize=64, m_batch=8, d_scatter="dedup"), "lr"),
}


@pytest.mark.parametrize("name", list(FITS))
def test_epoch_nan_guard_raises_at_the_step(urm_pair, monkeypatch, name):
    """A NaN regularization weight or learning rate poisons the first update: without the flag it
    spreads silently into the parameters; with it the first step raises,
    naming itself (as tests/test_aux.py:185 expects of JAX's checkify)."""
    train, _ = urm_pair
    cls, kwargs, lr_name = FITS[name]
    monkeypatch.delenv("GANMF_TPU_DEBUG", raising=False)
    m = cls(train, seed=3, is_experiment=True, device=CPU)
    m.fit(**kwargs, **{lr_name: float("nan")})
    assert not all(torch.isfinite(p).all() for p in m.params.parameters())
    monkeypatch.setenv("GANMF_TPU_DEBUG", "1")
    with pytest.raises(FloatingPointError, match=r"NaN in .*step 0") as err:
        cls(train, seed=3, is_experiment=True, device=CPU).fit(**kwargs, **{lr_name: float("nan")})
    assert "nan" in str(err.value).lower()
    healthy = cls(train, seed=3, is_experiment=True, device=CPU)
    healthy.fit(**kwargs)
    assert all(torch.isfinite(p).all() for p in healthy.params.parameters())


def test_debug_flag_is_read_at_call_time(monkeypatch):
    monkeypatch.delenv("GANMF_TPU_DEBUG", raising=False)
    assert not debug.debug_enabled()
    for on, value in ((True, "1"), (True, "yes"), (False, "0"), (False, "off"), (False, "False")):
        monkeypatch.setenv("GANMF_TPU_DEBUG", value)
        assert debug.debug_enabled() is on
    debug.raise_on_nan("a step", x=torch.ones(3))
    with pytest.raises(FloatingPointError, match="a step: y"):
        debug.raise_on_nan("a step", x=torch.ones(3), y=torch.tensor([0.0, float("nan")]))


def test_profiling_hooks(tmp_path):
    with profiling.device_trace(None) as prof:
        assert prof is None
    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.annotate("block"):
            torch.ones(64).sum()
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert '"block"' in trace
    timer = profiling.EpochTimer()
    for _ in range(2):
        timer.start()
        torch.ones(16).sum()
        assert timer.stop() >= 0.0
    assert len(timer.times) == 2 and timer.mean == pytest.approx(sum(timer.times) / 2)
    assert os.path.isdir(tmp_path / "trace")


def test_dense_ranking_orders_signed_zeros_as_lax_top_k():
    """The dense route ranks as ``lax.top_k`` does: +0.0 above -0.0 (the IEEE
    total order), ties to the lowest index. A stable float sort ties the two
    zeros, which moved the negative-sample metrics on scores with exact
    zeros; K1's plain version keeps the float comparison of the kernels."""
    from ganmf_tpu_torch.ops.scorer import masked_topk_scores_reference
    from ganmf_tpu_torch.ops.topk import tiled_topk, topk_lowest_index

    x = np.array([[-0.0, 0.0, -0.0, 0.0, 1.0, -np.inf, np.nan, -1.0, 0.0, -0.0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 10)
    for dtype in (torch.float32, torch.float64):
        got_v, got_i = topk_lowest_index(torch.from_numpy(x).to(dtype), 10)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(np.signbit(got_v.float().numpy()), np.signbit(np.asarray(want_v)))
    row = np.tile(x[:, :4], (3, 40))
    got_v, got_i = tiled_topk(torch.from_numpy(row), 30, tile=16)
    want_v, want_i = jax.lax.top_k(jnp.asarray(row), 30)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    _, k1_i = masked_topk_scores_reference(torch.eye(1), torch.from_numpy(x[0, :4, None]), torch.zeros(1, 4, dtype=torch.bool), 4)
    np.testing.assert_array_equal(k1_i.numpy(), [[0, 1, 2, 3]])
