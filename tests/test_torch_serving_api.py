"""The serving and evaluation call surface of the JAX package, on the CPU.

``recommend_fused`` (ganmf_tpu/models/base.py:372-399, :642-671): a factor
model ranks through K1 and a cold user gets an empty list; any other model
returns ``recommend``'s lists. For every ported model, fitted for one epoch
on a split with three cold users (empty training rows), the lists equal
``recommend``'s at the same cutoff, with the seen items removed or not; for
GANMF and PureSVD they also equal the JAX package's on the same weights.

``EvaluatorHoldout`` takes the JAX positional order (URM_test, cutoff_list,
minRatingsPerUser, exclude_seen, diversity_object, ignore_items,
ignore_users, mesh_plan): the same positional call gives the same metrics in
both packages (within 1e-5, float32 sums in another order), and the two
arguments that are not ported raise.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import GANMF as JaxGANMF
from ganmf_tpu.models import ganmf as jgm
from ganmf_tpu.models import puresvd as jsvd
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import CAAE, CFGAN, GANMF, DisGANMF, PureSVDRecommender
from ganmf_tpu_torch.models import ganmf as pgm

CPU = torch.device("cpu")
COLD = [2, 9, 30]
CUTOFFS = [5, 10, 20]

FITS = {
    GANMF: dict(num_factors=4, emb_dim=8, epochs=1, batch_size=16),
    DisGANMF: dict(num_factors=4, d_nodes=8, epochs=1, batch_size=16),
    CFGAN: dict(d_nodes=8, g_nodes=16, epochs=1, d_batch_size=16, g_batch_size=16, zr_ratio=0.3),
    CAAE: dict(epochs=1, g_units=16, num_factors=4, d_bsize=64),
    PureSVDRecommender: dict(num_factors=5),
}


@pytest.fixture(scope="module")
def split():
    rng = np.random.RandomState(4)
    full = (rng.rand(40, 70) < 0.25).astype(np.float32)
    held = rng.rand(40, 70) < 0.2
    train, test = full * ~held, full * held
    train[COLD] = 0.0
    return sps.csr_matrix(train), sps.csr_matrix(test)


@pytest.mark.parametrize("model_class", list(FITS), ids=lambda c: c.__name__)
def test_recommend_fused_equals_recommend(model_class, split):
    train, _ = split
    if model_class is PureSVDRecommender:
        model = model_class(train, device=CPU)
    else:
        model = model_class(train, seed=1, is_experiment=True, device=CPU)
    model.fit(**FITS[model_class])
    users = np.arange(train.shape[0])
    factor_model = model._ranks_with_k1()
    assert factor_model == (model_class not in (CFGAN, CAAE))
    for flag in (True, False):
        for cutoff in (7, 20):
            got = model.recommend_fused(users, cutoff=cutoff, remove_seen_flag=flag)
            assert got == model.recommend(users, cutoff=cutoff, remove_seen_flag=flag)
            assert all(len(lst) == (0 if model_class is PureSVDRecommender and u in COLD else cutoff)
                       for u, lst in enumerate(got))
    # a single user: a factor model answers with one list in a list (JAX
    # :649), any other model as recommend does
    one = model.recommend_fused(5, cutoff=4)
    assert one == ([model.recommend(5, cutoff=4)] if factor_model else model.recommend(5, cutoff=4))
    assert model.recommend_fused(users[:3], cutoff=4, tile=128) == model.recommend(users[:3], cutoff=4)


def test_recommend_fused_matches_jax(split):
    """GANMF (every user warm, the JAX model falls back to recommend) and
    PureSVD (cold users get nothing, the JAX model ranks through its
    Pallas scorer) on the same weights."""
    train, _ = split
    jm = JaxGANMF(train, seed=2, is_experiment=True)
    jm.params = jgm._init_params(jax.random.PRNGKey(2), *train.shape, 4, 8)
    pm = GANMF(train, device=CPU)
    pm.params = pgm.params_from_jax([np.asarray(x) for x in jm.params], CPU)
    users = np.arange(train.shape[0])
    assert pm.recommend_fused(users, cutoff=10) == jm.recommend_fused(users, cutoff=10)
    assert all(len(lst) == 10 for lst in pm.recommend_fused(users, cutoff=10))

    js = jsvd.PureSVDRecommender(train)
    js.fit(num_factors=5, random_seed=3)
    ps = PureSVDRecommender(train, device=CPU)
    ps.fit(num_factors=5, omega=np.array(jax.random.normal(jax.random.PRNGKey(3), (train.shape[1], 15))))
    for flag in (True, False):
        got = ps.recommend_fused(users, cutoff=10, remove_seen_flag=flag)
        assert got == js.recommend_fused(users, cutoff=10, remove_seen_flag=flag)
        assert [got[u] for u in COLD] == [[], [], []]


def test_evaluator_takes_the_jax_positional_order(split):
    train, test = split
    jm = JaxGANMF(train, seed=2, is_experiment=True)
    jm.params = jgm._init_params(jax.random.PRNGKey(2), *train.shape, 4, 8)
    pm = GANMF(train, device=CPU)
    pm.params = pgm.params_from_jax([np.asarray(x) for x in jm.params], CPU)
    ignore_items, ignore_users = [0, 5, 6], [1, 3]
    args = (test, CUTOFFS, 1, True, None, ignore_items, ignore_users)
    ev = EvaluatorHoldout(*args, None, device=CPU)
    assert ev.ignore_items_flag and list(ev.ignore_items_ID) == ignore_items
    assert 1 not in ev.usersToEvaluate and 3 not in ev.usersToEvaluate
    got, _ = ev.evaluateRecommender(pm)
    want, _ = JaxEvaluatorHoldout(*args, None).evaluateRecommender(jm)
    for c in CUTOFFS:
        for metric, value in want[c].items():
            assert got[c][metric] == pytest.approx(value, abs=1e-5, nan_ok=True), (c, metric)
    plain, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(pm)
    assert plain[5]["COVERAGE_ITEM"] != got[5]["COVERAGE_ITEM"]  # the ignored items counted


def test_evaluator_rejects_what_is_not_ported(split):
    _, test = split
    # diversity_object is ported (tests/test_torch_eval_extras.py): it takes the fifth place
    assert EvaluatorHoldout(test, CUTOFFS, 1, True, np.eye(test.shape[1]), device=CPU).diversity_object is not None
    from ganmf_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="mesh plan"):  # the eighth place; a plan on another device
        EvaluatorHoldout(test, CUTOFFS, 1, True, None, None, None, make_mesh(device="meta"), device=CPU)
    with pytest.raises(TypeError):
        EvaluatorHoldout(test, CUTOFFS, 1, True, None, None, None, None, CPU)  # device is keyword-only
