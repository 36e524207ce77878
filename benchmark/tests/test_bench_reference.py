"""The plain reference agrees with the port at a tiny size on the CPU: the
GANMF epoch (losses and all six tensors), the ranked lists, and the ~20
holdout metrics at every cutoff."""

import numpy as np
import pytest
import torch

from benchmark.data import ganmf_weights, movielens_shaped
from benchmark.reference import ranking, round_tf32
from benchmark.reference.ganmf import LEAVES, Trainer
from benchmark.tests import tiny  # noqa: F401
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models.ganmf import GANMF, GANMFParams

CPU = torch.device("cpu")
DATA = dict(tiny.TINY["config"]["data"], activity_lognormal=[4.0, 1.0], zipf_exponent=0.9, cluster_boost=60.0,
            test_share=0.2)


@pytest.mark.parametrize("storage,batch", [("dense", 64), ("csr", 48)])
def test_training_epochs_agree(storage, batch):
    r = movielens_shaped.generate(DATA, 21, CPU)
    fit = dict(num_factors=8, emb_dim=16, batch_size=batch, m=5, d_lr=3e-4, g_lr=2e-4, d_reg=1e-4, g_reg=1e-4,
               recon_coefficient=0.05)
    model = GANMF(r.train, mode="user", seed=77, device=CPU, is_experiment=True)
    model.fit(**fit, epochs=2, urm_storage=storage)
    ref = Trainer(r.train, fit, 77, CPU)
    losses = [ref.run_epoch() for _ in range(2)]
    np.testing.assert_allclose([float(x) for x in model.train_d_loss], [d for d, _ in losses], rtol=1e-5)
    np.testing.assert_allclose([float(x) for x in model.train_g_loss], [g for _, g in losses], rtol=1e-5)
    prog = dict(model.params.named_parameters())
    for k in LEAVES:
        torch.testing.assert_close(prog[k].detach(), ref.params[k], rtol=1e-4, atol=1e-6)


def _loaded(r, K=8, E=16):
    U, I = r.train.shape
    ts = ganmf_weights.make(U, I, K, E, r.user_cluster, r.item_cluster, 5, CPU)
    model = GANMF(r.train, mode="user", seed=5, device=CPU, is_experiment=True)
    model.params = GANMFParams(*[t.clone() for t in ts])
    return model, ts


def test_lists_agree():
    r = movielens_shaped.generate(DATA, 22, CPU)
    model, ts = _loaded(r)
    users = np.arange(0, r.train.shape[0], 7)
    _, ids = ranking.top_lists(ts[0], ts[1], r.train, users, 20)
    for u, row in zip(users, ids.numpy()):
        assert model.recommend(int(u), cutoff=20, remove_seen_flag=True) == row.tolist()
    served = [model.recommend(int(u), cutoff=20, remove_seen_flag=True) for u in users]
    assert ranking.list_gaps(served, users, ts[0], ts[1], r.train, 20).max() < 1e-6


def test_metrics_agree():
    r = movielens_shaped.generate(DATA, 23, CPU)
    model, ts = _loaded(r)
    cutoffs = [5, 10, 20, 50]
    res, _ = EvaluatorHoldout(r.test, cutoffs, minRatingsPerUser=1, exclude_seen=True, device=CPU) \
        .evaluateRecommender(model)
    users = np.flatnonzero(np.diff(r.test.indptr) >= 1)
    vals, ids = ranking.top_lists(ts[0], ts[1], r.train, users, 50)
    test_u = r.test[users]
    scores = ranking.pair_scores(ts[0], ts[1], np.repeat(users, np.diff(test_u.indptr)), test_u.indices)
    ref = ranking.holdout_metrics(ids.numpy(), np.isfinite(vals.numpy()), users, r.train, r.test, scores, cutoffs)
    assert set(res) == set(ref)
    for c in cutoffs:
        assert set(res[c]) == set(ref[c])
        for name, v in ref[c].items():
            assert res[c][name] == pytest.approx(v, rel=1e-5, abs=1e-9), (c, name)


def test_tf32_rounding():
    x = torch.randn(1000)
    y = round_tf32(x)
    assert ((x - y).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal(round_tf32(y), y) and not torch.equal(x, y)
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
