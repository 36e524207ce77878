"""The serving slice as a whole: the port's GANMF against the JAX GANMF.

A JAX GANMF is fitted (num_factors=4, emb_dim=8, 2 epochs, seed 42) in user
and in item mode, and its parameters are carried into the port through
``params_from_jax``. The port must then give the JAX model's scores, lists
and metrics. The JAX evaluator ranks GANMF through its dense path
(``score_device`` + ``lax.top_k``); the port's ranks through K1, so the
evaluator comparison also holds the K1 routing to the reference.

Tolerance 1e-6 on scores and metrics: float32 dot products and sums taken in
another order. Lists must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import GANMF as JaxGANMF
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import GANMF, init_params, params_from_jax
from ganmf_tpu_torch.utils.dataio import DataIO

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20, 50]
_FITTED = {}


def _models(mode, urm_pair):
    """(jax model, port model) on the fixture's split; the JAX fit runs once
    per mode (the fixture's split is the same every time)."""
    train, _ = urm_pair
    if mode not in _FITTED:
        jm = JaxGANMF(train, mode=mode, seed=42, is_experiment=True)
        jm.fit(num_factors=4, emb_dim=8, epochs=2, batch_size=16)
        _FITTED[mode] = jm
    jm = _FITTED[mode]
    pm = GANMF(train, mode=mode, seed=42, is_experiment=True, device=CPU)
    pm.params = params_from_jax([np.asarray(p) for p in jm.params], CPU)
    return jm, pm


def _assert_results_close(got, want, tol=1e-6):
    assert list(got) == list(want)
    for c in want:
        assert list(got[c]) == list(want[c])  # metric order
        for metric, value in want[c].items():
            assert got[c][metric] == pytest.approx(value, abs=tol, nan_ok=True), (c, metric)


@pytest.mark.parametrize("mode", ["user", "item"])
def test_score_device_matches(mode, urm_pair):
    jm, pm = _models(mode, urm_pair)
    uids = np.arange(pm.n_users)
    want = np.asarray(jm.score_device(jnp.asarray(uids, dtype=jnp.int32)))
    got = pm.score_device(torch.from_numpy(uids)).numpy()
    assert got.shape == (pm.n_users, pm.n_items)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["user", "item"])
def test_recommend_lists_match(mode, urm_pair):
    jm, pm = _models(mode, urm_pair)
    users = np.arange(10)
    assert pm.recommend(users, cutoff=7) == jm.recommend(users, cutoff=7)
    assert pm.recommend(3, cutoff=5) == jm.recommend(3, cutoff=5)  # a single user
    custom = np.array([0, 3, 17, 40])
    jm.set_items_to_ignore(custom)
    pm.set_items_to_ignore(custom)
    for kw in (
        dict(remove_seen_flag=False),
        dict(items_to_compute=np.arange(0, pm.n_items, 2)),
        dict(remove_CustomItems_flag=True),
        dict(cutoff=None),  # every unseen item
    ):
        kw = {"cutoff": 7, **kw}
        assert pm.recommend(users, **kw) == jm.recommend(users, **kw), kw
    got_lists, got_scores = pm.recommend(users, cutoff=7, return_scores=True)
    want_lists, want_scores = jm.recommend(users, cutoff=7, return_scores=True)
    assert got_lists == want_lists
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["user", "item"])
def test_serve_all_matches(mode, urm_pair):
    jm, pm = _models(mode, urm_pair)
    want_idx, want_vals = jm.serve_all(cutoff=7)
    got_idx, got_vals = pm.serve_all(cutoff=7)
    assert got_idx.dtype == np.int32 and got_vals.dtype == np.float32
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_allclose(got_vals, want_vals, rtol=0, atol=1e-6)
    # a user subset in blocks smaller than the user count, and no seen filter
    users = np.array([3, 0, 7, 7, 11, 49])
    want_idx, want_vals = jm.serve_all(cutoff=7, remove_seen_flag=False, user_id_array=users, block=4)
    got_idx, got_vals = pm.serve_all(cutoff=7, remove_seen_flag=False, user_id_array=users, block=4)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_allclose(got_vals, want_vals, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["user", "item"])
def test_evaluator_matches(mode, urm_pair):
    """Every metric at every cutoff, K1 route against the JAX dense route."""
    _, test = urm_pair
    jm, pm = _models(mode, urm_pair)
    want, want_text = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jm)
    got, got_text = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(pm)
    _assert_results_close(got, want)
    assert [line.split(" - ")[0] for line in got_text.splitlines()] == \
        [line.split(" - ")[0] for line in want_text.splitlines()]


@pytest.mark.parametrize("mode", ["user", "item"])
def test_cutoffs_above_max_k_match(mode, urm_pair):
    """Above K1's fused limit of 64 (K1's wide form on the card; the fixture
    has 80 items, so a cutoff of 100 ranks them all): metrics, recommend
    lists and serve_all ids against the JAX GANMF."""
    _, test = urm_pair
    jm, pm = _models(mode, urm_pair)
    want, _ = JaxEvaluatorHoldout(test, [5, 20, 100]).evaluateRecommender(jm)
    got, _ = EvaluatorHoldout(test, [5, 20, 100], device=CPU).evaluateRecommender(pm)
    _assert_results_close(got, want)
    users = np.arange(pm.n_users)
    assert pm.recommend(users, cutoff=100) == jm.recommend(users, cutoff=100)
    assert pm.recommend(users, cutoff=70) == jm.recommend(users, cutoff=70)
    want_idx, want_vals = jm.serve_all(cutoff=100)
    got_idx, got_vals = pm.serve_all(cutoff=100)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_allclose(got_vals, want_vals, rtol=0, atol=1e-6)


def test_evaluator_ignore_items_users_and_padded_seen_rows(urm_pair, monkeypatch):
    _, test = urm_pair
    jm, pm = _models("user", urm_pair)
    kw = dict(ignore_items=[1, 2, 30], ignore_users=[0, 4])
    want, _ = JaxEvaluatorHoldout(test, CUTOFFS, **kw).evaluateRecommender(jm)
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU, **kw).evaluateRecommender(pm)
    _assert_results_close(got, want)
    assert not pm.items_to_ignore_flag  # reset after the evaluation
    # seen rows from padded-CSR storage, cropped per block, give the same metrics
    monkeypatch.setattr(GANMF, "_DENSE_URM_BYTE_LIMIT", 0)
    streamed, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU, **kw).evaluateRecommender(pm)
    assert pm._seen_padded is not None
    _assert_results_close(streamed, want)


@pytest.mark.parametrize("mode", ["user", "item"])
def test_params_from_a_jax_savemodel_zip(mode, urm_pair, tmp_path):
    jm, _ = _models(mode, urm_pair)
    train, _ = urm_pair
    jm.saveModel(str(tmp_path), "jax_ganmf")
    data = DataIO(str(tmp_path)).load_data("jax_ganmf")
    params = params_from_jax(data, CPU)
    for got, want in zip(params.parameters(), jm.params):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    # the port's loadModel reads the same zip
    pm = GANMF(train, mode=mode, device=CPU)
    pm.loadModel(str(tmp_path), "jax_ganmf")
    assert pm.mode == mode
    assert pm.recommend(np.arange(10), cutoff=7) == jm.recommend(np.arange(10), cutoff=7)
    # and the port writes the layout the JAX package writes
    pm.saveModel(str(tmp_path), "port_ganmf")
    again = DataIO(str(tmp_path)).load_data("port_ganmf")
    assert sorted(again) == sorted(data)
    for i in range(6):
        np.testing.assert_array_equal(again[f"param_{i}"], data[f"param_{i}"])


def test_init_params_and_snapshot(urm_pair):
    train, _ = urm_pair
    g = torch.Generator().manual_seed(5)
    p = init_params(50, 80, 4, 8, g, CPU)
    shapes = [tuple(t.shape) for t in p.parameters()]
    assert shapes == [(50, 4), (80, 4), (80, 8), (8,), (8, 80), (80,)]
    limit = np.sqrt(6.0 / (80 + 8))
    assert float(p.enc_w.detach().abs().max()) <= limit and not p.enc_b.detach().any()
    again = init_params(50, 80, 4, 8, torch.Generator().manual_seed(5), CPU)
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))

    pm = GANMF(train, device=CPU)
    pm.params = p
    pm.save_current_model()
    before = pm.recommend(np.arange(5), cutoff=5)
    with torch.no_grad():
        pm.params.user_emb.mul_(-1.0)
    assert pm.recommend(np.arange(5), cutoff=5) != before
    pm.load_model()
    assert pm.recommend(np.arange(5), cutoff=5) == before
    codes = pm.autoencoder_codes()
    assert codes.shape == (50, 8) and np.isfinite(codes).all()
    from ganmf_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="mesh plan"):  # a mesh plan on another device
        pm.fit(mesh_plan=make_mesh(device="meta"))
