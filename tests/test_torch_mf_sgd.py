"""The port's MF-SGD family (models/mf_sgd.py: BPR, FunkSVD, AsySVD) against
the JAX package's, on the CPU.

A seeded 120 x 50 split of ratings 1-5 with a cold user. Tolerances:

- one epoch from the same random state (factors, biases, AdaGrad caches) and
  JAX's presampled draws (``_draw_samples`` from ``_mf_epoch``'s own key and
  shape), for each algorithm x {adagrad, sgd} x {dense, csr} storage, with
  and without the bias terms where they apply: every tensor of the state
  within rtol 1e-5 / atol 1e-6 (float32 row sums and means in another
  order);
- a fit with early stopping from JAX's key chain (one split an epoch, both
  ``presample`` forms): ``epochs_best`` equal, factors and biases within
  rtol 1e-4 / atol 1e-5 (several epochs carry the first's ulps), every metric
  at cutoffs 5/10/20/50 within 1e-6;
- the port's own draws: JAX's rules (u warm, i in u's profile with its
  rating, j unseen unless all 8 candidates are seen, then the first), and
  csr storage against dense: the same draws and a bitwise equal fit; crash
  resume reproduces the uninterrupted fit bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.data.device import padded_csr_from_sparse as jax_padded
from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import mf_sgd as jm
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import (
    MatrixFactorization_AsySVD,
    MatrixFactorization_BPR,
    MatrixFactorization_FunkSVD,
)
from ganmf_tpu_torch.models import mf_sgd as pm
from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer
from test_torch_itemknn import assert_metrics_close

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20, 50]
CLASSES = {"bpr": MatrixFactorization_BPR, "funk_svd": MatrixFactorization_FunkSVD,
           "asy_svd": MatrixFactorization_AsySVD}


def _urm(n_users=120, n_items=50, seed=1):
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_users, n_items) < 0.2) * rng.randint(1, 6, (n_users, n_items))
    dense[2] = 0  # a cold user
    dense[5, :] = 1  # a user who has seen every item: j falls back to the first candidate
    return sps.csr_matrix(dense.astype(np.float32))


def _split(seed=7):
    urm = _urm()
    rng = np.random.RandomState(seed)
    held = (rng.rand(*urm.shape) < 0.25) & (urm.toarray() != 0)
    held[5] = False
    return sps.csr_matrix(urm.toarray() * ~held), sps.csr_matrix(urm.toarray() * held)


def _jax_tables(urm, storage):
    """JAX's sampling tables (mf_sgd.py:212-229)."""
    lens = np.ediff1d(urm.indptr)
    pc = jax_padded(urm, cache=False)
    dense = None if storage == "csr" else jnp.asarray(urm.toarray())
    return (dense, pc.val, jnp.asarray(np.where(lens > 0)[0].astype(np.int32)), pc.idx,
            jnp.asarray(np.maximum(lens, 1).astype(np.int32)))


def _random_state(n_users, n_items, K=6, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, a=0.1: jnp.asarray((rng.randn(*s) * a).astype(np.float32))  # noqa: E731
    return jm._MFState(U=f(n_users, K), V=f(n_items, K), bU=f(n_users), bV=f(n_items), bG=f(1),
                       cacheU=jnp.asarray(rng.rand(n_users).astype(np.float32)),
                       cacheV=jnp.asarray(rng.rand(n_items).astype(np.float32)))


def _to_torch(draws):
    return tuple(torch.from_numpy(np.array(d)).to(torch.float32 if n == 2 else torch.int64)
                 for n, d in enumerate(draws))


CASES = [(alg, mode, storage, bias)
         for alg in ("bpr", "funk_svd", "asy_svd")
         for mode in ("adagrad", "sgd")
         for storage in ("dense", "csr")
         for bias in ((False,) if alg == "bpr" else (False, True))]


@pytest.mark.parametrize("algorithm,sgd_mode,storage,use_bias", CASES)
def test_one_epoch_from_jax_draws(algorithm, sgd_mode, storage, use_bias):
    urm = _urm()
    chunk, n_chunks = 16, 12
    tables = _jax_tables(urm, storage)
    key = jax.random.PRNGKey(3)
    hyper = dict(learning_rate=0.02, user_reg=1e-3, item_reg=2e-3, bias_reg=5e-3)
    draws = jm._draw_samples(*tables, urm.shape[1], key, (n_chunks, chunk),
                             with_neg=algorithm == "bpr")
    state = _random_state(*urm.shape)
    want = jm._mf_epoch(state, *tables, key, *hyper.values(), n_items=urm.shape[1], n_chunks=n_chunks,
                        chunk=chunk, algorithm=algorithm, use_adagrad=sgd_mode == "adagrad",
                        use_bias=use_bias, presample=True)
    start = pm.state_from_jax(state)
    got = pm.mf_epoch(start, zip(*_to_torch(draws)), algorithm=algorithm, use_adagrad=sgd_mode == "adagrad",
                      use_bias=use_bias, **hyper)
    for name, g, w in zip(pm.MFState._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)
    moved = [name for name, g, s in zip(pm.MFState._fields, got, start) if not torch.equal(g, s)]
    assert moved == (["U", "V", "bU", "bV", "bG"] if use_bias else ["U", "V"]) + (
        ["cacheU", "cacheV"] if sgd_mode == "adagrad" else [])
    # the epoch leaves its input state as it was
    for a, b in zip(start, pm.state_from_jax(state)):
        assert torch.equal(a, b)


def _jax_draws(monkeypatch, seed, n_chunks, presample):
    """Make the port's fits draw JAX's samples: its key chain (one split an
    epoch from ``seed``, anew for each new generator, i.e. each fit) through
    ``_draw_samples``, in one pass (``presample``) or a key a chunk (JAX
    :157-166)."""
    state = {}

    def draw(tables, shape, with_neg, generator):
        if state.get("generator") is not generator:
            state.update(generator=generator, key=jax.random.PRNGKey(seed), pending=[])
        if not state["pending"]:
            state["key"], sub = jax.random.split(state["key"])
            state["pending"] = [sub] if presample else list(jax.random.split(sub, n_chunks))
        jt = (None if tables.urm is None else jnp.asarray(tables.urm.numpy()), jnp.asarray(tables.val.numpy()),
              jnp.asarray(tables.warm.numpy().astype(np.int32)), jnp.asarray(tables.profile.numpy().astype(np.int32)),
              jnp.asarray(tables.profile_len.numpy().astype(np.int32)))
        return _to_torch(jm._draw_samples(*jt, tables.n_items, state["pending"].pop(0), shape, with_neg))

    monkeypatch.setattr(pm, "draw_samples", draw)


@pytest.mark.parametrize("presample", [True, False])
@pytest.mark.parametrize("algorithm", ["bpr", "funk_svd", "asy_svd"])
def test_fit_with_early_stopping_matches_jax(monkeypatch, algorithm, presample):
    train, test = _split()
    params = dict(epochs=6, num_factors=5, learning_rate=0.05, batch_size=16, samples_per_epoch=200,
                  user_reg=1e-3, item_reg=1e-3, bias_reg=1e-2, random_seed=11, presample=presample)
    es = dict(validation_every_n=1, stop_on_validation=True, validation_metric="MAP",
              lower_validations_allowed=2)
    jax_model = getattr(jm, CLASSES[algorithm].__name__)(train)
    jax_model.fit(evaluator_object=JaxEvaluatorHoldout(test, [5]), **params, **es)
    _jax_draws(monkeypatch, 11, n_chunks=13, presample=presample)
    model = CLASSES[algorithm](train, device=CPU)
    model.fit(evaluator_object=EvaluatorHoldout(test, [5], device=CPU), **params, **es)
    assert model.epochs_best == jax_model.epochs_best
    assert model.use_bias == jax_model.use_bias == (algorithm != "bpr")
    close = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(model.USER_factors, jax_model.USER_factors, **close)
    np.testing.assert_allclose(model.ITEM_factors, jax_model.ITEM_factors, **close)
    if model.use_bias:
        np.testing.assert_allclose(np.asarray(model.USER_bias), jax_model.USER_bias, **close)
        np.testing.assert_allclose(np.asarray(model.ITEM_bias), jax_model.ITEM_bias, **close)
        assert model.GLOBAL_bias == pytest.approx(jax_model.GLOBAL_bias, rel=1e-4, abs=1e-5)
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(model)
    want, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jax_model)
    assert_metrics_close(got, want)


@pytest.mark.parametrize("storage", ["dense", "csr"])
def test_draws_follow_jax_rules(storage):
    urm = _urm()
    dense = urm.toarray()
    tables = pm.build_tables(urm, CPU, storage)
    n = 100_000
    u, i, r, j = (t.numpy() for t in pm.draw_samples(tables, (n,), True, torch.Generator().manual_seed(5)))
    lens = (dense != 0).sum(1)
    assert set(np.unique(u)) == set(np.where(lens > 0)[0])  # the warm users, the cold one never
    assert np.all(dense[u, i] != 0) and np.array_equal(r, dense[u, i])  # i in u's profile, with its rating
    counts = np.bincount(u, minlength=urm.shape[0])[lens > 0]
    expect = n / (lens > 0).sum()
    assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect))  # uniform users
    seen_j = dense[u, j] != 0
    assert np.all(seen_j[u == 5])  # user 5 has seen everything: j is the first candidate, uniform
    c = np.bincount(j[u == 5], minlength=urm.shape[1])
    e = (u == 5).sum() / urm.shape[1]
    assert np.all(np.abs(c - e) < 5 * np.sqrt(e))
    other = (u != 5) & seen_j  # all 8 candidates seen: under 1e-3 at this density
    assert other.mean() < 1e-3
    # the pointwise models draw no negative; both storages draw alike
    no_neg = pm.draw_samples(tables, (7, 3), False, torch.Generator().manual_seed(5))
    assert no_neg[0].shape == (7, 3) and not no_neg[3].any()
    other_storage = pm.build_tables(urm, CPU, "csr" if storage == "dense" else "dense")
    again = pm.draw_samples(other_storage, (n,), True, torch.Generator().manual_seed(5))
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(again, (u, i, r, j)))


@pytest.mark.parametrize("algorithm", ["bpr", "funk_svd", "asy_svd"])
def test_csr_storage_fits_bitwise_like_dense_and_resumes(algorithm, tmp_path, monkeypatch):
    train, _ = _split()
    params = dict(num_factors=4, learning_rate=0.05, batch_size=16, random_seed=3)
    cls = CLASSES[algorithm]
    full = cls(train, device=CPU)
    full.fit(epochs=6, **params)
    csr = cls(train, device=CPU)
    csr.fit(epochs=6, urm_storage="csr", **params)
    assert csr._tables.urm is None
    for a, b in zip(csr._state, full._state):
        assert torch.equal(a, b)

    monkeypatch.setattr(pm, "MEMBERSHIP_ELEMENTS", 64)  # the membership test in several slices
    cut = cls(train, device=CPU)
    cut.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    cut.fit(epochs=4, urm_storage="csr", **params)
    assert cut.checkpointer.latest_epoch() == 4
    resumed = cls(train, device=CPU)
    resumed.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    resumed.fit(epochs=6, urm_storage="csr", **params)
    for a, b in zip(resumed._state, full._state):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(resumed.USER_factors, full.USER_factors)
    # save and load keep the biases
    full.saveModel(str(tmp_path), "m")
    loaded = cls(train, device=CPU)
    loaded.loadModel(str(tmp_path), "m")
    users = np.arange(10)
    assert loaded.recommend(users, cutoff=10) == full.recommend(users, cutoff=10)


def test_options_follow_jax():
    train, _ = _split()
    # an object that is no plan fails as it fails JAX's fit; the 1 x 1 plan
    # trains bitwise as no plan
    from ganmf_tpu.models import MatrixFactorization_BPR as JaxBPR
    from ganmf_tpu_torch.parallel import make_mesh

    with pytest.raises(AttributeError):
        JaxBPR(train).fit(epochs=1, num_factors=3, mesh_plan=object())
    with pytest.raises(AttributeError):
        MatrixFactorization_BPR(train, device=CPU).fit(epochs=1, num_factors=3, mesh_plan=object())
    for cls in (MatrixFactorization_BPR, MatrixFactorization_AsySVD):
        cfg = dict(epochs=2, num_factors=3, batch_size=16)
        plain, meshed = cls(train, device=CPU), cls(train, device=CPU)
        plain.fit(**cfg)
        meshed.fit(mesh_plan=make_mesh(device="cpu"), **cfg)
        np.testing.assert_array_equal(meshed.USER_factors, plain.USER_factors)
        np.testing.assert_array_equal(meshed.ITEM_factors, plain.ITEM_factors)
        if cls is MatrixFactorization_AsySVD:
            np.testing.assert_array_equal(meshed.USER_bias, plain.USER_bias)
            assert meshed.GLOBAL_bias == plain.GLOBAL_bias
    with pytest.raises(ValueError, match="urm_storage"):
        MatrixFactorization_FunkSVD(train, device=CPU).fit(epochs=1, urm_storage="sparse")
    # samples_per_epoch defaults to max(n_users, nnz // 4) (JAX :259-260); the
    # starting factors are JAX's RandomState draws
    model = MatrixFactorization_AsySVD(train, device=CPU)
    model.fit(epochs=1, num_factors=3, batch_size=7, use_bias=False)
    assert model._n_chunks == -(-max(train.shape[0], train.nnz // 4) // 7)
    assert not model.use_bias and model.USER_bias is None
    rng = np.random.RandomState(1234)
    U0 = rng.normal(0, 0.1, (train.shape[0], 3)).astype(np.float32)
    cold = np.ediff1d(train.indptr) == 0
    np.testing.assert_array_equal(model.USER_factors[cold], U0[cold])  # never drawn
