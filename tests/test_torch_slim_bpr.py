"""The port's SLIM-BPR (models/slim_bpr.py) against the JAX package's, on the
CPU.

A seeded 150 x 60 binary split. Tolerances:

- one epoch from the same state (random W, caches and moments) and JAX's
  triples (``_draw_triples`` from one key), for each of the 4 ``sgd_mode``s
  with and without ``symmetric``: every tensor of the state within 8 ulps of
  its largest magnitude (x_uij's row sums run in another order, and the
  sigmoid carries that on); the Adam powers bitwise (JAX's binary
  exponentiation in float32); in practice the caches and moments are bitwise
  or 1-2 ulps off;
- the double top-K prune: bitwise (values, ids and the pruned matrix);
- a fit with early stopping from JAX's draws (its key chain replayed):
  ``epochs_best`` equal, W_sparse within rtol 1e-5 plus 1e-5 of its largest
  magnitude (``assert_topk_close``; six epochs carry the ulps of the first,
  and a weight near 0 loses its relative digits), every metric within 1e-6;
- the port's own draws: the rules of JAX's sampler (u warm, i in u's profile,
  j unseen unless all 8 candidates are seen, then the first candidate) and
  their distribution (uniform users, profile slots and unseen items, within 5
  standard deviations); crash resume reproduces the uninterrupted fit
  bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.models import SLIM_BPR as JaxSLIM
from ganmf_tpu.models import slim_bpr as js
from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import SLIM_BPR, SLIM_BPR_Cython
from ganmf_tpu_torch.models import slim_bpr as ps
from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer
from test_torch_itemknn import assert_metrics_close
from test_torch_similarity import assert_topk_close

torch.set_num_threads(1)
CPU = torch.device("cpu")
ULPS = 8
HYPER = dict(learning_rate=0.05, li_reg=2.93e-4, lj_reg=9.39e-9, gamma=0.995, beta_1=0.9, beta_2=0.999)


def _urm(n_users=150, n_items=60, seed=1):
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_users, n_items) < 0.15).astype(np.float32)
    dense[2] = 0  # a cold user
    return sps.csr_matrix(dense)


def _jax_tables(urm):
    lens = np.ediff1d(urm.indptr)
    warm = np.where((lens > 0) & (lens < urm.shape[1]))[0].astype(np.int32)
    pad = np.zeros((urm.shape[0], max(int(lens.max()), 1)), np.int32)
    for u in range(urm.shape[0]):
        pad[u, : lens[u]] = urm.indices[urm.indptr[u] : urm.indptr[u + 1]]
    return (jnp.asarray(urm.toarray()), jnp.asarray(warm), jnp.asarray(pad),
            jnp.asarray(np.maximum(lens, 1).astype(np.int32)))


def _random_state(n_items, seed=0):
    rng = np.random.RandomState(seed)
    return js._OptState(
        W=jnp.asarray((rng.randn(n_items, n_items) * 0.01).astype(np.float32)),
        cache=jnp.asarray((rng.rand(n_items) * 0.1).astype(np.float32)),
        m1=jnp.asarray((rng.randn(n_items) * 0.01).astype(np.float32)),
        m2=jnp.asarray((rng.rand(n_items) * 0.01).astype(np.float32)),
        beta1_t=jnp.asarray(np.float32(0.9) ** 3), beta2_t=jnp.asarray(np.float32(0.999) ** 3))


def _to_port(state):
    return ps.OptState(*[torch.from_numpy(np.array(x)) for x in state])


def assert_within_ulps(got, want, ulps=ULPS):
    want = np.asarray(want)
    scale = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_array_less(np.abs(got - want), ulps * scale + np.float32(0) + 1e-45)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("sgd_mode", ["adagrad", "rmsprop", "adam", "sgd"])
def test_one_epoch_from_jax_triples(sgd_mode, symmetric):
    urm = _urm()
    chunk = 16
    n_chunks = -(-urm.shape[0] // chunk)
    tables = _jax_tables(urm)
    key = jax.random.PRNGKey(3)
    triples = js._draw_triples(*tables, key, (n_chunks, chunk))
    state = _random_state(urm.shape[1])
    want = js._bpr_epoch(state, *tables, key, n_chunks=n_chunks, chunk=chunk, sgd_mode=sgd_mode,
                         symmetric=symmetric, presample=True, **HYPER)
    start = _to_port(state)
    got = ps.bpr_epoch(start, torch.from_numpy(urm.toarray()),
                       tuple(torch.from_numpy(np.array(t, dtype=np.int64)) for t in triples),
                       sgd_mode=sgd_mode, symmetric=symmetric, **HYPER)
    for name, g, w in zip(ps.OptState._fields, got, want):
        assert_within_ulps(g.numpy(), w)
        if name.startswith("beta"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the epoch leaves its input state as it was
    for a, b in zip(start, _to_port(state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 64, 65])
def test_integer_pow_matches_jax(n):
    for x in (0.9, 0.999, 0.5):
        want = jax.jit(lambda b: b ** n)(jnp.float32(x))
        assert np.float32(ps._integer_pow_f32(x, n)) == np.asarray(want)


@pytest.mark.parametrize("symmetric", [False, True])
def test_prune_matches_jax(symmetric):
    rng = np.random.RandomState(2)
    W = ((rng.rand(70, 70) < 0.4) * rng.randn(70, 70)).astype(np.float32)
    got = ps.prune_topk_device(torch.from_numpy(W), 9, symmetric)
    want = js._prune_topk_device(jnp.asarray(W), 9, symmetric)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_draws(monkeypatch, seed, presample=True, chunk=16):
    """Make the port's fit draw JAX's triples: JAX's key chain (one split an
    epoch, from ``seed`` at each new fit, whose generator is new) through
    ``_draw_triples``, in one pass (``presample``) or a key a chunk (JAX
    :144-152)."""
    state = {}

    def draw(tables, n, generator):
        if state.get("generator") is not generator:
            state["generator"], state["key"] = generator, jax.random.PRNGKey(seed)
        state["key"], sub = jax.random.split(state["key"])
        jt = _jax_tables(sps.csr_matrix(tables.urm.numpy()))
        if presample:
            parts = [js._draw_triples(*jt, sub, (n,))]
        else:
            parts = [js._draw_triples(*jt, k, (chunk,)) for k in jax.random.split(sub, n // chunk)]
        return tuple(torch.from_numpy(np.concatenate([np.array(p[t], dtype=np.int64) for p in parts]))
                     for t in range(3))

    monkeypatch.setattr(ps, "draw_triples", draw)


def test_fit_with_early_stopping_matches_jax(monkeypatch):
    urm = _urm()
    rng = np.random.RandomState(7)
    held = (rng.rand(*urm.shape) < 0.25) & (urm.toarray() != 0)
    train = sps.csr_matrix(urm.toarray() * ~held)
    test = sps.csr_matrix(held.astype(np.float32))
    params = dict(epochs=6, topK=12, learning_rate=0.05, lambda_i=1e-3, lambda_j=1e-4, chunk_size=16,
                  random_seed=11, symmetric=True, sgd_mode="adagrad", presample=True)
    es = dict(validation_every_n=1, stop_on_validation=True, validation_metric="MAP",
              lower_validations_allowed=2)
    jax_model = JaxSLIM(train)
    jax_model.fit(evaluator_object=JaxEvaluatorHoldout(test, [5]), **params, **es)
    _jax_draws(monkeypatch, 11)
    model = SLIM_BPR(train, device=CPU)
    model.fit(evaluator_object=EvaluatorHoldout(test, [5], device=CPU), **params, **es)
    assert model.epochs_best == jax_model.epochs_best
    scale = np.abs(jax_model.W_sparse.data).max()
    assert_topk_close(model.W_sparse, jax_model.W_sparse, 1e-5, atol=1e-5 * scale)
    np.testing.assert_array_equal(model.W_sparse.toarray(), model._device_w.numpy())
    got, _ = EvaluatorHoldout(test, [5, 10, 20, 50], device=CPU).evaluateRecommender(model)
    want, _ = JaxEvaluatorHoldout(test, [5, 10, 20, 50]).evaluateRecommender(jax_model)
    assert_metrics_close(got, want)


def test_draws_follow_jax_rules_and_distribution():
    rng = np.random.RandomState(0)
    dense = (rng.rand(40, 30) < 0.2).astype(np.float32)
    dense[0] = 0  # cold: never drawn
    dense[1] = 1  # has seen everything: not warm
    dense[2] = 1
    dense[2, 5] = 0  # has seen all but one item
    urm = sps.csr_matrix(dense)
    tables = ps.build_tables(urm, CPU)
    gen = torch.Generator().manual_seed(5)
    n = 200_000
    u, i, j = (t.numpy() for t in ps.draw_triples(tables, n, gen))
    lens = dense.sum(1)
    warm = np.where((lens > 0) & (lens < 30))[0]
    assert set(np.unique(u)) == set(warm)
    assert np.all(dense[u, i] == 1)  # i+ is in u's profile
    # uniform users, uniform profile slots
    counts = np.bincount(u, minlength=40)[warm]
    expect = n / len(warm)
    assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect))
    for user in warm[:5]:
        items = i[u == user]
        c = np.bincount(items, minlength=30)[dense[user] == 1]
        e = len(items) / lens[user]
        assert np.all(np.abs(c - e) < 5 * np.sqrt(e))
    # j- unseen, unless all 8 candidates were seen: then candidate 0, which is
    # uniform over the items; for user 2 that happens with p = (29/30)^8
    seen_j = dense[u, j] == 1
    u2 = u == 2
    p_all_seen = (29 / 30) ** 8
    m = u2.sum()
    assert abs(seen_j[u2].mean() - p_all_seen) < 5 * np.sqrt(p_all_seen * (1 - p_all_seen) / m)
    assert np.all(j[u2 & ~seen_j] == 5)
    # for other users j is uniform over their unseen items (the all-seen
    # chance is below 1e-4 at this density)
    user = warm[3]
    jj = j[(u == user) & ~seen_j]
    c = np.bincount(jj, minlength=30)[dense[user] == 0]
    e = len(jj) / (30 - lens[user])
    assert np.all(np.abs(c - e) < 5 * np.sqrt(e))
    # the same seed draws the same triples
    again = ps.draw_triples(tables, n, torch.Generator().manual_seed(5))
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(again, (u, i, j)))


def test_crash_resume_and_options(tmp_path):
    urm = _urm()
    params = dict(topK=10, learning_rate=0.05, chunk_size=16, random_seed=3)
    full = SLIM_BPR(urm, device=CPU)
    full.fit(epochs=6, **params)

    cut = SLIM_BPR(urm, device=CPU)
    cut.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    cut.fit(epochs=4, **params)
    assert cut.checkpointer.latest_epoch() == 4
    resumed = SLIM_BPR(urm, device=CPU)
    resumed.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    resumed.fit(epochs=6, **params)
    for a, b in zip(resumed._state, full._state):
        assert torch.equal(a, b)
    assert (resumed.W_sparse != full.W_sparse).nnz == 0

    # presample and train_with_sparse_weights change nothing; the reference's
    # name is the same class
    other = SLIM_BPR_Cython(urm, device=CPU)
    other.fit(epochs=6, presample=True, train_with_sparse_weights=True, **params)
    assert (other.W_sparse != full.W_sparse).nnz == 0
    # an object that is no plan fails as it fails JAX's fit; the 1 x 1 plan
    # trains bitwise as no plan
    from ganmf_tpu_torch.parallel import make_mesh

    with pytest.raises(AttributeError):
        JaxSLIM(urm).fit(epochs=1, mesh_plan=object())
    with pytest.raises(AttributeError):
        SLIM_BPR(urm, device=CPU).fit(epochs=1, mesh_plan=object())
    meshed = SLIM_BPR(urm, device=CPU)
    meshed.fit(epochs=6, mesh_plan=make_mesh(device="cpu"), **params)
    for a, b in zip(meshed._state, full._state):
        assert torch.equal(a, b)
    assert (meshed.W_sparse != full.W_sparse).nnz == 0
