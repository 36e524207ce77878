"""The port's IRGAN (models/irgan.py) against the JAX package's, on the CPU.

A seeded 60 x 45 binary split with a cold user. The port's epochs take their
Gumbel noise as an input; here it is JAX's, drawn by the JAX epochs' own key
splits (``jax.random.gumbel`` of the shapes ``jax.random.categorical`` draws:
[DNS_K, C, I] for pretraining, [C, I] for a D pass and [g_samples, C, I] for a
G pass). Tolerances:

- ``masked_logits``: the masked entries exactly -1e30, the rest within rtol
  1e-6 / atol 1e-7 of JAX's (a float32 product summed in another order);
  ``pairwise_update`` within rtol 1e-6 / atol 1e-7;
- one DNS pretraining epoch and one adversarial epoch (d_steps, g_steps in
  {1, 2}) from the same random state and JAX's noise: every tensor within
  rtol 1e-5 / atol 1e-6 (an argmax at a near tie would move a row by a whole
  update: none does at these sizes);
- fits from JAX's key chain (pre_train_epochs=2 and epochs=2, the
  ``epochs=0`` branch, and early stopping that restores its best epoch): the
  served factors within rtol 1e-4 / atol 1e-5 and every metric at cutoffs
  5/10/20/50 within 1e-6; crash resume and save/load bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.data.device import padded_csr_from_sparse as jax_padded
from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import IRGAN_Recommender as JaxIRGAN
from ganmf_tpu.models import irgan as ji
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import IRGAN_Recommender
from ganmf_tpu_torch.models import irgan as pi
from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer
from test_torch_itemknn import assert_metrics_close

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20, 50]
HYPER = dict(d_lr=0.05, g_lr=0.08, d_reg=1e-3, g_reg=2e-3, temperature=0.2)


def _split(seed=2):
    rng = np.random.RandomState(seed)
    full = (rng.rand(60, 45) < 0.15).astype(np.float32)
    held = (rng.rand(60, 45) < 0.25) & (full != 0)
    train, test = full * ~held, full * held
    train[3] = 0  # a cold user
    return sps.csr_matrix(train), sps.csr_matrix(test)


def _random_state(n_users, n_items, K=6, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: jnp.asarray((rng.uniform(-0.3, 0.3, s)).astype(np.float32))  # noqa: E731
    return ji._IRGANState(Gu=f(n_users, K), Gv=f(n_items, K), Gb=f(n_items), Du=f(n_users, K),
                          Dv=f(n_items, K), Db=f(n_items))


def _interactions(train, chunk, seed=4):
    coo = train.tocoo()
    order = np.random.RandomState(seed).permutation(coo.nnz)
    n_chunks = -(-coo.nnz // chunk)
    u = np.resize(coo.row[order], n_chunks * chunk).astype(np.int32)  # wrap-around padding
    i = np.resize(coo.col[order], n_chunks * chunk).astype(np.int32)
    return u, i, n_chunks


def _noise(keys, shape):
    return (torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32))) for k in keys)


def _assert_state_close(got, want, rtol=1e-5, atol=1e-6):
    for name, g, w in zip(pi.IRGANState._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol, err_msg=name)


def test_masked_logits_and_pairwise_update_match_jax():
    train, _ = _split()
    U, I = train.shape
    st = _random_state(U, I)
    pad_j = jax_padded(train, cache=False).idx
    pad = torch.from_numpy(np.array(pad_j, dtype=np.int64))
    u = np.arange(0, U, 2, dtype=np.int32)
    want_l, want_s = ji._masked_logits(st.Gu, st.Gv, st.Gb, jnp.asarray(u), pad_j, I, 0.2)
    p = pi.state_from_jax(st)
    got_l, got_s = pi.masked_logits(p.Gu, p.Gv, p.Gb, torch.from_numpy(u).long(), pad, I, 0.2)
    seen = train.toarray()[u] != 0
    assert np.all(got_l.numpy()[seen] == np.float32(pi.NEG_INF))
    np.testing.assert_array_equal(np.asarray(want_l) == np.float32(ji._NEG_INF), seen)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-7)

    # duplicate rows in the chunk: index_add_ sums them as .at[].add does
    rng = np.random.RandomState(1)
    uu, ii, jj = (rng.randint(0, n, 40).astype(np.int32) for n in (U, I, I))
    want = ji._pairwise_update(st.Du, st.Dv, st.Db, *map(jnp.asarray, (uu, ii, jj)), 0.05, 1e-3)
    Du, Dv, Db = p.Du.clone(), p.Dv.clone(), p.Db.clone()
    pi.pairwise_update(Du, Dv, Db, *(torch.from_numpy(a).long() for a in (uu, ii, jj)), 0.05, 1e-3)
    for g, w in zip((Du, Dv, Db), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_dns_pretrain_epoch_from_jax_noise():
    train, _ = _split()
    U, I = train.shape
    chunk, dns_k = 16, 5
    u, i, n_chunks = _interactions(train, chunk)
    pad_j = jax_padded(train, cache=False).idx
    st = _random_state(U, I)
    key = jax.random.PRNGKey(7)
    want = ji._dns_pretrain_epoch(st, jnp.asarray(u), jnp.asarray(i), pad_j, key, 0.05, 1e-3, 0.2,
                                  n_items=I, n_chunks=n_chunks, chunk=chunk, dns_k=dns_k)
    start = pi.state_from_jax(st)
    got = pi.dns_pretrain_epoch(
        start, torch.from_numpy(u).long(), torch.from_numpy(i).long(), torch.from_numpy(np.array(pad_j)).long(),
        _noise(jax.random.split(key, n_chunks), (dns_k, chunk, I)),  # JAX :120
        lr=0.05, reg=1e-3, temperature=0.2, n_items=I, chunk=chunk)
    _assert_state_close(got, want)
    assert not torch.equal(got.Gu, start.Gu) and torch.equal(got.Du, start.Du)
    for a, b in zip(start, pi.state_from_jax(st)):  # the input state stays as it was
        assert torch.equal(a, b)


@pytest.mark.parametrize("d_steps,g_steps", [(1, 1), (2, 1), (1, 2)])
def test_adversarial_epoch_from_jax_noise(d_steps, g_steps):
    train, _ = _split()
    U, I = train.shape
    chunk, S = 16, 4
    u, i, n_chunks = _interactions(train, chunk)
    pad_j = jax_padded(train, cache=False).idx
    st = _random_state(U, I)
    key = jax.random.PRNGKey(9)
    want = ji._adversarial_epoch(st, jnp.asarray(u), jnp.asarray(i), pad_j, key, *HYPER.values(),
                                 n_items=I, n_chunks=n_chunks, chunk=chunk, d_steps=d_steps, g_steps=g_steps,
                                 g_samples=S)
    k_d, k_g = jax.random.split(key)  # JAX :178-183
    d_noise = [_noise(jax.random.split(jax.random.fold_in(k_d, s), n_chunks), (chunk, I)) for s in range(d_steps)]
    g_noise = [_noise(jax.random.split(jax.random.fold_in(k_g, s), n_chunks), (S, chunk, I))
               for s in range(g_steps)]
    got = pi.adversarial_epoch(
        pi.state_from_jax(st), torch.from_numpy(u).long(), torch.from_numpy(i).long(),
        torch.from_numpy(np.array(pad_j)).long(), d_noise, g_noise, n_items=I, chunk=chunk, **HYPER)
    _assert_state_close(got, want)


def _jax_noise(monkeypatch, seed):
    """Make the port's fits draw JAX's noise: its key chain (one split an
    epoch from ``seed``, anew for each fit; JAX :259, :270, :292) through
    each epoch's own splits."""
    chain = {}

    def next_key(model):
        if chain.get("model") is not model:
            chain.update(model=model, key=jax.random.PRNGKey(seed))
        chain["key"], sub = jax.random.split(chain["key"])
        return sub

    def pretrain(self):
        keys = jax.random.split(next_key(self), self._n_chunks)
        return _noise(keys, (self._hp["DNS_K"], self._chunk, self.n_items))

    def adversarial(self):
        k_d, k_g = jax.random.split(next_key(self))
        n, C, I = self._n_chunks, self._chunk, self.n_items
        d = [_noise(jax.random.split(jax.random.fold_in(k_d, s), n), (C, I)) for s in range(self._hp["d_steps"])]
        g = [_noise(jax.random.split(jax.random.fold_in(k_g, s), n), (self._hp["g_samples"], C, I))
             for s in range(self._hp["g_steps"])]
        return d, g

    monkeypatch.setattr(IRGAN_Recommender, "_pretrain_noise", pretrain)
    monkeypatch.setattr(IRGAN_Recommender, "_adversarial_noise", adversarial)


FIT = dict(num_factors=5, batch_size=16, DNS_lr=0.05, D_lr=0.05, G_lr=0.05, g_samples=4, random_seed=13)


@pytest.mark.parametrize("pre_train_epochs,epochs,early_stopping", [(2, 2, False), (2, 0, False), (1, 5, True)])
def test_fit_matches_jax_key_chain(monkeypatch, pre_train_epochs, epochs, early_stopping):
    train, test = _split()
    es = {}
    if early_stopping:
        es = dict(validation_every_n=1, stop_on_validation=True, validation_metric="MAP",
                  lower_validations_allowed=1)
    params = dict(FIT, pre_train_epochs=pre_train_epochs, epochs=epochs)
    jax_model = JaxIRGAN(train)
    jax_model.fit(**params, **es, **(dict(evaluator_object=JaxEvaluatorHoldout(test, [5])) if es else {}))
    _jax_noise(monkeypatch, 13)
    model = IRGAN_Recommender(train, device=CPU)
    model.fit(**params, **es, **(dict(evaluator_object=EvaluatorHoldout(test, [5], device=CPU)) if es else {}))
    assert model.epochs_best == jax_model.epochs_best
    if early_stopping:  # the best epoch is not the last: its factors were restored
        assert model.epochs_best < epochs
    np.testing.assert_allclose(model.USER_factors, jax_model.USER_factors, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(model.ITEM_factors, jax_model.ITEM_factors, rtol=1e-4, atol=1e-5)
    assert model.USER_factors.shape[1] == 6 and np.all(model.USER_factors[:, -1] == 1)  # the bias fold
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(model)
    want, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jax_model)
    assert_metrics_close(got, want)


def test_crash_resume_save_and_load(tmp_path):
    train, _ = _split()
    params = dict(FIT, pre_train_epochs=1)
    full = IRGAN_Recommender(train, device=CPU)
    full.fit(epochs=4, **params)
    cut = IRGAN_Recommender(train, device=CPU)
    cut.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    cut.fit(epochs=2, **params)
    resumed = IRGAN_Recommender(train, device=CPU)
    resumed.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    resumed.fit(epochs=4, **params)
    for a, b in zip(resumed._state, full._state):
        assert torch.equal(a, b)

    full.saveModel(str(tmp_path), "irgan")
    loaded = IRGAN_Recommender(train, device=CPU)
    loaded.loadModel(str(tmp_path), "irgan")
    np.testing.assert_array_equal(loaded.ITEM_factors, full.ITEM_factors)
    users = np.arange(12)
    assert loaded.recommend(users, cutoff=10) == full.recommend(users, cutoff=10)


def test_mesh_plan_takes_the_jax_route():
    """Neither fit has a mesh_plan parameter: the keyword goes on to the
    early-stopping loop, which raises TypeError after the pretraining, and a
    fit with epochs=0 never reads it."""
    train, _ = _split()
    params = dict(num_factors=4, batch_size=64, pre_train_epochs=1, random_seed=3)
    for model in (JaxIRGAN(train), IRGAN_Recommender(train, device=CPU)):
        with pytest.raises(TypeError, match="mesh_plan"):
            model.fit(epochs=1, mesh_plan=object(), **params)
    jm, pm = JaxIRGAN(train), IRGAN_Recommender(train, device=CPU)
    jm.fit(epochs=0, mesh_plan=object(), **params)
    pm.fit(epochs=0, mesh_plan=object(), **params)
    assert jm.epochs_best == pm.epochs_best == 0


def test_own_noise_is_gumbel():
    """The port's draws: standard Gumbel (mean Euler's gamma, variance
    pi^2/6, each within 5 standard errors; the excess kurtosis is 5.4), the
    same from the same seed."""
    gen = torch.Generator().manual_seed(3)
    g = pi.gumbel((400_000,), gen).double()
    assert abs(float(g.mean()) - 0.5772156649) < 5 * np.sqrt(np.pi**2 / 6 / len(g))
    assert abs(float(g.var()) - np.pi**2 / 6) < 5 * np.sqrt(7.4 / len(g)) * np.pi**2 / 6
    again = pi.gumbel((400_000,), torch.Generator().manual_seed(3)).double()
    assert torch.equal(g, again)
