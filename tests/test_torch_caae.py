"""CAAE: the port against the JAX package, on the CPU.

The JAX package draws an epoch's randomness with ``jax.random`` inside its
jitted epoch; the port takes it as a ``CAAEDraws``. ``_jax_draws`` builds that
from a JAX key by the splits of ganmf_tpu/models/caae.py (:156, :241, :341,
:381, and the one inside ``_bucketed_cdf_sample``, :102), so both packages
compute from equal draws. The JAX initial weights go into the port through
``params_from_jax``. The model: 50 x 80 (tests/conftest.py's ``urm_pair``),
K=6, G and G' with two hidden layers of 16, chunks of 128 interactions
(the last padded), d_steps=2, g_steps = gpr_steps = 2, m_batch=8.

Tolerances:
- the samplers, on equal tables and uniforms: bitwise, at random uniforms
  and at exact edges (u * total equal to a cumulative value, u = 0, empty
  buckets); the tables themselves (cumulative sums in another order):
  rtol 1e-6;
- the negatives drawn from each package's own tables: equal (at this size no
  draw sits within rounding of a bucket edge, which the test asserts rather
  than assumes);
- the D phase alone (g_steps = gpr_steps = 0): 1e-6 relative to the largest
  element of each store (28 serial updates, each a few ulps apart);
- one full epoch from JAX's draws: the G-phase masks Nu equal, every tensor
  within 1e-4 of the distance the epoch moved it (measured: a few ulps of
  its scale, up to 3e-8, where G''s biases moved 7e-6 and D's stores 1e-2);
- a 3-epoch fit with early stopping at every epoch, from JAX's init and draws:
  parameters within 1e-4, every metric within 1e-5;
- K2's plain version on the negated Gumbel keys (+inf at the seen items),
  against JAX's ``smallest_k_mask``: bitwise;
- crash resume (the port alone): the resumed run is the uninterrupted one,
  bitwise on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import CAAE as JaxCAAE
from ganmf_tpu.models import caae as jca
from ganmf_tpu.ops.topk import smallest_k_mask as jax_smallest_k_mask
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import caae as pca
from ganmf_tpu_torch.models.caae import CAAE
from ganmf_tpu_torch.ops.topk import smallest_k_mask_reference
from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20, 50]
SEED = 5
KW = dict(d_steps=2, g_steps=2, gpr_steps=2, g_layers=2, g_units=16, num_factors=6, d_bsize=128,
          m_batch=8, lmbda=0.5, beta=0.01, lr=0.05, S=0.3)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _jax_draws(key, nnz_pad, n_users, n_items, n_d_draws, g_steps, gpr_steps, m, n_samples):
    """CAAEDraws from a JAX epoch key, split as caae_epoch splits it."""
    k_shuffle, k_d, k_g, k_gpr = jax.random.split(key, 4)
    d_u = []
    for kk in jax.random.split(k_d):
        d_u.append([jax.random.uniform(k, (n_d_draws,)) for k in jax.random.split(kk)])
    g_users, g_gumbel, g_sample = [], [], []
    for k in jax.random.split(k_g, g_steps):
        k1, k2, k3 = jax.random.split(k, 3)
        g_users.append(jax.random.permutation(k1, n_users)[:m])
        g_gumbel.append(jax.random.uniform(k2, (m, n_items), minval=1e-20))
        g_sample.append(jax.random.uniform(k3, (m * n_samples,)))
    gpr_users, gpr_sample = [], []
    for k in jax.random.split(k_gpr, gpr_steps):
        k1, k2 = jax.random.split(k)
        gpr_users.append(jax.random.randint(k1, (m,), 0, n_users))
        gpr_sample.append(jax.random.uniform(k2, (m * n_samples,)))

    def stack(xs, shape, dtype):
        return _t(np.stack(xs) if xs else np.zeros(shape), dtype)

    return pca.CAAEDraws(
        perm=_t(jax.random.permutation(k_shuffle, nnz_pad), np.int64),
        d_uniforms=_t(d_u, np.float32),
        g_users=stack(g_users, (0, m), np.int64),
        g_gumbel=stack(g_gumbel, (0, m, n_items), np.float32),
        g_sample=stack(g_sample, (0, m * n_samples), np.float32),
        gpr_users=stack(gpr_users, (0, m), np.int64),
        gpr_sample=stack(gpr_sample, (0, m * n_samples), np.float32),
    )


def _jax_init(n_users, n_items, kw=KW, seed=SEED):
    """The JAX fit's initial parameters and its first epoch key chain."""
    k_d, k_g, k_gpr, chain = jax.random.split(jax.random.PRNGKey(seed), 4)
    glorot = jax.nn.initializers.glorot_uniform()
    k_du, k_di = jax.random.split(k_d)
    dims = [n_items] + [kw["g_units"]] * kw["g_layers"] + [n_items]
    params = jca.CAAEParams(
        d_user_emb=glorot(k_du, (n_users, kw["num_factors"]), jnp.float32),
        d_item_emb=glorot(k_di, (n_items, kw["num_factors"]), jnp.float32),
        d_item_bias=jnp.zeros((n_items,), jnp.float32),
        G=jca._init_mlp(k_g, dims), Gpr=jca._init_mlp(k_gpr, dims))
    return params, chain


def _leaves(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def _epoch_inputs(train, kw=KW):
    coo = train.tocoo()
    n_chunks = int(np.ceil(coo.nnz / kw["d_bsize"]))
    pad = n_chunks * kw["d_bsize"] - coo.nnz
    inter = [np.concatenate([a, np.zeros(pad, a.dtype)]) for a in (coo.row, coo.col)]
    weight = np.concatenate([np.ones(coo.nnz, np.float32), np.zeros(pad, np.float32)])
    n_samples = max(1, 2 * int(np.median(np.ediff1d(train.indptr))))
    return inter[0].astype(np.int32), inter[1].astype(np.int32), weight, n_chunks, n_samples


def _run_both(train, kw, key):
    """(port params, JAX params, initial leaves, draws, port losses) after one
    epoch of each package from JAX's init and draws."""
    n_users, n_items = train.shape
    users, items, weight, n_chunks, n_samples = _epoch_inputs(train, kw)
    init, _ = _jax_init(n_users, n_items, kw)
    urm = train.toarray().astype(np.float32)
    statics = dict(d_bsize=kw["d_bsize"], n_d_chunks=n_chunks, d_steps=kw["d_steps"], g_steps=kw["g_steps"],
                   gpr_steps=kw["gpr_steps"], m_batch=kw["m_batch"], n_samples=n_samples)
    want = jca.caae_epoch(init, jnp.asarray(urm), jnp.asarray(users), jnp.asarray(items), jnp.asarray(weight),
                          key, jnp.float32(kw["lr"]), jnp.float32(kw["beta"]), jnp.float32(kw["lmbda"]),
                          jnp.float32(kw["S"]), **statics)
    draws = _jax_draws(key, len(users), n_users, n_items, kw["d_steps"] * n_chunks * kw["d_bsize"],
                       kw["g_steps"], kw["gpr_steps"], kw["m_batch"], n_samples)
    p = pca.params_from_jax(_leaves(init), CPU)
    losses = pca.caae_epoch(p, torch.from_numpy(urm), _t(users, np.int64), _t(items, np.int64), _t(weight),
                            draws, lr=kw["lr"], beta=kw["beta"], lmbda=kw["lmbda"], S=kw["S"], **statics)
    return [t.detach().numpy() for t in p.parameters()], _leaves(want), _leaves(init), draws, losses


def test_samplers_are_bitwise_on_equal_inputs():
    rng = np.random.RandomState(0)
    logits = rng.randn(20, 150).astype(np.float32) * 3
    logits[:, 140:] = -50.0  # a tail of near-zero probabilities
    prob = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=1))
    jb, jw = jca._bucketed_cdf_tables(jnp.asarray(prob), 64)  # 64 buckets of 3, the last ones padded
    pb, pw = pca.bucketed_cdf_tables(_t(prob), 64)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-6)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)

    rows = jnp.asarray(rng.randint(0, 20, 4000).astype(np.int32))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jca._bucketed_cdf_sample(jb, jw, rows, key, 64, 150))
    u1, u2 = (_t(jax.random.uniform(k, rows.shape)) for k in jax.random.split(key))
    got = pca.bucketed_cdf_sample(_t(jb), _t(jw), _t(rows, np.int64), u1, u2, 64, 150)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 100 and want.max() < 140

    cdf = jnp.cumsum(jnp.asarray(prob), axis=1)
    want = np.asarray(jca._cdf_sample(cdf, rows, key, 150))
    got = pca.cdf_sample(_t(cdf), _t(rows, np.int64), _t(jax.random.uniform(key, rows.shape)), 150)
    np.testing.assert_array_equal(got.numpy(), want)


def test_samplers_at_exact_cdf_edges(monkeypatch):
    """Uniforms that land exactly on a cumulative value (dyadic
    probabilities, so every sum is exact), u = 0, and buckets of zero
    probability: each draw is the first entry whose cdf reaches u * total,
    as in the JAX samplers, fed the same uniforms through a patched
    ``jax.random.uniform``."""
    rng = np.random.RandomState(2)
    counts = rng.randint(0, 12, (6, 150))
    counts[:, :9] = 0  # the first three buckets (of 3 items) are empty
    counts[:, -1] += 1024 - counts.sum(1)  # every row sums to 1024: its total is exactly 1
    prob = (counts / 1024).astype(np.float32)
    jb, jw = jca._bucketed_cdf_tables(jnp.asarray(prob), 64)
    bcdf, wcdf = np.asarray(jb), np.asarray(jw)
    assert (bcdf[:, -1] == 1.0).all()
    rows = np.repeat(np.arange(6), 8).astype(np.int32)
    u1 = bcdf[rows, rng.randint(0, 64, rows.shape)]  # u * total is a bucket's cdf exactly
    u1[::8] = 0.0
    u2 = rng.choice([0.0, 0.25, 0.5, 1.0 - 2**-24], rows.shape).astype(np.float32)
    fed = iter([u1, u2, u1])
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(next(fed)))
    want = np.asarray(jca._bucketed_cdf_sample(jb, jw, jnp.asarray(rows), jax.random.PRNGKey(0), 64, 150))
    got = pca.bucketed_cdf_sample(_t(bcdf), _t(wcdf), _t(rows, np.int64), _t(u1), _t(u2), 64, 150)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (prob[rows, want] > 0).mean() > 0.5
    cdf = np.cumsum(prob, axis=1, dtype=np.float32)
    want = np.asarray(jca._cdf_sample(jnp.asarray(cdf), jnp.asarray(rows), jax.random.PRNGKey(0), 150))
    got = pca.cdf_sample(_t(cdf), _t(rows, np.int64), _t(u1), 150)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k2_plain_version_on_negated_gumbel_keys():
    """The G phase's selection: -keys is +inf on seen items, the Gumbel keys
    elsewhere, with per-row k = int(n_nonint * S) <= n_nonint: the plain
    version is JAX's smallest_k_mask bitwise, and never selects a seen
    item."""
    rng = np.random.RandomState(1)
    seen = rng.rand(32, 371) < 0.1
    seen[0] = True  # a row with every item seen: k = 0
    keys = np.where(seen, -np.inf, np.log(rng.dirichlet(np.ones(371), 32)) + rng.gumbel(size=(32, 371)))
    keys = keys.astype(np.float32)
    n_nonint = (~seen).sum(1)
    k = pca.nu_sizes(torch.from_numpy(n_nonint), 0.3)
    got = smallest_k_mask_reference(torch.from_numpy(-keys), k).numpy()
    want = np.asarray(jax_smallest_k_mask(jnp.asarray(-keys), jnp.asarray(k.numpy())))
    np.testing.assert_array_equal(got, want)
    assert not (got & seen).any()
    np.testing.assert_array_equal(got.sum(1), k.numpy())


def test_k_u_is_a_float32_product():
    n = torch.tensor([12827, 3706, 0, 17])
    S = 0.4515475140394092
    got = pca.nu_sizes(n, S)
    want = np.asarray((jnp.asarray(n.numpy(), dtype=jnp.int32) * jnp.float32(S)).astype(jnp.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and int(got[0]) == 5792 and int(12827 * S) == 5791


def test_d_phase_matches_jax(urm_pair):
    """The D phase alone (no G or G' step): the serialized gather, gradient
    and index_add_ updates from the same draws, the negatives drawn from each
    package's own tables equal."""
    train, _ = urm_pair
    kw = dict(KW, g_steps=0, gpr_steps=0)
    key = jax.random.PRNGKey(11)
    got, want, init, draws, losses = _run_both(train, kw, key)
    for i in (0, 1, 2):
        assert np.abs(want[i] - init[i]).max() > 1e-3
        scale = np.abs(want[i]).max()
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=1e-6 * scale)
    for g, i0 in zip(got[3:], init[3:]):
        np.testing.assert_array_equal(g, i0)  # G and G' untouched
    assert np.isfinite(float(losses[0])) and float(losses[1]) == 0.0

    # the negatives: port tables and JAX tables, the same uniforms
    n_users, n_items = train.shape
    params, _ = _jax_init(n_users, n_items, kw)
    urm = jnp.asarray(train.toarray().astype(np.float32))
    rows = np.asarray(jnp.take(jnp.asarray(_epoch_inputs(train, kw)[0]),
                               jnp.asarray(draws.perm.numpy())))
    rows = np.tile(rows.reshape(-1, kw["d_bsize"]), (kw["d_steps"], 1)).reshape(-1)
    k_d = jax.random.split(key, 4)[1]
    p = pca.params_from_jax(_leaves(params), CPU)
    tables = [pca.bucketed_cdf_tables(torch.softmax(pca._autoencode(net, _t(urm)), dim=1)) for net in (p.G, p.Gpr)]
    got_neg = pca.d_phase_negatives(*tables, _t(rows, np.int64), draws.d_uniforms, n_items)
    for net, kk, neg in zip((params.G, params.Gpr), jax.random.split(k_d), got_neg):
        jt = jca._bucketed_cdf_tables(jax.nn.softmax(jca._autoencode(net, urm), axis=1), 64)
        want_neg = np.asarray(jca._bucketed_cdf_sample(*jt, jnp.asarray(rows), kk, 64, n_items))
        np.testing.assert_array_equal(neg.numpy(), want_neg)


def test_one_epoch_matches_jax(urm_pair, monkeypatch):
    """One full epoch from JAX's draws; the G phase's Nu masks (K2's plain
    version) are recorded on the way and equal JAX's selection."""
    train, _ = urm_pair
    masks = []
    real = pca.smallest_k_mask
    monkeypatch.setattr(pca, "smallest_k_mask", lambda keys, k: masks.append((keys, k)) or real(keys, k))
    got, want, init, draws, losses = _run_both(train, KW, jax.random.PRNGKey(12))
    assert len(masks) == KW["g_steps"]
    for step, (neg_keys, k) in enumerate(masks):
        seen = np.isposinf(neg_keys.numpy())
        assert seen.any() and (k.numpy() <= (~seen).sum(1)).all()
        np.testing.assert_array_equal(
            real(neg_keys, k).numpy(), np.asarray(jax_smallest_k_mask(jnp.asarray(neg_keys.numpy()),
                                                                        jnp.asarray(k.numpy()))))
    for i, (g, w_, i0) in enumerate(zip(got, want, init)):
        moved = np.abs(w_ - i0).max()
        assert moved > 0, i  # every tensor moved
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-4 * moved, err_msg=str(i))
    assert all(np.isfinite(float(x)) for x in losses)


def _inject(monkeypatch, seed):
    """JAX's init and epoch draws for the port's fit at ``seed``."""
    keys = {}

    def init(n_users, n_items, num_factors, g_dims, generator, device):
        kw = dict(KW, num_factors=num_factors, g_units=g_dims[1], g_layers=len(g_dims) - 2)
        params, keys["chain"] = _jax_init(n_users, n_items, kw, seed)
        return pca.params_from_jax(_leaves(params), device)

    def draws(self, nnz_pad, n_d_draws, g_steps, gpr_steps, m, n_samples):
        keys["chain"], sub = jax.random.split(keys["chain"])
        return _jax_draws(sub, nnz_pad, self.n_users, self.n_items, n_d_draws, g_steps, gpr_steps, m, n_samples)

    monkeypatch.setattr(pca, "init_params", init)
    monkeypatch.setattr(CAAE, "_epoch_draws", draws)


def test_fit_matches_jax(urm_pair, monkeypatch):
    train, test = urm_pair
    jm = JaxCAAE(train, seed=SEED, is_experiment=True)
    j_returned = jm.fit(**KW, epochs=3, freq=1, allow_worse=1, validation_evaluator=JaxEvaluatorHoldout(test, CUTOFFS))
    j_results, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jm)
    _inject(monkeypatch, SEED)
    pm = CAAE(train, seed=SEED, is_experiment=True, device=CPU)
    returned = pm.fit(**KW, epochs=3, freq=1, allow_worse=1,
                      validation_evaluator=EvaluatorHoldout(test, CUTOFFS, device=CPU))
    assert returned == j_returned
    for g, w_ in zip(pm.params.parameters(), _leaves(jm.params)):
        np.testing.assert_allclose(g.detach().numpy(), w_, rtol=0, atol=1e-4)
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(pm)
    for c in CUTOFFS:
        for metric, value in j_results[c].items():
            assert got[c][metric] == pytest.approx(value, abs=1e-5, nan_ok=True), (c, metric)
    assert pm.config == jm.config and pm.mode == "user"
    users = np.arange(12)
    assert pm.recommend_fused(users, cutoff=9) == pm.recommend(users, cutoff=9) == jm.recommend(users, cutoff=9)


def test_crash_resume_and_save_load(urm_pair, tmp_path):
    """A fit cut after epoch 2 resumes from its checkpoint (weights and the
    draws' generator) and ends where the uninterrupted fit ends; the saved
    zip loads back with the same scores."""
    train, _ = urm_pair
    kwargs = dict(KW, epochs=3)
    full = CAAE(train, seed=3, is_experiment=True, device=CPU)
    full.fit(**kwargs)

    m = CAAE(train, seed=3, is_experiment=True, device=CPU)
    m.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    orig_loop = m._run_training_loop

    def cut_short(*args, epoch_fn, **kw):
        def wrapped(epoch):
            if epoch > 2:
                raise KeyboardInterrupt
            epoch_fn(epoch)

        return orig_loop(*args, epoch_fn=wrapped, **kw)

    m._run_training_loop = cut_short
    with pytest.raises(KeyboardInterrupt):
        m.fit(**kwargs)
    m2 = CAAE(train, seed=3, is_experiment=True, device=CPU)
    m2.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    m2.fit(**kwargs)
    for got, want in zip(m2.params.parameters(), full.params.parameters()):
        np.testing.assert_array_equal(got.detach().numpy(), want.detach().numpy())

    users = torch.arange(train.shape[0])
    full.saveModel(str(tmp_path / "zip"))
    back = CAAE(train, device=CPU)
    back.loadModel(str(tmp_path / "zip"))
    np.testing.assert_array_equal(back.score_device(users).numpy(), full.score_device(users).numpy())
    jm = JaxCAAE(train)
    jm.loadModel(str(tmp_path / "zip"))
    leaves = [jnp.asarray(getattr(jm, f"param_{i}")) for i in range(int(jm._n_leaves[0]))]
    jm.params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(_jax_init(*train.shape)[0]), leaves)
    np.testing.assert_allclose(np.asarray(jm.score_device(jnp.arange(train.shape[0]))),
                               full.score_device(users).numpy(), rtol=1e-6, atol=1e-7)


def test_draws_and_what_is_not_ported(urm_pair):
    train, _ = urm_pair
    d = pca.draw_epoch(torch.Generator().manual_seed(0), CPU, 300, 50, 80, 1000, 3, 2, 8, 5)
    assert torch.equal(torch.sort(d.perm).values, torch.arange(300))
    for users in d.g_users:
        assert len(set(users.tolist())) == 8  # without replacement
    assert d.g_gumbel.min() >= 1e-20 and d.d_uniforms.shape == (2, 2, 1000)
    assert d.gpr_users.shape == (2, 8) and d.gpr_sample.shape == (2, 40)
    m = CAAE(train, device=CPU)
    assert m.mode == "user" and CAAE(train, mode="item", device=CPU).mode == "user"
    # d_scatter="dedup" is ported (tests/test_torch_caae_dedup.py)
    with pytest.raises(ValueError):
        m.fit(epochs=1, d_scatter="sorted")
    with pytest.raises(NotImplementedError):
        m.fit(epochs=1, mesh_plan=object())
