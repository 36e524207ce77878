"""CFGAN's csr storage: the port against the JAX package and against its own
dense storage, on the CPU.

The JAX csr epoch draws a row's mask keys as uniform(fold_in(base, row))
with (base_ZR, base_PM) = split(sub), sub from the epoch-key chain; the
port's epoch (``csr_batch_inputs``, ``cfgan_epoch``) takes a
``row_uniforms(stream, rows)`` callable, which is given those draws, so both
packages compute from the same keys. Tolerances:
- no mask: the port's csr fit against its dense fit and against JAX's csr
  fit, rtol 1e-6 / atol 1e-7 (tests/test_models.py:424-457);
- with ZP masks, one epoch: masks bitwise (the same keys and k through an
  exact selection), parameters within 1e-5 as the dense one-epoch test
  (tests/test_torch_cfgan.py);
- the port's csr epoch against its dense epoch given the keyed uniforms as
  full planes: bitwise on the CPU (the same rows, masks and products);
- streamed scoring against dense scoring: 1e-6 (another product shape).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.models import CFGAN as JaxCFGAN
from ganmf_tpu.models import cfgan as jcf
from ganmf_tpu.data.device import padded_csr_from_sparse as jax_padded_csr
from ganmf_tpu.models.gan_base import make_batches
from ganmf_tpu_torch.data.device import padded_csr_from_sparse
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import CFGAN
from ganmf_tpu_torch.models import cfgan as pcf
from ganmf_tpu_torch.ops import keyed
from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 7
NOMASK = dict(d_nodes=8, g_nodes=8, scheme="ZR", zr_ratio=0.0, zr_coefficient=0.0, epochs=3,
              d_batch_size=16, g_batch_size=16, allow_worse=None, freq=None)
MASKED = dict(d_nodes=8, g_nodes=16, d_layers=2, g_layers=1, scheme="ZP", d_hidden_act="tanh",
              g_hidden_act="tanh", d_lr=1e-3, g_lr=1e-3, d_reg=1e-4, g_reg=1e-4, d_batch_size=16,
              g_batch_size=32, zr_ratio=0.3, zp_ratio=0.2, zr_coefficient=0.05)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _jax_init(mat, kw):
    n_cols = mat.shape[1]
    g_dims = [n_cols] + [kw.get("g_nodes", 32)] * kw.get("g_layers", 1) + [n_cols]
    d_dims = [2 * n_cols] + [kw.get("d_nodes", 32)] * kw.get("d_layers", 1) + [1]
    k_g, k_d, ek = jax.random.split(jax.random.PRNGKey(SEED), 3)
    return jcf.CFGANParams(G=jcf._init_mlp(k_g, g_dims), D=jcf._init_mlp(k_d, d_dims)), ek


def _jax_row_uniforms(ek, n_cols):
    """JAX's csr draws as the port's seam: epoch e's sub-key, split into the
    ZR and PM bases, each row's uniforms from fold_in(base, row)."""
    subs = {}

    def row_uniforms(epoch, stream, rows):
        nonlocal ek
        while len(subs) < epoch:
            ek, sub = jax.random.split(ek)
            subs[len(subs) + 1] = jax.random.split(sub)
        base = subs[epoch][stream]
        r = jnp.asarray(rows.numpy(), dtype=jnp.int32)
        u = jax.vmap(lambda u: jax.random.uniform(jax.random.fold_in(base, u), (n_cols,)))(r)
        return torch.from_numpy(np.array(u))

    return row_uniforms


def _inject_init(monkeypatch, init):
    monkeypatch.setattr(pcf, "init_params", lambda g_dims, d_dims, generator, device:
                        pcf.params_from_jax(_leaves(init), 1, device))


@pytest.mark.parametrize("mode", ["user", "item"])
def test_unmasked_csr_fit_matches_dense_and_jax(mode, urm_pair, monkeypatch):
    train, test = urm_pair
    mat = train.T.tocsr() if mode == "item" else train
    init, _ = _jax_init(mat, NOMASK)
    jm = JaxCFGAN(train, mode=mode, seed=SEED, is_experiment=True)
    jm.fit(urm_storage="csr", **NOMASK)
    _inject_init(monkeypatch, init)
    fits = {}
    for storage in ("csr", "dense"):
        fits[storage] = CFGAN(train, mode=mode, seed=SEED, is_experiment=True, device=CPU)
        fits[storage].fit(urm_storage=storage, **NOMASK)
    for got, dense, want in zip(fits["csr"].params.parameters(), fits["dense"].params.parameters(),
                                _leaves(jm.params)):
        got = got.detach().numpy()
        np.testing.assert_allclose(got, dense.detach().numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    ev = EvaluatorHoldout(test, [5, 10], device=CPU)
    res_c, _ = ev.evaluateRecommender(fits["csr"])
    res_d, _ = ev.evaluateRecommender(fits["dense"])
    for c in (5, 10):
        for metric, value in res_d[c].items():
            assert res_c[c][metric] == pytest.approx(value, abs=1e-9, nan_ok=True), (c, metric)


def _epoch_args(mat, kw):
    n_rows = mat.shape[0]
    d_n, d_pad = make_batches(n_rows, kw["d_batch_size"])
    g_n, g_pad = make_batches(n_rows, kw["g_batch_size"])
    padded = max(d_pad, g_pad)
    w = np.zeros(padded, np.float32)
    w[:n_rows] = 1.0
    statics = dict(scheme=kw["scheme"], d_hidden_act=kw["d_hidden_act"], g_hidden_act=kw["g_hidden_act"],
                   d_n_batches=d_n, d_batch=kw["d_batch_size"], g_n_batches=g_n,
                   g_batch=kw["g_batch_size"], d_steps=1, g_steps=1)
    scalars = dict(d_reg=kw["d_reg"], g_reg=kw["g_reg"], zr_ratio=kw["zr_ratio"], zp_ratio=kw["zp_ratio"],
                   zr_coefficient=kw["zr_coefficient"])
    return padded, w, statics, scalars


def _port_epoch(init, urm, uniforms, w, statics, scalars, compute_dtype="f32"):
    p = pcf.params_from_jax(_leaves(init), 1, CPU)
    d_opt = torch.optim.Adam(p.D.parameters(), lr=MASKED["d_lr"], betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
    g_opt = torch.optim.Adam(p.G.parameters(), lr=MASKED["g_lr"], betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
    tw = torch.from_numpy(w)
    pcf.cfgan_epoch(p, d_opt, g_opt, urm, uniforms, tw, tw, **scalars, **statics, compute_dtype=compute_dtype)
    return [t.detach().numpy().copy() for t in p.parameters()]


@pytest.mark.parametrize("mode", ["user", "item"])
def test_masked_csr_epoch_matches_jax_from_its_draws(mode, urm_pair):
    train, _ = urm_pair
    mat = train.T.tocsr() if mode == "item" else train
    n_rows, n_cols = mat.shape
    init, ek = _jax_init(mat, MASKED)
    _, sub = jax.random.split(ek)
    padded, w, statics, scalars = _epoch_args(mat, MASKED)
    want, _, _ = jcf.cfgan_epoch(
        init, jcf.ADAM.init(init.D), jcf.ADAM.init(init.G), jax_padded_csr(mat, cache=False), sub,
        jnp.asarray(w), jnp.asarray(w),
        *(jnp.float32(MASKED[k]) for k in ("d_lr", "g_lr", "d_reg", "g_reg", "zr_ratio", "zp_ratio",
                                           "zr_coefficient")),
        **statics)
    draws = _jax_row_uniforms(ek, n_cols)

    # the masks of one minibatch, bitwise against JAX's draw_rows
    pc = padded_csr_from_sparse(mat, CPU)
    cond, tmask, zr = pcf.csr_batch_inputs(pc, n_rows, n_cols, 16, 32, lambda s, r: draws(1, s, r),
                                           zr_ratio=MASKED["zr_ratio"], zp_ratio=MASKED["zp_ratio"],
                                           scheme="ZP", with_zr=True)
    k_zr, k_pm = jax.random.split(sub)
    rows = jnp.arange(16, 48, dtype=jnp.int32)
    jcond = np.asarray(mat[16:48].toarray(), np.float32)
    for key, ratio, got in ((k_zr, MASKED["zr_ratio"], zr), (k_pm, MASKED["zp_ratio"], tmask - cond)):
        u = jax.vmap(lambda u: jax.random.uniform(jax.random.fold_in(key, u), (n_cols,)))(rows)
        keys = jnp.where(jcond != 0, jnp.inf, u)
        k_u = (jnp.sum(jcond == 0, axis=1) * jnp.float32(ratio)).astype(jnp.int32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jcf.smallest_k_mask(keys, k_u), np.float32))
    np.testing.assert_array_equal(cond.numpy(), jcond)

    got = _port_epoch(init, pc, lambda s, r: draws(1, s, r), w, statics, scalars)
    for g, w_, i in zip(got, _leaves(want), _leaves(init)):
        assert np.abs(w_ - i).max() > 1e-4  # every tensor moved
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["user", "item"])
@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_csr_epoch_equals_dense_epoch_given_the_keyed_planes(mode, compute_dtype, urm_pair):
    train, _ = urm_pair
    mat = train.T.tocsr() if mode == "item" else train
    n_rows, n_cols = mat.shape
    init, _ = _jax_init(mat, MASKED)
    padded, w, statics, scalars = _epoch_args(mat, MASKED)
    dtype = torch.bfloat16 if compute_dtype == "bf16" else torch.float32

    def row_uniforms(stream, rows):
        return keyed.keyed_uniforms(SEED, 1, stream, rows, n_cols)

    pc = padded_csr_from_sparse(mat, CPU)
    pc = pc._replace(val=pc.val.to(dtype))
    got = _port_epoch(init, pc, row_uniforms, w, statics, scalars, compute_dtype)
    dense = torch.zeros((padded, n_cols))
    dense[:n_rows] = torch.from_numpy(mat.toarray())
    planes = tuple(row_uniforms(s, torch.arange(padded)) for s in (pcf.ZR_STREAM, pcf.PM_STREAM))
    want = _port_epoch(init, dense.to(dtype), planes, w, statics, scalars, compute_dtype)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


def _fit(train, mode, storage, **extra):
    m = CFGAN(train, mode=mode, seed=SEED, is_experiment=True, device=CPU)
    m.fit(urm_storage=storage, **dict(MASKED, epochs=2, **extra))
    return m


@pytest.mark.parametrize("g_layers", [1, 2, 0])
def test_item_mode_streamed_scoring_matches_dense(g_layers, urm_pair, monkeypatch):
    train, test = urm_pair
    m = _fit(train, "item", "csr", g_layers=g_layers)
    assert m._penult_cache is None
    users = torch.arange(train.shape[0])
    streamed = m.score_device(users)
    assert (m._penult_cache is None) == (g_layers == 0)
    monkeypatch.setattr(m, "_train_padded", None)  # the dense generator output
    dense = m.score_device(users)
    np.testing.assert_allclose(streamed.numpy(), dense.numpy(), rtol=0, atol=1e-6)
    monkeypatch.undo()
    m.params = m.params  # new parameters drop the cached activations
    assert m._penult_cache is None
    res, _ = EvaluatorHoldout(test, [5], device=CPU).evaluateRecommender(m)
    assert np.isfinite(res[5]["MAP"])


def test_user_mode_streamed_scoring_matches_dense(urm_pair, monkeypatch):
    train, _ = urm_pair
    m = _fit(train, "user", "csr")
    users = torch.tensor([0, 5, 3, 49])
    streamed = m.score_device(users)
    monkeypatch.setattr(m, "_train_padded", None)
    np.testing.assert_allclose(streamed.numpy(), m.score_device(users).numpy(), rtol=0, atol=1e-6)


def test_bf16_csr_is_deterministic(urm_pair):
    train, test = urm_pair
    a = _fit(train, "user", "csr", compute_dtype="bf16")
    b = _fit(train, "user", "csr", compute_dtype="bf16")
    for ga, gb in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(ga, gb)
    res, _ = EvaluatorHoldout(test, [5], device=CPU).evaluateRecommender(a)
    assert np.isfinite(res[5]["MAP"])
    c = _fit(train, "user", "csr", compute_dtype="bf16", zr_ratio=0.5)
    assert any(not torch.equal(x, y) for x, y in zip(a.params.parameters(), c.params.parameters()))


def test_crash_resume_redraws_the_masks(urm_pair, tmp_path, monkeypatch):
    """A csr fit cut after epoch 2 resumes from its checkpoint, whose keyed
    draws' epoch counter makes the resumed epochs draw the masks of the
    uninterrupted run: the two end bitwise equal."""
    train, _ = urm_pair
    kwargs = dict(MASKED, epochs=4, urm_storage="csr")
    full = CFGAN(train, seed=3, is_experiment=True, device=CPU)
    full.fit(**kwargs)

    m = CFGAN(train, seed=3, is_experiment=True, device=CPU)
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
    seen = []
    monkeypatch.setattr(pcf, "keyed_uniforms", lambda seed, e, s, r, n: seen.append(e) or
                        keyed.keyed_uniforms(seed, e, s, r, n))
    m2 = CFGAN(train, seed=3, is_experiment=True, device=CPU)
    m2.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    m2.fit(**kwargs)
    assert sorted(set(seen)) == [3, 4] and m2._mask_epoch == 4
    for got, want in zip(m2.params.parameters(), full.params.parameters()):
        assert torch.equal(got, want)


def test_keyed_draw_counts_and_rejections(urm_pair, monkeypatch):
    """The csr epoch draws PM once a D minibatch and ZR and PM once a G
    minibatch (scheme ZP), through the exact-k selection each time."""
    train, _ = urm_pair
    calls = []
    orig = pcf.smallest_k_mask
    monkeypatch.setattr(pcf, "smallest_k_mask", lambda keys, k: calls.append(keys.shape) or orig(keys, k))
    m = CFGAN(train, seed=3, is_experiment=True, device=CPU)
    m.fit(**dict(MASKED, epochs=1), urm_storage="csr")
    d_n, _ = make_batches(train.shape[0], MASKED["d_batch_size"])
    g_n, _ = make_batches(train.shape[0], MASKED["g_batch_size"])
    assert calls == [(16, 80)] * d_n + [(32, 80)] * (2 * g_n)
    with pytest.raises(ValueError, match="compute_dtype"):
        m.fit(epochs=1, urm_storage="csr", compute_dtype="f16")
    with pytest.raises(ValueError, match="urm_storage"):
        m.fit(epochs=1, urm_storage="coo")
