"""CFGAN: the port against the JAX package, on the CPU, in user and item mode.

The JAX draws are reproduced by replaying its key chain: PRNGKey(seed) splits
into (k_g, k_d, epoch_key); every epoch splits epoch_key into (epoch_key,
sub) and sub into the ZR and PM keys, each drawing a [padded, I] uniform.
The port takes the same initial weights through ``params_from_jax`` and the
same draws as its epoch uniforms.

Tolerances:
- forward, losses, scores and metrics on the same weights: 1e-6 (float32
  products and sums taken in another order);
- masks: bitwise (the same keys and k through an exact selection);
- one f32 epoch: 1e-5 on every parameter. Adam's first steps move each
  parameter by about lr * sign(gradient), which rounding does not change
  unless a gradient sits at rounding level;
- one bf16 epoch: 2.2 * lr per Adam step on every parameter (a bound), and
  the median difference within 5% of the median distance the epoch moved the
  tensor. The two frameworks round bf16 at other places, so a gradient near
  zero can change sign, and Adam's step is at most about lr
  (|m_hat / sqrt(v_hat)| <= 1.1 over these steps) in either direction;
- a 4-epoch fit: 1e-4 on the parameters, 1e-5 on the metrics;
- crash-resume (port only): rtol 1e-5, as the JAX package's own test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import CFGAN as JaxCFGAN
from ganmf_tpu.models import cfgan as jcf
from ganmf_tpu.models.gan_base import make_batches as jax_make_batches
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import CFGAN
from ganmf_tpu_torch.models import cfgan as pcf
from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer
from ganmf_tpu_torch.utils.dataio import DataIO
from test_torch_parallel import one_rank_gloo

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20, 50]
SEED = 42
KW = dict(
    d_nodes=8, g_nodes=16, d_layers=2, g_layers=1, scheme="ZP",
    d_hidden_act="tanh", g_hidden_act="tanh", d_lr=1e-3, g_lr=1e-3, d_reg=1e-4, g_reg=1e-4,
    d_batch_size=16, g_batch_size=32, zr_ratio=0.3, zp_ratio=0.2, zr_coefficient=0.05,
)
EPOCHS = 4
_FITTED = {}


def _shapes(train, mode):
    mat = train.T.tocsr() if mode == "item" else train
    n_rows, n_cols = mat.shape
    padded = max(jax_make_batches(n_rows, KW["d_batch_size"])[1],
                 jax_make_batches(n_rows, KW["g_batch_size"])[1])
    g_dims = [n_cols] + [KW["g_nodes"]] * KW["g_layers"] + [n_cols]
    d_dims = [2 * n_cols] + [KW["d_nodes"]] * KW["d_layers"] + [1]
    return mat, n_rows, n_cols, padded, g_dims, d_dims


def _jax_chain(mode, train):
    """JAX's initial leaves, and its per-epoch (ZR, PM) uniforms and keys."""
    _, _, n_cols, padded, g_dims, d_dims = _shapes(train, mode)
    k_g, k_d, ek = jax.random.split(jax.random.PRNGKey(SEED), 3)
    init = jcf.CFGANParams(G=jcf._init_mlp(k_g, g_dims), D=jcf._init_mlp(k_d, d_dims))
    draws, subs = [], []
    for _ in range(EPOCHS):
        ek, sub = jax.random.split(ek)
        k_zr, k_pm = jax.random.split(sub)
        subs.append(sub)
        draws.append(tuple(np.array(jax.random.uniform(k, (padded, n_cols))) for k in (k_zr, k_pm)))
    return init, draws, subs


def _fitted(mode, urm_pair):
    """The JAX model fitted once per mode, with its evaluation and chain."""
    if mode not in _FITTED:
        train, test = urm_pair
        jm = JaxCFGAN(train, mode=mode, seed=SEED, is_experiment=True)
        returned = jm.fit(**KW, epochs=EPOCHS, freq=1,
                          validation_evaluator=JaxEvaluatorHoldout(test, CUTOFFS))
        results, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jm)
        _FITTED[mode] = (jm, returned, results, _jax_chain(mode, train))
    return _FITTED[mode]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_model(mode, urm_pair, leaves):
    train, _ = urm_pair
    pm = CFGAN(train, mode=mode, seed=SEED, is_experiment=True, device=CPU)
    pm.config = dict(KW)
    pm.params = pcf.params_from_jax(leaves, KW["g_layers"], CPU)
    return pm


def _dense_padded(mat, padded, dtype=np.float32):
    out = np.zeros((padded, mat.shape[1]), np.float32)
    out[: mat.shape[0]] = mat.toarray()
    return out.astype(dtype)


def _assert_results_close(got, want, tol):
    assert list(got) == list(want)
    for c in want:
        assert list(got[c]) == list(want[c])
        for metric, value in want[c].items():
            assert got[c][metric] == pytest.approx(value, abs=tol, nan_ok=True), (c, metric)


# -- forward and losses ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["user", "item"])
@pytest.mark.parametrize("act", ["linear", "tanh", "sigmoid", "relu", "LeakyReLU"])
def test_forward_and_losses_match(mode, act, urm_pair):
    train, _ = urm_pair
    mat, n_rows, n_cols, padded, g_dims, d_dims = _shapes(train, mode)
    (init, draws, _) = _jax_chain(mode, train)
    p = pcf.params_from_jax(_leaves(init), KW["g_layers"], CPU)
    rng = np.random.RandomState(0)
    cond = _dense_padded(mat, padded)[:16]
    tmask = np.clip(cond + (rng.rand(*cond.shape) < 0.1), 0, 1).astype(np.float32)
    zmask = (rng.rand(*cond.shape) < 0.3).astype(np.float32)
    w = np.ones(16, np.float32)
    w[-3:] = 0.0
    tc, tt, tz, tw = (torch.from_numpy(a) for a in (cond, tmask, zmask, w))

    got = pcf._mlp(p.G, tc, act).detach().numpy()
    want = np.asarray(jcf._mlp(init.G, jnp.asarray(cond), act))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    dx = np.concatenate([cond, tmask], axis=1)
    np.testing.assert_allclose(pcf._mlp(p.D, torch.from_numpy(dx), act).detach().numpy(),
                               np.asarray(jcf._mlp(init.D, jnp.asarray(dx), act)), rtol=0, atol=1e-6)
    logits = rng.randn(16, 1).astype(np.float32) * 3
    for target in (0.0, 1.0):
        assert float(pcf._bce(torch.from_numpy(logits), target, tw)) == pytest.approx(
            float(jcf._bce(jnp.asarray(logits), target, jnp.asarray(w))), abs=1e-6)
    assert float(pcf._l2(p.G).detach()) == pytest.approx(float(jcf._l2(init.G)), rel=1e-6)
    assert float(pcf._l2(p.D).detach()) == pytest.approx(float(jcf._l2(init.D)), rel=1e-6)

    # the losses as JAX's epoch writes them (ganmf_tpu/models/cfgan.py:192-206)
    jc, jt, jz, jw = (jnp.asarray(a) for a in (cond, tmask, zmask, w))
    j_fake = jcf._mlp(init.G, jc, act) * jt
    want_d = (jcf._bce(jcf._mlp(init.D, jnp.concatenate([jc, jc], 1), act), 1.0, jw)
              + jcf._bce(jcf._mlp(init.D, jnp.concatenate([jc, j_fake], 1), act), 0.0, jw)
              + 1e-4 * jcf._l2(init.D))
    j_raw = jcf._mlp(init.G, jc, act)
    zr = jnp.sum(jnp.sum(j_raw**2 * jz, axis=1) * jw) / jnp.maximum(jnp.sum(jw), 1.0)
    want_g = (jcf._bce(jcf._mlp(init.D, jnp.concatenate([jc, j_raw * jt], 1), act), 1.0, jw)
              + 1e-4 * jcf._l2(init.G) + 0.05 * zr)
    got_d = pcf.d_loss(p.D, p.G, tc, tt, tw, 1e-4, act, act)
    got_g = pcf.g_loss(p.G, p.D, tc, tt, tz, tw, 1e-4, 0.05, act, act)
    assert float(got_d.detach()) == pytest.approx(float(want_d), abs=1e-6)
    assert float(got_g.detach()) == pytest.approx(float(want_g), abs=1e-6)


# -- masks ------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["user", "item"])
@pytest.mark.parametrize("scheme", ["ZR", "PM", "ZP"])
def test_negative_masks_bitwise(mode, scheme, urm_pair):
    train, _ = urm_pair
    mat, _, _, padded, _, _ = _shapes(train, mode)
    _, draws, subs = _jax_chain(mode, train)
    urm = _dense_padded(mat, padded)
    for epoch in (0, 1):
        jzr, jpm = jcf.sample_negative_masks(subs[epoch], jnp.asarray(urm), 0.3, 0.45, scheme)
        uniforms = tuple(torch.from_numpy(a) for a in draws[epoch])
        zr, pm = pcf.sample_negative_masks(torch.from_numpy(urm), 0.3, 0.45, scheme, uniforms=uniforms)
        np.testing.assert_array_equal(zr.numpy(), np.asarray(jzr))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))
        assert zr.dtype == torch.float32
    if scheme in ("ZR", "ZP"):
        n_zeros = (urm == 0).sum(1)
        np.testing.assert_array_equal(zr.numpy().sum(1), (n_zeros * np.float32(0.3)).astype(np.int32))


def test_negative_mask_count_is_a_float32_product():
    """12827 non-interactions at the published ZR ratio: the float32 product
    truncates to 5792, the float64 one to 5791. Both packages take 5792."""
    ratio = 0.4515475140394092
    assert int(np.float32(12827) * np.float32(ratio)) == 5792 and int(12827 * ratio) == 5791
    urm = np.zeros((1, 13000), np.float32)
    urm[0, np.random.RandomState(1).choice(13000, 173, replace=False)] = 1.0
    key = jax.random.PRNGKey(3)
    jzr, _ = jcf.sample_negative_masks(key, jnp.asarray(urm), ratio, 0.0, "ZR")
    u = np.array(jax.random.uniform(jax.random.split(key)[0], urm.shape))
    zr, _ = pcf.sample_negative_masks(torch.from_numpy(urm), ratio, 0.0, "ZR",
                                      uniforms=(torch.from_numpy(u), None))
    assert int(zr.sum()) == int(np.asarray(jzr).sum()) == 5792
    np.testing.assert_array_equal(zr.numpy(), np.asarray(jzr))


# -- one epoch ----------------------------------------------------------------------

def _one_epoch(mode, urm_pair, compute_dtype):
    train, _ = urm_pair
    mat, n_rows, n_cols, padded, _, _ = _shapes(train, mode)
    init, draws, subs = _jax_chain(mode, train)
    d_n, _ = jax_make_batches(n_rows, KW["d_batch_size"])
    g_n, _ = jax_make_batches(n_rows, KW["g_batch_size"])
    w = np.zeros(padded, np.float32)
    w[:n_rows] = 1.0
    urm = _dense_padded(mat, padded)
    statics = dict(scheme=KW["scheme"], d_hidden_act=KW["d_hidden_act"], g_hidden_act=KW["g_hidden_act"],
                   d_n_batches=d_n, d_batch=KW["d_batch_size"], g_n_batches=g_n,
                   g_batch=KW["g_batch_size"], d_steps=1, g_steps=1, compute_dtype=compute_dtype)
    jurm = jnp.asarray(urm, dtype=jnp.bfloat16 if compute_dtype == "bf16" else jnp.float32)
    want, _, _ = jcf.cfgan_epoch(
        init, jcf.ADAM.init(init.D), jcf.ADAM.init(init.G), jurm, subs[0], jnp.asarray(w), jnp.asarray(w),
        *(jnp.float32(v) for v in (KW["d_lr"], KW["g_lr"], KW["d_reg"], KW["g_reg"],
                                   KW["zr_ratio"], KW["zp_ratio"], KW["zr_coefficient"])),
        **statics)

    p = pcf.params_from_jax(_leaves(init), KW["g_layers"], CPU)
    d_opt = torch.optim.Adam(p.D.parameters(), lr=KW["d_lr"], betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
    g_opt = torch.optim.Adam(p.G.parameters(), lr=KW["g_lr"], betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
    turm = torch.from_numpy(urm)
    if compute_dtype == "bf16":
        turm = turm.to(torch.bfloat16)
    tw = torch.from_numpy(w)
    pcf.cfgan_epoch(p, d_opt, g_opt, turm, tuple(torch.from_numpy(a) for a in draws[0]), tw, tw,
                    d_reg=KW["d_reg"], g_reg=KW["g_reg"], zr_ratio=KW["zr_ratio"],
                    zp_ratio=KW["zp_ratio"], zr_coefficient=KW["zr_coefficient"], **statics)
    got = [t.detach().numpy() for t in p.parameters()]
    return got, _leaves(want), _leaves(init), d_n, g_n


@pytest.mark.parametrize("mode", ["user", "item"])
def test_one_epoch_f32_matches(mode, urm_pair):
    got, want, init, _, _ = _one_epoch(mode, urm_pair, "f32")
    for g, w_, i in zip(got, want, init):
        assert np.abs(w_ - i).max() > 1e-4  # every tensor moved
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["user", "item"])
def test_one_epoch_bf16_matches(mode, urm_pair):
    got, want, init, d_n, g_n = _one_epoch(mode, urm_pair, "bf16")
    n_g = 2 * (KW["g_layers"] + 1)
    for i, (g, w_, i0) in enumerate(zip(got, want, init)):
        steps, lr = (g_n, KW["g_lr"]) if i < n_g else (d_n, KW["d_lr"])
        diff = np.abs(g - w_)
        assert diff.max() <= 2 * 1.1 * lr * steps, i
        assert np.median(diff) <= 0.05 * np.median(np.abs(w_ - i0)), i


# -- the whole fit ---------------------------------------------------------------------

def _port_fit(mode, urm_pair, monkeypatch, setup=None, **extra):
    """The port's fit with JAX's initial weights and draws injected;
    ``setup(model)`` runs before the fit."""
    train, test = urm_pair
    _, _, _, (init, draws, _) = _fitted(mode, urm_pair)
    monkeypatch.setattr(pcf, "init_params", lambda g_dims, d_dims, generator, device:
                        pcf.params_from_jax(_leaves(init), KW["g_layers"], device))
    it = iter(draws)
    monkeypatch.setattr(pcf.CFGAN, "_epoch_uniforms",
                        lambda self, n_rows, n_cols, scheme: tuple(torch.from_numpy(a) for a in next(it)))
    pm = CFGAN(train, mode=mode, seed=SEED, is_experiment=True, device=CPU)
    if setup is not None:
        setup(pm)
    returned = pm.fit(**KW, epochs=EPOCHS, freq=1,
                      validation_evaluator=EvaluatorHoldout(test, CUTOFFS, device=CPU), **extra)
    return pm, returned


@pytest.mark.parametrize("mode", ["user", "item"])
def test_fit_matches(mode, urm_pair, monkeypatch):
    _, test = urm_pair
    jm, j_returned, j_results, _ = _fitted(mode, urm_pair)
    pm, returned = _port_fit(mode, urm_pair, monkeypatch)
    assert returned == j_returned
    for g, w_ in zip(pm.params.parameters(), _leaves(jm.params)):
        np.testing.assert_allclose(g.detach().numpy(), w_, rtol=0, atol=1e-4)
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(pm)
    _assert_results_close(got, j_results, tol=1e-5)


def test_metrics_logger_and_checkpoint_hooks(urm_pair, monkeypatch, tmp_path):
    """The training loop's hooks against the JAX package's (mirrors
    tests/test_aux.py:80-90): one epoch record per epoch, an eval record at
    every ``sample_every`` epochs with the JAX metrics within 1e-5, and a
    checkpoint every 2 epochs."""
    from ganmf_tpu.utils.checkpoint import TrainCheckpointer as JaxTrainCheckpointer
    from ganmf_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
    from ganmf_tpu.utils.logging import read_jsonl as jax_read_jsonl
    from ganmf_tpu_torch.utils.logging import MetricsLogger, read_jsonl

    train, test = urm_pair
    hooks = dict(validation_set=test, sample_every=2)
    jm = JaxCFGAN(train, seed=SEED, is_experiment=True)
    jm.metrics_logger = JaxMetricsLogger(str(tmp_path / "jax.jsonl"))
    jm.checkpointer = JaxTrainCheckpointer(str(tmp_path / "jax_ck"), every_n_epochs=2)
    jm.fit(**KW, epochs=EPOCHS, freq=1, validation_evaluator=JaxEvaluatorHoldout(test, CUTOFFS), **hooks)

    def setup(pm):
        pm.metrics_logger = MetricsLogger(str(tmp_path / "port.jsonl"))
        pm.checkpointer = TrainCheckpointer(str(tmp_path / "port_ck"), every_n_epochs=2)

    pm, _ = _port_fit("user", urm_pair, monkeypatch, setup=setup, **hooks)
    want = jax_read_jsonl(str(tmp_path / "jax.jsonl"))
    got = read_jsonl(str(tmp_path / "port.jsonl"))
    assert [(r["event"], r["epoch"]) for r in got] == [(r["event"], r["epoch"]) for r in want]
    assert sum(r["event"] == "epoch" for r in got) == EPOCHS
    assert sum(r["event"] == "eval" for r in got) == EPOCHS // 2
    for g, w_ in zip(got, want):
        assert sorted(g) == sorted(w_)
        if g["event"] == "eval":
            for key, value in w_.items():
                if "@" in key:
                    assert g[key] == pytest.approx(value, abs=1e-5, nan_ok=True), key
    assert pm.checkpointer.latest_epoch() == jm.checkpointer.latest_epoch() == EPOCHS


# -- ranking on carried-over weights ---------------------------------------------------

@pytest.mark.parametrize("mode", ["user", "item"])
def test_ranking_matches(mode, urm_pair):
    _, test = urm_pair
    jm, _, _, _ = _fitted(mode, urm_pair)
    pm = _port_model(mode, urm_pair, _leaves(jm.params))
    uids = np.arange(pm.n_users)
    np.testing.assert_allclose(pm.score_device(torch.from_numpy(uids)).numpy(),
                               np.asarray(jm.score_device(jnp.asarray(uids, dtype=jnp.int32))),
                               rtol=0, atol=1e-6)
    users = np.arange(10)
    assert pm.recommend(users) == jm.recommend(users)  # default cutoff: every unseen item
    assert pm.recommend(4) == jm.recommend(4)
    top = np.array([1, 5, 9, 33])
    custom = np.array([0, 3, 17, 40])
    for m in (jm, pm):
        m.filterTopPop_ItemsID = top
        m.set_items_to_ignore(custom)
    for kw in (dict(cutoff=7, items_to_compute=np.arange(0, pm.n_items, 3)),
               dict(cutoff=7, remove_CustomItems_flag=True),
               dict(cutoff=7, remove_top_pop_flag=True, remove_seen_flag=False),
               dict(cutoff=70)):
        assert pm.recommend(users, **kw) == jm.recommend(users, **kw), kw
    got_lists, got_scores = pm.recommend(users, cutoff=7, return_scores=True)
    want_lists, want_scores = jm.recommend(users, cutoff=7, return_scores=True)
    assert got_lists == want_lists
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=1e-6)

    want_idx, want_vals = jm.serve_all(cutoff=7)
    got_idx, got_vals = pm.serve_all(cutoff=7)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_allclose(got_vals, want_vals, rtol=0, atol=1e-6)
    sub = np.array([3, 0, 7, 7, 11, 49])
    want_idx, _ = jm.serve_all(cutoff=9, remove_seen_flag=False, user_id_array=sub, block=4)
    got_idx, _ = pm.serve_all(cutoff=9, remove_seen_flag=False, user_id_array=sub, block=4)
    np.testing.assert_array_equal(got_idx, want_idx)

    want, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jm)
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(pm)
    _assert_results_close(got, want, tol=1e-6)


# -- persistence --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["user", "item"])
def test_params_from_a_jax_savemodel_zip(mode, urm_pair, tmp_path):
    train, _ = urm_pair
    jm, _, _, _ = _fitted(mode, urm_pair)
    jm.saveModel(str(tmp_path), "jax_cfgan")
    data = DataIO(str(tmp_path)).load_data("jax_cfgan")
    params = pcf.params_from_jax(data, data["config"]["g_layers"], CPU)
    leaves = _leaves(jm.params)
    assert len(list(params.parameters())) == len(leaves) == 2 * (1 + 1) + 2 * (2 + 1)
    for got, want in zip(params.parameters(), leaves):
        np.testing.assert_array_equal(got.detach().numpy(), want)
    pm = CFGAN(train, mode=mode, device=CPU)
    pm.loadModel(str(tmp_path), "jax_cfgan")
    assert pm.mode == mode
    assert pm.recommend(np.arange(10), cutoff=7) == jm.recommend(np.arange(10), cutoff=7)
    pm.saveModel(str(tmp_path), "port_cfgan")
    again = DataIO(str(tmp_path)).load_data("port_cfgan")
    assert sorted(again) == sorted(data)
    for i in range(len(leaves)):
        np.testing.assert_array_equal(again[f"param_{i}"], data[f"param_{i}"])
    with pytest.raises(ValueError):
        pcf.params_from_jax(leaves[:-1], KW["g_layers"], CPU)


@pytest.mark.parametrize("mode", ["user", "item"])
def test_crash_resume_reproduces_the_run(mode, urm_pair, tmp_path):
    """A fit cut after epoch 4 resumes from its epoch-4 checkpoint (weights,
    both Adam states, the epoch generator) and ends where the uninterrupted
    fit ends (mirrors tests/test_aux.py:214-262)."""
    train, _ = urm_pair
    kwargs = dict(KW, epochs=6)

    full = CFGAN(train, mode=mode, seed=3, is_experiment=True, device=CPU)
    full.fit(**kwargs)

    m = CFGAN(train, mode=mode, seed=3, is_experiment=True, device=CPU)
    m.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    orig_loop = m._run_training_loop

    def cut_short(*args, epoch_fn, **kw):
        def wrapped(epoch):
            if epoch > 4:
                raise KeyboardInterrupt
            epoch_fn(epoch)

        return orig_loop(*args, epoch_fn=wrapped, **kw)

    m._run_training_loop = cut_short
    with pytest.raises(KeyboardInterrupt):
        m.fit(**kwargs)
    assert m.checkpointer.latest_epoch() == 4
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["ckpt_2.pt", "ckpt_4.pt"]

    m2 = CFGAN(train, mode=mode, seed=3, is_experiment=True, device=CPU)
    m2.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2, max_to_keep=1)
    m2.fit(**kwargs)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["ckpt_6.pt"]
    for got, want in zip(m2.params.parameters(), full.params.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_checkpointer_keeps_loss_histories(tmp_path):
    ck = TrainCheckpointer(str(tmp_path), every_n_epochs=3)
    state = {"params": {"w": torch.arange(4.0)}, "gen": torch.Generator().manual_seed(1).get_state()}
    assert not ck.maybe_save(2, state)
    assert ck.maybe_save(3, state, aux={"train_d_loss": [0.5, 0.25]})
    assert ck.latest_epoch() == 3
    back = ck.restore(3, state)
    assert torch.equal(back["params"]["w"], state["params"]["w"]) and torch.equal(back["gen"], state["gen"])
    np.testing.assert_array_equal(ck.restore_aux(3)["train_d_loss"], [0.5, 0.25])
    assert ck.restore_aux(2) is None


def test_fit_rejects_what_is_not_ported(urm_pair):
    """mesh_plan is ported: on a one-rank gloo plan the fit (ZP masks through
    K2's plain version) ends where the fit without a plan ends; an unknown
    storage still raises, and so does scoring an unfitted model."""
    train, _ = urm_pair
    m = CFGAN(train, device=CPU)
    with pytest.raises(ValueError):  # csr storage is ported (tests/test_torch_cfgan_csr.py)
        m.fit(urm_storage="coo", epochs=1)
    with pytest.raises(RuntimeError):
        CFGAN(train, device=CPU).score_device(torch.arange(3))
    kw = dict(KW, epochs=1, allow_worse=None, freq=None)
    with one_rank_gloo() as plan:
        m.fit(mesh_plan=plan, **kw)
        got = [t.detach().numpy() for t in m._full_params().parameters()]
        scores = m.score_device(torch.arange(5)).numpy()
    single = CFGAN(train, device=CPU)
    single.fit(**kw)
    for g, w_ in zip(got, single.params.parameters()):
        np.testing.assert_array_equal(g, w_.detach().numpy())
    np.testing.assert_allclose(scores, single.score_device(torch.arange(5)).numpy(), rtol=1e-6, atol=1e-7)
