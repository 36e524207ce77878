"""GANMF training: the port against the JAX package, on the CPU.

The JAX initial weights go into the port through ``params_from_jax`` (the
port's ``init_params`` is monkeypatched), and both packages draw the epochs'
permutations from ``np.random.RandomState(seed)``, so the two runs start from
the same state and see the same minibatches. Batches of 12 pad both modes'
row counts (50 users, 80 items), so padding rows (row 0 at weight 0) are in
every run.

Tolerances:
- the forward pass and the losses on the same weights: 1e-6 (float32 products
  and sums taken in another order);
- one f32 epoch, in both modes, with dense and with lazy user Adam: 1e-5 on
  every parameter and on both mean losses. Adam's first steps move each
  element by about lr * sign(gradient), which rounding changes only where a
  gradient sits at rounding level;
- one bf16 epoch: CFGAN's bound (tests/test_torch_cfgan.py). Every parameter
  within 2.2 * lr per Adam step, and the median difference within 5% of the
  median distance the epoch moved the tensor: the two frameworks round bf16
  at other places, so a gradient near zero can change sign;
- a 4-epoch f32 fit with early stopping at every epoch: 1e-4 on the
  parameters, 1e-5 on the loss histories and on every metric at cutoffs
  5/10/20/50, and the same return value;
- csr against dense storage in the port: rtol 1e-6 / atol 1e-7 in f32, rtol
  1e-5 / atol 1e-7 in bf16, and metrics within 1e-9 (the JAX package's own
  tests, tests/test_models.py:224-283); the port's csr fit against JAX's: 1e-4
  in f32, the bf16 bound in bf16;
- crash resume (the port alone): the resumed run ends where the
  uninterrupted one ends, rtol 1e-6 / atol 1e-7 as in tests/test_aux.py:93,
  and so do its loss histories (rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import GANMF as JaxGANMF
from ganmf_tpu.models import ganmf as jgm
from ganmf_tpu.models.gan_base import make_batches as jax_make_batches
from ganmf_tpu.models.gan_base import shuffled_padded_perm as jax_shuffled_padded_perm
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import CFGAN, GANMF
from ganmf_tpu_torch.models import ganmf as pgm
from ganmf_tpu_torch.models.gan_base import shuffled_padded_perm
from ganmf_tpu_torch.utils import analysis
from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20, 50]
SEED = 42
KW = dict(num_factors=4, emb_dim=8, batch_size=12, d_lr=1e-3, g_lr=2e-3, d_reg=1e-4, g_reg=1e-4,
          m=1.5, recon_coefficient=0.2)
EPOCHS = 4
_FITTED = {}


def _jax_init(n_rows, n_cols, num_factors=KW["num_factors"], emb_dim=KW["emb_dim"]):
    return jgm._init_params(jax.random.PRNGKey(SEED), n_rows, n_cols, num_factors, emb_dim)


def _leaves(params):
    return [np.asarray(p) for p in params]


def _inject_jax_init(monkeypatch):
    monkeypatch.setattr(pgm, "init_params", lambda n_rows, n_cols, k, e, generator, device:
                        pgm.params_from_jax(_leaves(_jax_init(n_rows, n_cols, k, e)), device))


def _matrix(train, mode):
    return train.T.tocsr() if mode == "item" else train


def _assert_results_close(got, want, tol):
    assert list(got) == list(want)
    for c in want:
        assert list(got[c]) == list(want[c])
        for metric, value in want[c].items():
            assert got[c][metric] == pytest.approx(value, abs=tol, nan_ok=True), (c, metric)


# -- forward and losses ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["user", "item"])
def test_forward_and_losses_match(mode, urm_pair):
    mat = _matrix(urm_pair[0], mode)
    n_rows, n_cols = mat.shape
    init = _jax_init(n_rows, n_cols)
    p = pgm.params_from_jax(_leaves(init), CPU)
    real = mat.toarray()[:12].astype(np.float32)
    uids = np.arange(12, dtype=np.int32)[::-1].copy()
    w = np.ones(12, np.float32)
    w[-3:] = 0.0
    tu, tr, tw = torch.from_numpy(uids.astype(np.int64)), torch.from_numpy(real), torch.from_numpy(w)
    ju, jr, jw = jnp.asarray(uids), jnp.asarray(real), jnp.asarray(w)

    for got, want in zip(p.autoencode(tr), jgm._autoencode(init, jr)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    b = tr.flip(0) * 0.5
    assert float(pgm._masked_mse(tr, b, tw)) == pytest.approx(
        float(jgm._masked_mse(jr, jnp.asarray(b.numpy()), jw)), abs=1e-6)
    assert float(pgm._masked_mse(tr, b, torch.zeros(12))) == 0.0  # no valid row: 0, not nan
    assert float(pgm._l2(p.d_params()).detach()) == pytest.approx(float(jgm._l2(jgm._d_params(init))), rel=1e-6)

    for reg in (0.0, 1e-3):
        want_d, want_g = jgm._losses(init, ju, jr, jw, 1.5, 0.2, reg, reg)
        got_d, got_g = pgm._losses(p, tu, tr, tw, 1.5, 0.2, reg, reg)
        assert float(got_d.detach()) == pytest.approx(float(want_d), abs=1e-6)
        assert float(got_g.detach()) == pytest.approx(float(want_g), abs=1e-6)
    # bf16 forward against bf16 master weights: the same casts, losses in f32
    want_d, want_g = jgm._losses(init, ju, jr, jw, 1.5, 0.2, 1e-3, 1e-3, compute_dtype=jnp.bfloat16)
    got_d, got_g = pgm._losses(p, tu, tr, tw, 1.5, 0.2, 1e-3, 1e-3, dtype=torch.bfloat16)
    assert got_d.dtype == got_g.dtype == torch.float32
    assert float(got_d.detach()) == pytest.approx(float(want_d), rel=2e-2)
    assert float(got_g.detach()) == pytest.approx(float(want_g), rel=2e-2)


def test_shuffle_and_user_adam_forms(urm_pair):
    """The epoch shuffle is the JAX package's draw for draw; TF1's Adam in
    both forms is the JAX update (:121-131, :199-208) on the same inputs."""
    a, b = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(3):
        np.testing.assert_array_equal(shuffled_padded_perm(a, 50, 60), jax_shuffled_padded_perm(b, 50, 60))

    rng = np.random.RandomState(0)
    param, grad = rng.randn(2, 6, 3).astype(np.float32)
    mask = np.array([0, 1, 0, 1, 1, 0], np.float32)
    for lazy in (False, True):
        p = torch.from_numpy(param.copy())
        state = pgm.user_adam_state(p)
        jp, jm, jv, jt = jnp.asarray(param), jnp.zeros_like(param), jnp.zeros_like(param), jnp.float32(0.0)
        for step in range(3):
            g = grad * (step + 1)
            pgm.tf1_adam_(p, torch.from_numpy(g), state, 1e-2, torch.from_numpy(mask) if lazy else None)
            jt = jt + 1.0
            if lazy:
                jp, jm, jv = jgm._lazy_adam_rows(jp, jnp.asarray(g), jm, jv, jnp.asarray(mask), 1e-2, jt)
            else:
                jm = 0.9 * jm + 0.1 * g
                jv = 0.999 * jv + 0.001 * g**2
                jp = jp - 1e-2 * jnp.sqrt(1 - 0.999**jt) / (1 - 0.9**jt) * jm / (jnp.sqrt(jv) + 1e-8)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
        np.testing.assert_allclose(state["v"].numpy(), np.asarray(jv), rtol=1e-6, atol=0)
        assert float(state["t"]) == 3.0
        moved = np.abs(p.numpy() - param).max(1) > 0
        np.testing.assert_array_equal(moved, mask > 0 if lazy else np.ones(6, bool))


# -- one epoch ----------------------------------------------------------------------

def _one_epoch(mode, urm_pair, lazy, compute_dtype, storage="dense"):
    """(port params, JAX params, initial params, port losses, JAX losses,
    n_batches) after one epoch from JAX's init on the same permutation;
    d_steps=2 so that D passes over the batches twice."""
    mat = _matrix(urm_pair[0], mode)
    n_rows, n_cols = mat.shape
    bs = KW["batch_size"]
    n_batches, padded = jax_make_batches(n_rows, bs)
    perm = jax_shuffled_padded_perm(np.random.RandomState(SEED), n_rows, padded)
    w = np.zeros(padded, np.float32)
    w[:n_rows] = 1.0
    init = _jax_init(n_rows, n_cols)
    statics = dict(n_batches=n_batches, batch_size=bs, d_steps=2, g_steps=1, lazy_user_adam=lazy,
                   compute_dtype=compute_dtype)
    scalars = dict(m=KW["m"], recon_coefficient=KW["recon_coefficient"], d_reg=KW["d_reg"], g_reg=KW["g_reg"])
    cd = jnp.bfloat16 if compute_dtype == "bf16" else jnp.float32
    g_state = (jgm.ADAM.init((init.item_emb,)), jnp.zeros_like(init.user_emb),
               jnp.zeros_like(init.user_emb), jnp.float32(0.0))
    want, _, _, jdl, jgl = jgm.ganmf_epoch(
        init, jgm.ADAM.init(jgm._d_params(init)), g_state, jnp.asarray(mat.toarray(), dtype=cd),
        jnp.asarray(perm), jnp.asarray(w), jnp.float32(KW["d_lr"]), jnp.float32(KW["g_lr"]),
        **scalars, **statics)

    p = pgm.params_from_jax(_leaves(init), CPU)
    d_opt = torch.optim.Adam(p.d_params(), lr=KW["d_lr"], betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
    item_opt = torch.optim.Adam([p.item_emb], lr=KW["g_lr"], betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
    if storage == "csr":
        urm = pgm.padded_csr_from_sparse(mat, CPU)
        if compute_dtype == "bf16":
            urm = urm._replace(val=urm.val.to(torch.bfloat16))
    else:
        urm = torch.from_numpy(mat.toarray().astype(np.float32))
        if compute_dtype == "bf16":
            urm = urm.to(torch.bfloat16)
    user_state = pgm.user_adam_state(p.user_emb)
    dl, gl = pgm.ganmf_epoch(p, d_opt, item_opt, user_state, urm,
                             torch.from_numpy(perm.astype(np.int64)), torch.from_numpy(w),
                             g_lr=KW["g_lr"], **scalars, **statics)
    assert float(user_state["t"]) == n_batches  # one TF1 step per G minibatch
    got = [t.detach().numpy() for t in p.parameters()]
    return got, _leaves(want), _leaves(init), (float(dl), float(gl)), (float(jdl), float(jgl)), n_batches


@pytest.mark.parametrize("lazy", [False, True], ids=["dense_adam", "lazy_adam"])
@pytest.mark.parametrize("mode", ["user", "item"])
def test_one_epoch_f32_matches(mode, lazy, urm_pair):
    got, want, init, losses, jlosses, _ = _one_epoch(mode, urm_pair, lazy, "f32")
    for g, w_, i in zip(got, want, init):
        assert np.abs(w_ - i).max() > 1e-4  # every tensor moved
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    # the dense TF1 form moves rows outside the batch through their moments
    # only once they have been in one; the lazy form never does
    assert np.abs(got[0] - init[0]).min(1).max() > 0


def _assert_within_bf16_bound(got, want, init, n_batches, d_steps=2, g_steps=1):
    for i, (g, w_, i0) in enumerate(zip(got, want, init)):
        steps, lr = (g_steps * n_batches, KW["g_lr"]) if i < 2 else (d_steps * n_batches, KW["d_lr"])
        diff = np.abs(g - w_)
        assert diff.max() <= 2 * 1.1 * lr * steps, i
        assert np.median(diff) <= 0.05 * np.median(np.abs(w_ - i0)), i


@pytest.mark.parametrize("storage", ["dense", "csr"])
@pytest.mark.parametrize("mode", ["user", "item"])
def test_one_epoch_bf16_matches(mode, storage, urm_pair):
    got, want, init, losses, jlosses, n_batches = _one_epoch(mode, urm_pair, False, "bf16", storage)
    _assert_within_bf16_bound(got, want, init, n_batches)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)


# -- the whole fit -------------------------------------------------------------------

def _jax_fit(mode, lazy, urm_pair):
    """The JAX fit with early stopping, once per (mode, Adam form)."""
    if (mode, lazy) not in _FITTED:
        train, test = urm_pair
        jm = JaxGANMF(train, mode=mode, seed=SEED, is_experiment=True)
        returned = jm.fit(**KW, epochs=EPOCHS, freq=1, allow_worse=1, lazy_user_adam=lazy,
                          validation_evaluator=JaxEvaluatorHoldout(test, CUTOFFS))
        results, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jm)
        _FITTED[mode, lazy] = (jm, returned, results)
    return _FITTED[mode, lazy]


@pytest.mark.parametrize("lazy", [False, True], ids=["dense_adam", "lazy_adam"])
@pytest.mark.parametrize("mode", ["user", "item"])
def test_fit_matches(mode, lazy, urm_pair, monkeypatch):
    train, test = urm_pair
    jm, j_returned, j_results = _jax_fit(mode, lazy, urm_pair)
    _inject_jax_init(monkeypatch)
    pm = GANMF(train, mode=mode, seed=SEED, is_experiment=True, device=CPU)
    returned = pm.fit(**KW, epochs=EPOCHS, freq=1, allow_worse=1, lazy_user_adam=lazy,
                      validation_evaluator=EvaluatorHoldout(test, CUTOFFS, device=CPU))
    assert returned == j_returned
    for g, w_ in zip(pm.params.parameters(), _leaves(jm.params)):
        np.testing.assert_allclose(g.detach().numpy(), w_, rtol=0, atol=1e-4)
    assert len(pm.train_d_loss) == len(jm.train_d_loss)
    for name in ("train_d_loss", "train_g_loss"):
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in getattr(pm, name))
        np.testing.assert_allclose([float(v) for v in getattr(pm, name)],
                                   [float(v) for v in getattr(jm, name)], rtol=0, atol=1e-5)
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(pm)
    _assert_results_close(got, j_results, tol=1e-5)
    assert pm.config == jm.config


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_csr_storage_matches_dense_and_jax(compute_dtype, urm_pair, monkeypatch):
    """urm_storage="csr" against "dense" in the port (mirrors
    tests/test_models.py:224-283), and against the JAX package's csr fit."""
    train, test = urm_pair
    kw = dict(KW, epochs=3, compute_dtype=compute_dtype)
    _inject_jax_init(monkeypatch)
    runs = {}
    for storage in ("dense", "csr"):
        pm = GANMF(train, seed=SEED, is_experiment=True, device=CPU)
        pm.fit(urm_storage=storage, **kw)
        runs[storage] = pm
    assert runs["csr"]._urm_streams() and not runs["dense"]._urm_streams()
    assert runs["csr"].params.user_emb.dtype == torch.float32  # f32 master parameters
    rtol = 1e-6 if compute_dtype == "f32" else 1e-5
    for got, want in zip(runs["csr"].params.parameters(), runs["dense"].params.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=rtol, atol=1e-7)
    ev = EvaluatorHoldout(test, [5], device=CPU)
    res_d, _ = ev.evaluateRecommender(runs["dense"])
    res_s, _ = ev.evaluateRecommender(runs["csr"])
    assert runs["csr"]._seen_padded is not None  # its seen rows came from padded CSR
    for metric in ("MAP", "NDCG"):
        assert res_s[5][metric] == pytest.approx(res_d[5][metric], abs=1e-9)

    jm = JaxGANMF(train, seed=SEED, is_experiment=True)
    jm.fit(urm_storage="csr", **kw)
    got = [t.detach().numpy() for t in runs["csr"].params.parameters()]
    want = _leaves(jm.params)
    if compute_dtype == "f32":
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g, w_, rtol=0, atol=1e-4)
    else:
        n_batches, _ = jax_make_batches(train.shape[0], KW["batch_size"])
        init = _leaves(_jax_init(*train.shape))
        _assert_within_bf16_bound(got, want, init, 3 * n_batches, d_steps=1)


# -- crash resume, plots, what is not ported ----------------------------------------

@pytest.mark.parametrize("mode", ["user", "item"])
def test_crash_resume_reproduces_the_run(mode, urm_pair, tmp_path):
    """A fit cut after epoch 4 resumes from its epoch-4 checkpoint (weights,
    D's and the items' Adam states, the user embeddings' TF1 moments and step
    counter, the loss histories) and ends where the uninterrupted fit ends
    (mirrors tests/test_aux.py:93-141)."""
    train, _ = urm_pair
    kwargs = dict(KW, epochs=6, lazy_user_adam=mode == "item")

    full = GANMF(train, mode=mode, seed=3, is_experiment=True, device=CPU)
    full.fit(**kwargs)

    m = GANMF(train, mode=mode, seed=3, is_experiment=True, device=CPU)
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
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["aux_2.pt", "aux_4.pt", "ckpt_2.pt", "ckpt_4.pt"]

    m2 = GANMF(train, mode=mode, seed=3, is_experiment=True, device=CPU)
    m2.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    m2.fit(**kwargs)
    for got, want in zip(m2.params.parameters(), full.params.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-7)
    n_batches, _ = jax_make_batches(_matrix(train, mode).shape[0], KW["batch_size"])
    assert float(m2._user_adam["t"]) == float(full._user_adam["t"]) == 6 * n_batches
    # loss histories carry over: 4 restored epochs and 2 new ones
    assert len(m2.train_d_loss) == len(m2.train_g_loss) == 6
    for name in ("train_d_loss", "train_g_loss"):
        np.testing.assert_allclose([float(v) for v in getattr(m2, name)],
                                   [float(v) for v in getattr(full, name)], rtol=1e-5)


def test_loss_plot_is_skipped_without_matplotlib(urm_pair, tmp_path, monkeypatch, capsys):
    """Outside an experiment the fit ends with a loss plot in ``logsdir``;
    without matplotlib it is skipped with a message, as in the JAX package."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(analysis, "_plt", lambda: None)
    pm = GANMF(urm_pair[0], seed=1, device=CPU)
    assert pm.logsdir.startswith("plots/GANMF/")
    pm.fit(**dict(KW, epochs=1))
    assert f"matplotlib unavailable; skipping plot {pm.logsdir}/losses.png" in capsys.readouterr().out
    pm = GANMF(urm_pair[0], seed=1, is_experiment=True, device=CPU)
    pm.fit(**dict(KW, epochs=1))
    assert "skipping plot" not in capsys.readouterr().out


def test_fit_rejects_what_is_not_ported(urm_pair):
    m = GANMF(urm_pair[0], device=CPU)
    from ganmf_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="mesh plan"):  # a plan on another device than the model's
        m.fit(mesh_plan=make_mesh(device="meta"), epochs=1)
    with pytest.raises(ValueError):
        m.fit(urm_storage="coo", epochs=1)
    with pytest.raises(ValueError):
        m.fit(compute_dtype="fp16", epochs=1)


def test_entry_points_need_a_card_unless_given_the_cpu(urm_pair, monkeypatch):
    """Models and the evaluator run on the card by default: without one they
    raise before any work, and never fall back to the CPU."""
    train, test = urm_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: GANMF(train), lambda: CFGAN(train, mode="item"),
                  lambda: EvaluatorHoldout(test, [5])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert GANMF(train, device="cpu").device == CPU
    assert EvaluatorHoldout(test, [5], device="cpu").device == CPU
