"""DisGANMF training: the port against the JAX package, on the CPU.

The JAX initial weights go into the port through ``params_from_jax`` (the
port's ``init_params`` is monkeypatched), and both packages draw the epochs'
permutations from ``np.random.RandomState(seed)``, so the two runs start from
the same state and see the same minibatches. Batches of 12 pad both modes'
row counts (50 users, 80 items). D has two hidden layers of 8 over
concat(raw row id, profile).

Tolerances:
- the forward pass and the losses on the same weights, every activation:
  1e-5 (float32 products and sums taken in another order; the raw id column
  makes pre-activations of order 10);
- one f32 epoch, in both modes, with both Adam forms and every activation:
  2e-5 on every parameter and 1e-5 on both mean losses. Adam's first steps
  move each element by about lr * sign(gradient), which rounding changes only
  where a gradient sits at rounding level;
- one bf16 epoch, dense and csr storage: every parameter within 2.2 * lr per
  Adam step and the median difference within 5% of the median distance the
  epoch moved the tensor (tests/test_torch_ganmf_train.py's bound), the mean
  losses within rtol 2e-2;
- a 4-epoch f32 fit with early stopping at every epoch: 1e-4 on the
  parameters and 1e-5 on every metric at cutoffs 5/10/20/50;
- csr against dense storage in the port: rtol 1e-6 / atol 1e-7, metrics
  within 1e-9;
- crash resume (the port alone): rtol 1e-6 / atol 1e-7.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import DisGANMF as JaxDisGANMF
from ganmf_tpu.models import disganmf as jdg
from ganmf_tpu.models.gan_base import make_batches, shuffled_padded_perm
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import DisGANMF
from ganmf_tpu_torch.models import disganmf as pdg
from ganmf_tpu_torch.models import ganmf as pgm
from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer
from test_torch_parallel import one_rank_gloo

torch.set_num_threads(1)
CPU = torch.device("cpu")
CUTOFFS = [5, 10, 20, 50]
SEED = 42
KW = dict(num_factors=4, d_layers=2, d_nodes=8, d_hidden_act="relu", batch_size=12, d_lr=1e-3,
          g_lr=2e-3, d_reg=1e-4, g_reg=1e-4, recon_coefficient=0.2)
ACTS = ["linear", "tanh", "relu", "sigmoid", "LeakyReLU"]


def _jax_init(n_rows, n_cols, kw=KW):
    return jdg._init_params(jax.random.PRNGKey(SEED), n_rows, n_cols, kw["num_factors"],
                            kw["d_layers"], kw["d_nodes"])


def _leaves(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def _inject_jax_init(monkeypatch):
    def init(n_rows, n_cols, k, layers, nodes, generator, device):
        leaves = jdg._init_params(jax.random.PRNGKey(SEED), n_rows, n_cols, k, layers, nodes)
        return pdg.params_from_jax(_leaves(leaves), device)

    monkeypatch.setattr(pdg, "init_params", init)


def _matrix(train, mode):
    return train.T.tocsr() if mode == "item" else train


@pytest.mark.parametrize("act", ACTS)
def test_forward_and_losses_match(act, urm_pair):
    mat = urm_pair[0]
    init = _jax_init(*mat.shape)
    p = pdg.params_from_jax(_leaves(init), CPU)
    assert [tuple(t.shape) for t in p.parameters()] == [x.shape for x in _leaves(init)]
    real = mat.toarray()[:12].astype(np.float32)
    uids = np.arange(12, dtype=np.int32)[::-1].copy() + 30
    w = np.ones(12, np.float32)
    w[-3:] = 0.0
    tu, tr, tw = torch.from_numpy(uids.astype(np.int64)), torch.from_numpy(real), torch.from_numpy(w)
    ju, jr, jw = jnp.asarray(uids), jnp.asarray(real), jnp.asarray(w)
    pact, jact = pdg.ACTIVATIONS[act], jdg.ACTIVATIONS[act]

    for got, want in zip(pdg._discriminate(p, tu, tr, pact), jdg._discriminate(init, ju, jr, jact)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    logits = torch.linspace(-30, 30, 12)[:, None]
    for target in (0.0, 1.0):
        assert float(pdg._bce(logits, target, tw)) == pytest.approx(
            float(jdg._bce(jnp.asarray(logits.numpy()), target, jw)), rel=1e-6)

    # JAX's losses at d_reg = g_reg = 1e-3, each taken once
    fake = jnp.dot(jnp.take(init.user_emb, ju, axis=0), init.item_emb.T)
    real_feat, real_out = jdg._discriminate(init, ju, jr, jact)
    fake_feat, fake_out = jdg._discriminate(init, ju, fake, jact)
    loss_fake = jdg._bce(fake_out, 0.0, jw)
    want_d = jdg._bce(real_out, 1.0, jw) + loss_fake + 1e-3 * jdg._l2(jdg._d_params(init))
    want_g = (loss_fake + 0.2 * jdg._masked_mse(real_feat, fake_feat, jw)
              + 1e-3 * jdg._l2(jdg._g_params(init)))
    got_d = pdg.d_loss(p, tu, tr, tw, 1e-3, pact)
    got_g = pdg.g_loss(p, tu, tr, tw, 0.2, 1e-3, pact)
    assert float(got_d.detach()) == pytest.approx(float(want_d), rel=1e-5, abs=1e-5)
    assert float(got_g.detach()) == pytest.approx(float(want_g), rel=1e-5, abs=1e-5)


def test_bf16_keeps_row_ids_distinct(urm_pair):
    """In bf16 only the [B, I] profile product rounds: two adjacent large row
    ids with the same profile give different logits, which a bf16 id column
    would merge; and the bf16 forward is JAX's within bf16 rounding."""
    mat = urm_pair[0]
    init = _jax_init(*mat.shape)
    p = pdg.params_from_jax(_leaves(init), CPU)
    row = torch.from_numpy(mat.toarray()[:1].astype(np.float32)).repeat(2, 1).to(torch.bfloat16)
    uids = torch.tensor([4097, 4098])  # one bf16 value: 4096
    assert torch.equal(uids.to(torch.bfloat16)[0:1], uids.to(torch.bfloat16)[1:2])
    _, logits = pdg._discriminate(p, uids, row, pdg.ACTIVATIONS["linear"], torch.bfloat16)
    assert logits.dtype == torch.float32 and float((logits[0] - logits[1]).detach()) != 0.0

    pc = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16), init)
    real = mat.toarray()[:12].astype(np.float32)
    uids = np.arange(12, dtype=np.int32) * 7
    for act in ("relu", "tanh"):
        got = pdg._discriminate(p, torch.from_numpy(uids.astype(np.int64)),
                                torch.from_numpy(real).to(torch.bfloat16), pdg.ACTIVATIONS[act], torch.bfloat16)
        want = jdg._discriminate(pc, jnp.asarray(uids), jnp.asarray(real, dtype=jnp.bfloat16), jdg.ACTIVATIONS[act])
        for g, w_ in zip(got, want):
            assert g.dtype == torch.float32 and w_.dtype == jnp.float32
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w_), rtol=2e-2, atol=2e-2)


def _one_epoch(mode, urm_pair, lazy, act, compute_dtype="f32", storage="dense"):
    """(port params, JAX params, initial params, port losses, JAX losses,
    n_batches) after one epoch from JAX's init on the same permutation;
    d_steps=2 so that D passes over the batches twice."""
    kw = dict(KW, d_hidden_act=act)
    mat = _matrix(urm_pair[0], mode)
    n_rows, n_cols = mat.shape
    bs = kw["batch_size"]
    n_batches, padded = make_batches(n_rows, bs)
    perm = shuffled_padded_perm(np.random.RandomState(SEED), n_rows, padded)
    w = np.zeros(padded, np.float32)
    w[:n_rows] = 1.0
    init = _jax_init(n_rows, n_cols, kw)
    statics = dict(n_batches=n_batches, batch_size=bs, d_steps=2, g_steps=1, d_hidden_act=act,
                   lazy_user_adam=lazy, compute_dtype=compute_dtype)
    cd = jnp.bfloat16 if compute_dtype == "bf16" else jnp.float32
    g_state = (jdg.ADAM.init((init.item_emb,)), jnp.zeros_like(init.user_emb),
               jnp.zeros_like(init.user_emb), jnp.float32(0.0))
    want, _, _, jdl, jgl = jdg.disganmf_epoch(
        init, jdg.ADAM.init(jdg._d_params(init)), g_state, jnp.asarray(mat.toarray(), dtype=cd),
        jnp.asarray(perm), jnp.asarray(w), jnp.float32(kw["d_lr"]), jnp.float32(kw["g_lr"]),
        jnp.float32(kw["recon_coefficient"]), jnp.float32(kw["d_reg"]), jnp.float32(kw["g_reg"]), **statics)

    p = pdg.params_from_jax(_leaves(init), CPU)
    d_opt = torch.optim.Adam(p.d_params(), lr=kw["d_lr"], betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
    item_opt = torch.optim.Adam([p.item_emb], lr=kw["g_lr"], betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
    if storage == "csr":
        urm = pgm.padded_csr_from_sparse(mat, CPU)
        if compute_dtype == "bf16":
            urm = urm._replace(val=urm.val.to(torch.bfloat16))
    else:
        urm = torch.from_numpy(mat.toarray().astype(np.float32))
        if compute_dtype == "bf16":
            urm = urm.to(torch.bfloat16)
    user_state = pgm.user_adam_state(p.user_emb)
    dl, gl = pdg.disganmf_epoch(p, d_opt, item_opt, user_state, urm,
                                torch.from_numpy(perm.astype(np.int64)), torch.from_numpy(w),
                                g_lr=kw["g_lr"], recon_coefficient=kw["recon_coefficient"],
                                d_reg=kw["d_reg"], g_reg=kw["g_reg"], **statics)
    assert float(user_state["t"]) == n_batches
    got = [t.detach().numpy() for t in p.parameters()]
    return got, _leaves(want), _leaves(init), (float(dl), float(gl)), (float(jdl), float(jgl)), n_batches


@pytest.mark.parametrize("mode,lazy,act", [
    ("user", True, "relu"), ("user", False, "relu"), ("item", True, "relu"), ("item", False, "relu"),
    ("user", True, "linear"), ("item", False, "tanh"), ("user", True, "sigmoid"), ("item", True, "LeakyReLU"),
])
def test_one_epoch_f32_matches(mode, lazy, act, urm_pair):
    got, want, init, losses, jlosses, _ = _one_epoch(mode, urm_pair, lazy, act)
    for g, w_, i in zip(got, want, init):
        np.testing.assert_allclose(g, w_, rtol=0, atol=2e-5)
    for i in (0, 1, 2, len(got) - 2):  # embeddings, D's first kernel and its output kernel moved
        assert np.abs(want[i] - init[i]).max() > 1e-4
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    rows_moved = np.abs(got[0] - init[0]).max(1) > 0
    assert rows_moved.all()  # every row is in some batch of the epoch


@pytest.mark.parametrize("storage", ["dense", "csr"])
@pytest.mark.parametrize("mode", ["user", "item"])
def test_one_epoch_bf16_matches(mode, storage, urm_pair):
    got, want, init, losses, jlosses, n_batches = _one_epoch(mode, urm_pair, mode == "user", "relu",
                                                             "bf16", storage)
    n_d = 2 * (len(got) - 2)
    for i, (g, w_, i0) in enumerate(zip(got, want, init)):
        steps, lr = (n_batches, KW["g_lr"]) if i < 2 else (2 * n_batches, KW["d_lr"])
        diff = np.abs(g - w_)
        assert diff.max() <= 2.2 * lr * steps, i
        if np.abs(w_ - i0).max() > 0:
            assert np.median(diff) <= 0.05 * np.median(np.abs(w_ - i0)) or np.median(diff) == 0, i
    assert n_d > 0
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)


_FITTED = {}


@pytest.mark.parametrize("mode", ["user", "item"])
def test_fit_matches(mode, urm_pair, monkeypatch):
    """The fit with early stopping at every epoch, with JAX's default Adam
    form (lazy in user mode, dense in item mode); the explicit form gives the
    same run, and the fit keeps no loss histories."""
    train, test = urm_pair
    jm = JaxDisGANMF(train, mode=mode, seed=SEED, is_experiment=True)
    j_returned = jm.fit(**KW, epochs=4, freq=1, allow_worse=1,
                        validation_evaluator=JaxEvaluatorHoldout(test, CUTOFFS))
    j_results, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jm)
    _inject_jax_init(monkeypatch)
    runs = []
    for lazy in (None, mode == "user"):
        pm = DisGANMF(train, mode=mode, seed=SEED, is_experiment=True, device=CPU)
        returned = pm.fit(**KW, epochs=4, freq=1, allow_worse=1, lazy_user_adam=lazy,
                          validation_evaluator=EvaluatorHoldout(test, CUTOFFS, device=CPU))
        assert returned == j_returned
        assert not hasattr(pm, "train_d_loss")
        runs.append([t.detach().numpy() for t in pm.params.parameters()])
    for a, b, w_ in zip(*runs, _leaves(jm.params)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, w_, rtol=0, atol=1e-4)
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(pm)
    for c in CUTOFFS:
        for metric, value in j_results[c].items():
            assert got[c][metric] == pytest.approx(value, abs=1e-5, nan_ok=True), (c, metric)
    assert pm.config == jm.config
    users = np.arange(10)
    assert pm.recommend_fused(users, cutoff=7) == pm.recommend(users, cutoff=7) == jm.recommend(users, cutoff=7)


def test_csr_storage_matches_dense(urm_pair):
    train, test = urm_pair
    runs = {}
    for storage in ("dense", "csr"):
        pm = DisGANMF(train, seed=SEED, is_experiment=True, device=CPU)
        pm.fit(**KW, epochs=2, urm_storage=storage)
        runs[storage] = pm
    assert runs["csr"]._urm_streams() and not runs["dense"]._urm_streams()
    for got, want in zip(runs["csr"].params.parameters(), runs["dense"].params.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-7)
    ev = EvaluatorHoldout(test, [5], device=CPU)
    res_d, _ = ev.evaluateRecommender(runs["dense"])
    res_s, _ = ev.evaluateRecommender(runs["csr"])
    for metric in ("MAP", "NDCG"):
        assert res_s[5][metric] == pytest.approx(res_d[5][metric], abs=1e-9)


def test_crash_resume_and_save_load(urm_pair, tmp_path):
    """A fit cut after epoch 2 resumes from its checkpoint (weights, D's and
    the items' Adam states, TF1's moments and step counter) and ends where the
    uninterrupted fit ends; the saved zip loads into the JAX package and back
    with the same scores."""
    train, _ = urm_pair
    kwargs = dict(KW, epochs=3)
    full = DisGANMF(train, mode="item", seed=3, is_experiment=True, device=CPU)
    full.fit(**kwargs)

    m = DisGANMF(train, mode="item", seed=3, is_experiment=True, device=CPU)
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
    m2 = DisGANMF(train, mode="item", seed=3, is_experiment=True, device=CPU)
    m2.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    m2.fit(**kwargs)
    for got, want in zip(m2.params.parameters(), full.params.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-7)
    assert float(m2._user_adam["t"]) == float(full._user_adam["t"])

    full.saveModel(str(tmp_path / "zip"))
    jm = JaxDisGANMF(train, mode="item", is_experiment=True)
    jm.loadModel(str(tmp_path / "zip"))
    back = DisGANMF(train, mode="item", device=CPU)
    back.loadModel(str(tmp_path / "zip"))
    users = torch.arange(20)
    want = full.score_device(users).numpy()
    np.testing.assert_array_equal(back.score_device(users).numpy(), want)
    params = jdg.DisGANMFParams(
        jnp.asarray(jm.param_0), jnp.asarray(jm.param_1), (jnp.asarray(jm.param_2), jnp.asarray(jm.param_3)),
        (jnp.asarray(jm.param_4), jnp.asarray(jm.param_5)), jnp.asarray(jm.param_6), jnp.asarray(jm.param_7))
    jm.params = params
    np.testing.assert_allclose(np.asarray(jm.score_device(jnp.arange(20))), want, rtol=1e-6, atol=1e-7)


def test_fit_rejects_what_is_not_ported(urm_pair):
    """mesh_plan is ported: on a one-rank gloo plan the fit runs the sharded
    epoch and ends where the fit without a plan ends; the other options
    still reject what they do not take."""
    m = DisGANMF(urm_pair[0], device=CPU)
    with one_rank_gloo() as plan:
        m.fit(mesh_plan=plan, epochs=1)
        got = [t.detach().numpy() for t in m._full_params().parameters()]
    assert m.mesh_plan is plan and m.params.user_emb.shape == got[0].shape
    single = DisGANMF(urm_pair[0], device=CPU)
    single.fit(epochs=1)
    for g, w_ in zip(got, single.params.parameters()):
        np.testing.assert_array_equal(g, w_.detach().numpy())
    for bad in (dict(urm_storage="coo"), dict(compute_dtype="fp16"), dict(d_hidden_act="gelu")):
        with pytest.raises(ValueError):
            m.fit(epochs=1, **bad)
