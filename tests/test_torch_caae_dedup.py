"""CAAE's ``d_scatter="dedup"`` D phase: against the "direct" form and
against the JAX package's dedup form, on the CPU, from JAX's init and draws
(tests/test_torch_caae.py's helpers).

Tolerances: dedup against direct, rtol 1e-4 / atol 1e-6 (as
tests/test_models.py:181 holds JAX's two forms: the same math but for the
float32 summation order within a duplicate run, which a cumulative sum takes
in sorted order); dedup against JAX's dedup, the D-phase-only tolerance of
tests/test_torch_caae.py (1e-6 of each store's largest element); the plan of
runs exactly (integers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.models import CAAE as JaxCAAE
from ganmf_tpu.models import caae as jca
from ganmf_tpu_torch.models import caae as pca
from ganmf_tpu_torch.models.caae import CAAE
from tests.test_torch_caae import CPU, KW, _epoch_inputs, _jax_draws, _jax_init, _leaves, _t

D_ONLY = dict(KW, g_steps=0, gpr_steps=0, d_bsize=64, d_steps=3)


def _epochs(train, kw, key):
    """The port's D phase in both forms and JAX's dedup D phase, from one
    init and one set of draws."""
    n_users, n_items = train.shape
    users, items, weight, n_chunks, n_samples = _epoch_inputs(train, kw)
    init, _ = _jax_init(n_users, n_items, kw)
    urm = train.toarray().astype(np.float32)
    statics = dict(d_bsize=kw["d_bsize"], n_d_chunks=n_chunks, d_steps=kw["d_steps"], g_steps=kw["g_steps"],
                   gpr_steps=kw["gpr_steps"], m_batch=kw["m_batch"], n_samples=n_samples)
    want = jca.caae_epoch(init, jnp.asarray(urm), jnp.asarray(users), jnp.asarray(items), jnp.asarray(weight),
                          key, jnp.float32(kw["lr"]), jnp.float32(kw["beta"]), jnp.float32(kw["lmbda"]),
                          jnp.float32(kw["S"]), d_scatter="dedup", **statics)
    draws = _jax_draws(key, len(users), n_users, n_items, kw["d_steps"] * n_chunks * kw["d_bsize"],
                       kw["g_steps"], kw["gpr_steps"], kw["m_batch"], n_samples)
    got = {}
    for form in ("direct", "dedup"):
        p = pca.params_from_jax(_leaves(init), CPU)
        pca.caae_epoch(p, torch.from_numpy(urm), _t(users, np.int64), _t(items, np.int64), _t(weight), draws,
                       lr=kw["lr"], beta=kw["beta"], lmbda=kw["lmbda"], S=kw["S"], d_scatter=form, **statics)
        got[form] = [t.detach().numpy() for t in p.parameters()]
    return got, _leaves(want), _leaves(init)


def test_dedup_plan_sums_each_run_once():
    idx = torch.tensor([[5, 2, 5, 9, 2, 5], [1, 1, 1, 1, 1, 1], [0, 1, 2, 3, 4, 5]])
    perm, scat, end = pca.dedup_plan(idx, n_rows=10)
    np.testing.assert_array_equal(perm[0].numpy(), [1, 4, 0, 2, 5, 3])
    np.testing.assert_array_equal(scat.numpy(), [[2, 11, 5, 13, 14, 9], [1, 11, 12, 13, 14, 15],
                                                 [0, 1, 2, 3, 4, 5]])
    np.testing.assert_array_equal(end.numpy(), [[1, 1, 4, 4, 4, 5], [5] * 6, [0, 1, 2, 3, 4, 5]])
    for row in range(3):  # every scatter index unique, table rows once each
        assert len(set(scat[row].tolist())) == 6
    tab = torch.zeros((16, 1))
    g = torch.arange(1.0, 7.0)[:, None]
    pca._dedup_add_(tab, g, perm[0], scat[0], end[0], lr=1.0)
    want = torch.zeros((16, 1))
    want.index_add_(0, idx[0], -g)
    assert torch.equal(tab[:10], want[:10])
    # the plan as JAX's prep computes it
    jidx = jnp.asarray(idx.numpy())
    jperm = jnp.argsort(jidx, axis=1)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_d_phase_matches_direct_and_jax(urm_pair, seed):
    train, _ = urm_pair
    got, want, init = _epochs(train, D_ONLY, jax.random.PRNGKey(seed))
    for i, (dedup, direct, w_, i0) in enumerate(zip(got["dedup"], got["direct"], want, init)):
        if i < 3:  # the D stores moved; G and G' did not
            assert np.abs(w_ - i0).max() > 1e-3, i
        np.testing.assert_allclose(dedup, direct, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(dedup, w_, rtol=0, atol=1e-6 * max(1e-3, np.abs(w_).max()))


def test_dedup_full_epoch_matches_direct(urm_pair):
    train, _ = urm_pair
    got, _, _ = _epochs(train, KW, jax.random.PRNGKey(3))
    for dedup, direct in zip(got["dedup"], got["direct"]):
        np.testing.assert_allclose(dedup, direct, rtol=1e-4, atol=1e-6)


def test_dedup_fit_matches_direct_and_jax_metric(urm_pair):
    """Fits of both forms from the port's own draws, as tests/test_models.py
    fits JAX's two forms; and JAX's dedup fit runs."""
    train, test = urm_pair
    kwargs = dict(epochs=2, d_steps=2, g_steps=1, gpr_steps=1, g_layers=1, g_units=16, num_factors=8,
                  d_bsize=32, m_batch=8, lr=1e-2)
    fits = {}
    for form in ("direct", "dedup"):
        fits[form] = CAAE(train, seed=1, device=CPU)
        fits[form].fit(d_scatter=form, **kwargs)
    for a, b in zip(fits["dedup"].params.parameters(), fits["direct"].params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-6)
    jm = JaxCAAE(train, seed=1)
    jm.fit(d_scatter="dedup", **kwargs)
    assert np.isfinite(np.asarray(jm.params.d_user_emb)).all()
