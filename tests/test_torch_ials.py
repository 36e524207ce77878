"""The port's IALS (models/ials.py) against the JAX package's, on the CPU.

Both start from the same factors: the reference's numpy initialisation from
one seed. Tolerances:

- one epoch, dense storage, linear and log confidence, at the JAX package's
  own test settings: within rtol 2e-4 / atol 2e-6 of JAX's (its own
  csr-against-dense tolerance, tests/test_parallel.py:284-289): float32
  products and CG steps summed in another order;
- where that elementwise gate is not met, each factor row within 1e-4 of its
  norm (``ROW_GAP``): at the committed LastFM alpha, for the half-step in
  chunks of 8 rows (several CG exits a half-step) against JAX's
  ``_als_half_step``, and for three epochs on csr storage against JAX's;
- csr storage, padded and flat (the byte limit monkeypatched to 1, as
  tests/test_scale.py:138-159 does), against the port's dense form within
  rtol 2e-4 / atol 2e-6; padded and flat bitwise equal to each other;
- a 6-epoch fit with early stopping: JAX's ``epochs_best`` and every metric
  within 1e-5;
- cold rows keep their initial factors; crash resume reproduces the
  uninterrupted fit (rtol 1e-5); ``mesh_plan``: an object that is no plan
  fails as JAX's fit fails (AttributeError), and the 1 x 1 plan
  (``make_mesh()`` without a process group) trains bitwise as no plan in
  every storage (the mesh fits on 4 ranks:
  tests/test_torch_parallel_baselines.py).
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import IALSRecommender as JaxIALS
from ganmf_tpu.models import ials as jials
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import IALSRecommender
from ganmf_tpu_torch.models import ials
from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
RTOL, ATOL = 2e-4, 2e-6
# CG stops at a residual of 1e-5 of ||b||, so two summation orders leave a
# solution apart by up to about cond(A) x 1e-5 of its norm; a near-zero entry
# can then pass ATOL while its row stays within this share of its norm
ROW_GAP = 1e-4


def _urm(ratings=False):
    """50 x 30 with a cold user (row 3) and a cold item (column 5)."""
    rng = np.random.RandomState(2)
    dense = (rng.rand(50, 30) < 0.3).astype(np.float32)
    if ratings:
        dense *= rng.randint(1, 6, dense.shape).astype(np.float32)
    dense[3] = 0
    dense[:, 5] = 0
    return sps.csr_matrix(dense)


def _factors(m):
    return [np.asarray(m._U_dev), np.asarray(m._V_dev)]


def _row_gap(got, want):
    """The largest distance between two factor rows, relative to the row's
    norm."""
    return float((np.linalg.norm(got - want, axis=1) / np.maximum(np.linalg.norm(want, axis=1), 1e-30)).max())


# (ratings, scaling, alpha, epsilon, reg): near the JAX package's own test
# settings (tests/test_parallel.py:271-289, tests/test_scale.py:139-159),
# with an epsilon other than 1 for the log confidence
SETTINGS = [(False, "linear", 2.0, 1.0, 1e-2), (True, "log", 2.0, 0.5, 1e-3)]


@pytest.mark.parametrize("ratings,scaling,alpha,epsilon,reg", SETTINGS)
def test_one_epoch_matches_jax(ratings, scaling, alpha, epsilon, reg):
    urm = _urm(ratings=ratings)
    cfg = dict(epochs=1, num_factors=8, alpha=alpha, epsilon=epsilon, reg=reg, confidence_scaling=scaling)
    mine, theirs = IALSRecommender(urm, device=CPU), JaxIALS(urm)
    mine.fit(**cfg)
    theirs.fit(**cfg)
    for got, want in zip(_factors(mine), _factors(theirs)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # both orientations' chunk sizes are JAX's
    assert (mine._chunk_u, mine._chunk_i) == (theirs._chunk_u, theirs._chunk_i)
    # one chunk a half-step; CG ran and read its exit test once more
    assert [len(log) for log in mine.cg_log] == [2]
    for it, reads in mine.cg_log[0]:
        assert 0 < it <= 8 + 16 and reads == it + (it < 8 + 16)


def test_one_epoch_rows_match_jax_at_the_committed_lastfm_params():
    """At the committed LastFM params (K cut to 8; alpha 38.6, reg 1.58e-3)
    the systems are worse conditioned: a few near-zero entries pass ATOL (5
    of 400 here, a CPU measurement), while every row stays within ROW_GAP of
    its norm (3.2e-5 here), the gate chip_smoke.py holds the card to."""
    urm = _urm()
    with open(REPO / "experiments" / "IALSRecommender__LastFM" / "best_params.pkl", "rb") as fh:
        cfg = dict(pickle.load(fh), epochs=1, num_factors=8)
    mine, theirs = IALSRecommender(urm, device=CPU), JaxIALS(urm)
    mine.fit(**cfg)
    theirs.fit(**cfg)
    for got, want in zip(_factors(mine), _factors(theirs)):
        assert _row_gap(got, want) <= ROW_GAP


@pytest.mark.parametrize("ratings,scaling,alpha,epsilon,reg", SETTINGS)
def test_half_step_in_chunks_matches_jax(ratings, scaling, alpha, epsilon, reg):
    urm = _urm(ratings=ratings)
    rng = np.random.RandomState(0)
    Y = (8 ** -0.5 * rng.random_sample((urm.shape[1], 8))).astype(np.float32)
    R = torch.from_numpy(urm.toarray())
    W, P = ials.confidence(R, scaling, alpha, epsilon)
    log = []
    got = ials.als_half_step(lambda lo, hi: (W[lo:hi], P[lo:hi]), urm.shape[0], torch.from_numpy(Y), reg,
                             chunk=8, log=log)
    want = jials._als_half_step(jnp.asarray(W.numpy()), jnp.asarray(P.numpy()), jnp.asarray(Y), reg, chunk=8)
    assert _row_gap(got.numpy(), np.asarray(want)) <= ROW_GAP
    assert len(log) == 7  # JAX's chunk boundaries: 50 rows in chunks of 8, the last one short
    # the cold user's system has b = 0: it is solved as 0 in both
    assert not got[3].any()


@pytest.mark.parametrize("scaling", ["linear", "log"])
def test_csr_storage_matches_dense(scaling, monkeypatch):
    urm = _urm(ratings=scaling == "log")
    cfg = dict(epochs=3, num_factors=8, alpha=2.0, reg=1e-2, confidence_scaling=scaling)
    dense = IALSRecommender(urm, device=CPU)
    dense.fit(**cfg)
    padded = IALSRecommender(urm, device=CPU)
    padded.fit(urm_storage="csr", **cfg)
    monkeypatch.setattr(ials, "_PAD_PLANE_BYTE_LIMIT", 1)
    flat = IALSRecommender(urm, device=CPU)
    flat.fit(urm_storage="csr", **cfg)

    assert dense._store_users[0] == "dense"
    assert padded._store_users[0] == padded._store_items[0] == "padded"
    assert flat._store_users[0] == flat._store_items[0] == "flat"
    for a, b, c in zip(_factors(padded), _factors(flat), _factors(dense)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)
    # and the JAX package's csr fit, three epochs on
    theirs = JaxIALS(urm)
    theirs.fit(urm_storage="csr", **cfg)
    for got, want in zip(_factors(padded), _factors(theirs)):
        assert _row_gap(got, want) <= ROW_GAP


def test_fit_with_early_stopping_matches_jax(urm_pair):
    train, test = urm_pair
    cfg = dict(epochs=6, num_factors=6, alpha=5.0, reg=1e-3)
    stop = dict(validation_every_n=2, stop_on_validation=True, validation_metric="MAP",
                lower_validations_allowed=2)
    mine = IALSRecommender(train, device=CPU)
    ev = EvaluatorHoldout(test, [5], device=CPU)
    mine.fit(**cfg, **stop, evaluator_object=ev)
    theirs = JaxIALS(train)
    theirs.fit(**cfg, **stop, evaluator_object=JaxEvaluatorHoldout(test, [5]))
    assert mine.epochs_best == theirs.epochs_best > 0
    assert mine.get_early_stopping_final_epochs_dict() == theirs.get_early_stopping_final_epochs_dict()
    assert len(mine.cg_log) == 6
    # the best factors are kept as device tensors: no host copy per validation
    assert isinstance(mine._USER_factors_store, torch.Tensor)
    np.testing.assert_allclose(mine.USER_factors, np.asarray(theirs.USER_factors), rtol=RTOL, atol=ATOL)

    got, _ = EvaluatorHoldout(test, [5, 10], device=CPU).evaluateRecommender(mine)
    want, _ = JaxEvaluatorHoldout(test, [5, 10]).evaluateRecommender(theirs)
    for c in (5, 10):
        for metric, value in want[c].items():
            assert got[c][metric] == pytest.approx(value, abs=1e-5, nan_ok=True), (c, metric)


def test_cold_rows_keep_their_factors():
    urm = _urm()
    model = IALSRecommender(urm, device=CPU)
    model.fit(epochs=2, num_factors=4, alpha=2.0)
    rng = np.random.RandomState(1234)  # fit's default seed: the reference's initialisation
    U0 = (4 ** -0.5 * rng.random_sample((urm.shape[0], 4))).astype(np.float32)
    V0 = (4 ** -0.5 * rng.random_sample((urm.shape[1], 4))).astype(np.float32)
    np.testing.assert_array_equal(model.USER_factors[3], U0[3])
    np.testing.assert_array_equal(model.ITEM_factors[5], V0[5])
    assert not np.array_equal(model.USER_factors[0], U0[0])
    # the MF base masks the cold user out of every ranking
    assert model.recommend(3, cutoff=5) == []


def test_crash_resume_reproduces_the_uninterrupted_fit(tmp_path, urm_pair):
    train, _ = urm_pair
    cfg = dict(num_factors=4, alpha=5.0, epochs=6)
    full = IALSRecommender(train, device=CPU)
    full.fit(**cfg)

    model = IALSRecommender(train, device=CPU)
    model.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    orig = model._run_epoch

    def cut_short(num_epoch):
        if num_epoch >= 4:
            raise KeyboardInterrupt
        orig(num_epoch)

    model._run_epoch = cut_short
    with pytest.raises(KeyboardInterrupt):
        model.fit(**cfg)
    assert model.checkpointer.latest_epoch() == 4

    resumed = IALSRecommender(train, device=CPU)
    resumed.checkpointer = TrainCheckpointer(str(tmp_path / "ck"), every_n_epochs=2)
    resumed.fit(**cfg)
    assert len(resumed.cg_log) == 2  # epochs 5 and 6 only
    for got, want in zip(_factors(resumed), _factors(full)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_rejects_what_it_does_not_take(urm_pair, monkeypatch):
    train, _ = urm_pair
    model = IALSRecommender(train, device=CPU)
    # an object that is no plan fails as it fails JAX's fit
    with pytest.raises(AttributeError):
        JaxIALS(train).fit(epochs=1, num_factors=4, mesh_plan=object())
    with pytest.raises(AttributeError):
        model.fit(epochs=1, num_factors=4, mesh_plan=object())
    # the 1 x 1 plan trains bitwise as no plan
    from ganmf_tpu_torch.parallel import make_mesh

    for storage in ("dense", "csr"):
        cfg = dict(epochs=2, num_factors=4, urm_storage=storage)
        plain, meshed = IALSRecommender(train, device=CPU), IALSRecommender(train, device=CPU)
        plain.fit(**cfg)
        meshed.fit(mesh_plan=make_mesh(device="cpu"), **cfg)
        np.testing.assert_array_equal(meshed.USER_factors, plain.USER_factors)
        np.testing.assert_array_equal(meshed.ITEM_factors, plain.ITEM_factors)
        assert meshed.cg_log == plain.cg_log
    with pytest.raises(ValueError, match="confidence_scaling"):
        model.fit(epochs=1, confidence_scaling="sqrt")
    with pytest.raises(ValueError, match="urm_storage"):
        model.fit(epochs=1, urm_storage="coo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IALSRecommender(train)
