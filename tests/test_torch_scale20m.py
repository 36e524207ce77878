"""The ML-20M at-scale path of the port (ganmf_tpu_torch/data/synthetic.py,
ganmf_tpu_torch/cli/scale20m.py) against the JAX package's, on the CPU, at
small sizes.

- the stand-in's ratings.csv: byte for byte the file scripts/synthesize_ml20m.py
  writes with pandas, at small sizes (its module constants monkeypatched),
  and the port's defaults are the script's constants;
- one such file through JAX's ``Movielens("20M")`` and
  ``make_experiment_splits`` and through the port's ``load_splits``: the five
  matrices of the implicit split and of the explicit one (``implicit=False``,
  the rating values kept) bitwise equal;
- each stage, with the route limits lowered in both packages (as
  __graft_entry__.py:98-108 lowers IALS's), takes the route of JAX's model on
  the same split. TopPop's and ItemKNN's metrics agree with JAX's within 1e-6
  (the same scores; float32 sums in another order). PureSVD (JAX's Omega),
  IALS (the same numpy initial factors; linear and log confidence, and on
  the explicit split), FunkSVD (JAX's draws, tests/test_torch_mf_sgd.py) and
  GANMF (JAX's initial weights, tests/test_torch_ganmf_train.py) agree within
  those files' tolerances: every metric within 1e-5, RMSE within 1e-5; each
  stage's evaluation scored every user it had to (an implicit split's RMSE,
  of raw scores such as TopPop's counts, within 1e-6 of its size);
- the receipt fails, and the command exits nonzero, on a row below TopPop;
- a missing ratings.csv raises before anything is downloaded.
"""

import os
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.cli.experiment import DATASET_KWARGS as JAX_DATASET_KWARGS
from ganmf_tpu.data.datasets import Movielens as JaxMovielens
from ganmf_tpu.data.splits import make_experiment_splits as jax_make_experiment_splits
from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import GANMF as JaxGANMF
from ganmf_tpu.models import IALSRecommender as JaxIALS
from ganmf_tpu.models import ItemKNNCFRecommender as JaxItemKNN
from ganmf_tpu.models import TopPop as JaxTopPop
from ganmf_tpu.models import base as jbase
from ganmf_tpu.models import ganmf as jgm
from ganmf_tpu.models import ials as jials
from ganmf_tpu.models import puresvd as jsvd
from ganmf_tpu.models.mf_sgd import MatrixFactorization_FunkSVD as JaxFunkSVD
from ganmf_tpu.ops import similarity as jsim
from ganmf_tpu.utils.seeding import set_seed as jax_set_seed
from ganmf_tpu_torch.cli import scale20m
from ganmf_tpu_torch.data import synthetic
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import base as pbase
from ganmf_tpu_torch.models import ganmf as pgm
from ganmf_tpu_torch.models import ials as pials
from ganmf_tpu_torch.models import puresvd as psvd
from ganmf_tpu_torch.ops import similarity as psim
from test_torch_mf_sgd import _jax_draws

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import synthesize_ml20m  # noqa: E402  (the JAX side's script; imports numpy, pandas at write time)

torch.set_num_threads(1)
CPU = torch.device("cpu")
SMALL = dict(n_users=240, n_items=150, target_nnz=7000)


def _script_synthesize(monkeypatch, path, seed, n_users, n_items, target_nnz):
    for name, value in dict(N_USERS=n_users, N_ITEMS=n_items, TARGET_NNZ=target_nnz).items():
        monkeypatch.setattr(synthesize_ml20m, name, value)
    return synthesize_ml20m.synthesize(str(path), seed=seed, verbose=False)


# -- (a) the stand-in's bytes ------------------------------------------------------

@pytest.mark.parametrize("n_users,n_items,target_nnz,seed", [
    (240, 150, 7000, 20_000_263), (500, 90, 15_000, 3), (1200, 800, 60_000, 11),
])
def test_synthesize_writes_the_scripts_bytes(n_users, n_items, target_nnz, seed, tmp_path, monkeypatch):
    want = _script_synthesize(monkeypatch, tmp_path / "jax" / "ratings.csv", seed, n_users, n_items, target_nnz)
    got = synthetic.synthesize(str(tmp_path / "port" / "ratings.csv"), seed=seed, verbose=False,
                               n_users=n_users, n_items=n_items, target_nnz=target_nnz)
    data = Path(got).read_bytes()
    assert data.startswith(b"userId,movieId,rating,timestamp\n1,")
    assert data == Path(want).read_bytes()
    assert not os.path.exists(got + ".tmp")
    # a second call keeps the file
    assert synthetic.synthesize(got, seed=seed + 1, verbose=False, n_users=5, n_items=5, target_nnz=100) == got
    assert Path(got).read_bytes() == data


def test_defaults_are_the_scripts_constants():
    s = synthesize_ml20m
    assert (synthetic.N_USERS, synthetic.N_ITEMS, synthetic.TARGET_NNZ, synthetic.MIN_PER_USER,
            synthetic.MAX_PER_USER) == (s.N_USERS, s.N_ITEMS, s.TARGET_NNZ, s.MIN_PER_USER, s.MAX_PER_USER)
    import inspect

    assert inspect.signature(s.synthesize).parameters["seed"].default == synthetic.SEED
    for name in ("n_users", "n_items", "target_nnz", "min_per_user", "max_per_user"):
        assert inspect.signature(synthetic.synthesize).parameters[name].default == getattr(synthetic, name.upper())
    assert synthetic.ratings_path("d") == os.path.join("d", "ml-20m", "ratings.csv")


# -- (b) the splits ---------------------------------------------------------------

@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    """A small stand-in under data/ml-20m/ratings.csv and the port's splits
    of it: (data dir, implicit SplitSet, explicit SplitSet)."""
    root = tmp_path_factory.mktemp("ml20m")
    synthetic.synthesize(synthetic.ratings_path(str(root / "data")), verbose=False, **SMALL)
    implicit, explicit, info = scale20m.load_splits(str(root / "data"), str(root / "splits"), explicit=True,
                                                    log=lambda line: None)
    assert info["parser"] == "native" and set(info) >= {"read_s", "split_s", "save_s", "explicit_split_s"}
    return str(root / "data"), implicit, explicit


def _assert_csr_equal(got, want):
    got, want = sps.csr_matrix(got), sps.csr_matrix(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == want.data.dtype


@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "explicit"])
def test_splits_are_jaxs_bitwise(implicit, stand_in, tmp_path):
    data_dir, port_implicit, port_explicit = stand_in
    jax_set_seed(1337)
    if implicit:  # load_urms("20M")'s steps (ganmf_tpu/cli/experiment.py:105-119)
        reader = JaxMovielens(version="20M", data_dir=data_dir, **JAX_DATASET_KWARGS)
        want = jax_make_experiment_splits(reader.urm, seed=1337)
        got = port_implicit
    else:  # scripts/scale20m_explicit.py:39-51
        reader = JaxMovielens(version="20M", data_dir=data_dir, use_local=True, force_rebuild=True,
                              implicit=False, save_local=False, verbose=False, split=False, min_ratings_user=2)
        want = jax_make_experiment_splits(reader.urm, seed=1337, implicit=False)
        got = port_explicit
        assert got.train.data.min() >= 0.5 and got.train.data.max() == 5.0  # the rating values kept
    assert got.train.shape == (SMALL["n_users"], SMALL["n_items"])
    for g, w in zip(got, want):
        _assert_csr_equal(g, w)
    # the saved implicit split loads back as it was built
    loaded, none, info = scale20m.load_splits(str(tmp_path / "nowhere"), str(Path(data_dir).parent / "splits"),
                                              log=lambda line: None)
    assert none is None and "load_s" in info and "read_s" not in info
    for g, w in zip(loaded, port_implicit):
        _assert_csr_equal(g, w)


# -- (c) the stages against JAX's models --------------------------------------------

@pytest.fixture
def low_limits(monkeypatch):
    """The route limits of both packages lowered, so that a small split takes
    the routes ML-20M takes."""
    for cls in (jbase.Recommender, pbase.Recommender):
        monkeypatch.setattr(cls, "_DENSE_URM_BYTE_LIMIT", 0)
    for mod in (jials, pials):
        monkeypatch.setattr(mod, "_PAD_PLANE_BYTE_LIMIT", 1)
    for mod in (jsim, psim):
        monkeypatch.setattr(mod, "_DENSE_A_BYTE_LIMIT", 1)
    # the resident Gram's rule reads the device's memory where JAX reads a TPU's
    monkeypatch.setattr(psim, "device_memory_bytes", lambda device: jsim._CHIP_HBM_BYTES)


def assert_metrics_close(got, want, tol):
    """Every metric at every cutoff within ``tol``; RMSE also within 1e-6 of
    its size (on 0/1 data it is the RMSE of raw scores such as TopPop's
    counts, float32 sums of squares in another order)."""
    assert list(got) == list(want)
    for cutoff, metrics in want.items():
        assert list(got[cutoff]) == list(metrics)
        for name, value in metrics.items():
            rel = 1e-6 if name == "RMSE" else None
            assert got[cutoff][name] == pytest.approx(value, abs=tol, rel=rel, nan_ok=True), (cutoff, name)


def _evaluators(split, cutoffs):
    return EvaluatorHoldout(split.test, cutoffs, device=CPU), JaxEvaluatorHoldout(split.test, cutoffs)


def _check_row(row, results, ev, tol):
    for metric in ("MAP", "NDCG", "RECALL"):
        assert row[f"{metric}@20"] == pytest.approx(results[20][metric], abs=tol), metric
    assert row["n_eval_users"] == row["users_to_evaluate"] == len(ev.usersToEvaluate)
    assert row["eval_s"] > 0 and row["fit_s"] > 0 and row["peak_gib"] is None  # no device memory on the CPU


def test_toppop_and_itemknn_match_jax(stand_in, low_limits, monkeypatch):
    jax_resident = jsim._gram_resident_bf16
    _, split, _ = stand_in
    ev, jev = _evaluators(split, scale20m.CUTOFFS)
    row, model = scale20m.toppop(split, ev, CPU)
    jm = JaxTopPop(split.train)
    jm.fit()
    want, _ = jev.evaluateRecommender(jm)
    _check_row(row, want, ev, 1e-6)
    assert "RMSE" not in row and row["route"] == "dense ranking"
    assert_metrics_close(ev.evaluateRecommender(model)[0], want, tol=1e-6)

    resident = []
    monkeypatch.setattr(jsim, "_gram_resident_bf16", lambda *a, **k: resident.append(1) or jax_resident(*a, **k))
    row, model = scale20m.itemknn(split, ev, CPU)
    assert row["route"] == "resident bf16 Gram, float32 scoring"
    assert 4 * split.train.shape[0] * split.train.shape[1] > jsim._DENSE_A_BYTE_LIMIT
    assert row["gram_peak"] == "bf16" and row["gram_peak_share"] > 0
    jm = JaxItemKNN(split.train)
    jm.fit(**scale20m.ITEMKNN_PARAMS)
    assert resident  # JAX's build took the resident route too
    want, _ = jev.evaluateRecommender(jm)
    _check_row(row, want, ev, 1e-6)
    assert row["gram_flop"] == 2.0 * 2048 * split.train.shape[1] ** 2  # the rows padded to one chunk
    assert_metrics_close(ev.evaluateRecommender(model)[0], want, tol=1e-6)


@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_puresvd_matches_jax(route, stand_in, low_limits, monkeypatch):
    _, split, _ = stand_in
    if route == "streamed":
        monkeypatch.setattr(jsvd, "_RESIDENT_BF16_LIMIT", 0)
        monkeypatch.setattr(psvd, "RESIDENT_BF16_BYTES", 0)
    ev, jev = _evaluators(split, scale20m.CUTOFFS)
    k, seed = 8, 1234
    omega = np.array(jax.random.normal(jax.random.PRNGKey(seed), (split.train.shape[1], k + psvd.N_OVERSAMPLE),
                                       dtype=jnp.float32))
    row, model = scale20m.puresvd(split, ev, CPU, omega=omega, num_factors=k)
    assert row["route"] == route and model._urm_streams()
    jm = jsvd.PureSVDRecommender(split.train)
    assert jm._urm_streams()
    jm.fit(num_factors=k, random_seed=seed)
    want, _ = jev.evaluateRecommender(jm)
    _check_row(row, want, ev, 1e-5)
    assert_metrics_close(ev.evaluateRecommender(model)[0], want, tol=1e-5)
    assert row["serve_users_per_s"] > 0


def _ials_both(split, scaling, cutoffs, stage):
    ev, jev = _evaluators(split, cutoffs)
    cfg = dict(epochs=2, num_factors=8, confidence_scaling=scaling)
    row, model = stage(split, ev, CPU, **cfg)
    jm = JaxIALS(split.train)
    jm.fit(**dict(scale20m.IALS_PARAMS, **cfg))
    assert (jm._store_users[0], jm._store_items[0]) == (model._store_users[0], model._store_items[0]) == \
        ("flat", "flat")
    assert row["route"] == "csr: users flat, items flat" and row["epoch_s"] > 0
    want, _ = jev.evaluateRecommender(jm)
    _check_row(row, want, ev, 1e-5)
    assert_metrics_close(ev.evaluateRecommender(model)[0], want, tol=1e-5)
    return row, want


@pytest.mark.parametrize("scaling", ["linear", "log"])
def test_ials_matches_jax(scaling, stand_in, low_limits):
    _, split, _ = stand_in
    row, _ = _ials_both(split, scaling, scale20m.CUTOFFS, scale20m.ials)
    assert "RMSE" not in row


def test_explicit_stages_match_jax(stand_in, low_limits, monkeypatch):
    _, _, split = stand_in
    row, want = _ials_both(split, "linear", scale20m.EXPLICIT_CUTOFFS, scale20m.ials_explicit)
    assert row["RMSE"] == pytest.approx(want[20]["RMSE"], abs=1e-5)
    assert row["global_mean_rmse"] == pytest.approx(
        np.sqrt(np.mean((split.test.data - split.train.data.mean()) ** 2)), rel=1e-12)

    ev, jev = _evaluators(split, scale20m.EXPLICIT_CUTOFFS)
    cfg = dict(epochs=2, num_factors=8, batch_size=256)
    jm = JaxFunkSVD(split.train)
    jm.fit(**dict(scale20m.FUNKSVD_EXPLICIT_PARAMS, samples_per_epoch=split.train.nnz, **cfg))
    _jax_draws(monkeypatch, 1234, n_chunks=-(-split.train.nnz // 256), presample=True)
    row, model = scale20m.funksvd_explicit(split, ev, CPU, **cfg)
    want, _ = jev.evaluateRecommender(jm)
    _check_row(row, want, ev, 1e-5)
    assert row["RMSE"] == pytest.approx(want[20]["RMSE"], abs=1e-5)
    assert_metrics_close(ev.evaluateRecommender(model)[0], want, tol=1e-5)


def test_ganmf_matches_jax(stand_in, low_limits, monkeypatch):
    _, split, _ = stand_in
    cfg = dict(num_factors=8, emb_dim=16, epochs=3)
    jm = JaxGANMF(split.train, mode="user", seed=1337, is_experiment=True)
    jm.fit(**dict(scale20m.GANMF_PARAMS, **cfg))
    init = jgm._init_params(jax.random.PRNGKey(1337), *split.train.shape, cfg["num_factors"], cfg["emb_dim"])
    monkeypatch.setattr(pgm, "init_params", lambda n_rows, n_cols, k, e, generator, device:
                        pgm.params_from_jax([np.asarray(p) for p in init], device))
    ev, jev = _evaluators(split, scale20m.CUTOFFS)
    row, model = scale20m.ganmf(split, ev, CPU, **cfg)
    assert row["route"] == "csr" and row["epochs"] == 3 and jm._urm_streams()
    for got, want in zip(model.params.parameters(), jm.params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    want, _ = jev.evaluateRecommender(jm)
    _check_row(row, want, ev, 1e-5)
    assert_metrics_close(ev.evaluateRecommender(model)[0], want, tol=1e-5)


def test_stages_refuse_another_route(stand_in):
    """At the limits' own values a small split takes the dense routes, which
    the scale stages refuse."""
    _, split, _ = stand_in
    ev = EvaluatorHoldout(split.test, scale20m.CUTOFFS, device=CPU)
    with pytest.raises(scale20m.RouteError, match="PureSVD"):
        scale20m.puresvd(split, ev, CPU, num_factors=4)
    with pytest.raises(scale20m.RouteError, match="streamed Gram"):
        scale20m.itemknn(split, ev, CPU)
    with pytest.raises(scale20m.RouteError, match="storage"):
        scale20m.ials(split, ev, CPU, epochs=1, num_factors=4)


# -- (d) the receipt ------------------------------------------------------------------

def _fabricated(map20):
    row = {"n_eval_users": 10, "users_to_evaluate": 10}
    return {"TopPop": dict(row, **{"MAP@20": 0.1}), "PureSVD": dict(row, **{"MAP@20": map20}),
            "FunkSVD_explicit": dict(row, RMSE=1.0, global_mean_rmse=1.0)}


@pytest.mark.parametrize("map20,code", [(0.05, 1), (0.2, 0)], ids=["below_toppop", "above_toppop"])
def test_receipt_decides_the_exit_code(map20, code, stand_in, tmp_path, monkeypatch, capsys):
    _, split, _ = stand_in
    rows = _fabricated(map20)
    assert scale20m.receipt(rows, log=lambda line: None) is (code == 0)
    monkeypatch.setattr(synthetic, "synthesize", lambda path, verbose=True: path)
    monkeypatch.setattr(scale20m, "load_splits", lambda *a, **k: (split, split, {}))
    stages = {name: (key, (lambda r: lambda *a, **k: (r, None))(rows[key]), "implicit")
              for name, key in (("toppop", "TopPop"), ("puresvd", "PureSVD"), ("funksvd_explicit", "FunkSVD_explicit"))}
    monkeypatch.setattr(scale20m, "STAGES", stages)
    out = tmp_path / "rows.json"
    assert scale20m.main(["--out", str(out), "--data-dir", str(tmp_path)], device="cpu") == code
    printed = capsys.readouterr().out
    assert ("CONSISTENCY PureSVD: MAP@20" in printed) and (("-> FAIL" in printed) == bool(code))
    import json

    saved = json.loads(out.read_text())
    assert saved["receipt_ok"] is (code == 0) and set(saved["rows"]) == set(rows)


def test_receipt_holds_funksvd_to_the_floor_and_every_user():
    row = {"n_eval_users": 10, "users_to_evaluate": 10, "MAP@20": 0.0}
    assert not scale20m.receipt({"FunkSVD_explicit": dict(row, RMSE=1.02, global_mean_rmse=1.0)}, log=print)
    assert not scale20m.receipt({"IALS_explicit": dict(row, RMSE=float("nan"))}, log=print)
    assert not scale20m.receipt({"IALS": dict(row, n_eval_users=9)}, log=print)
    assert scale20m.receipt({"FunkSVD_explicit": dict(row, RMSE=1.009, global_mean_rmse=1.0)}, log=print)


# -- (e) no download ---------------------------------------------------------------------

def test_missing_ratings_raise_before_any_download(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        pytest.fail("a download was tried")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        scale20m.load_splits(str(tmp_path / "data"), str(tmp_path / "splits"), log=lambda line: None)
    with pytest.raises(FileNotFoundError, match="ratings.csv is missing"):
        scale20m.read_urm(str(tmp_path / "data"), log=lambda line: None)
    assert not (tmp_path / "splits").exists()
