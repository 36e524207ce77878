"""The port's study CLIs (cli/describe.py, cli/ablation.py, cli/mf_learned.py)
and the host helpers they need (utils/analysis.py, utils/timing.py,
eval/significance.py) against the JAX package's, on the CPU.

A synthetic 60 x 40 dataset gets its five-way split under
$GANMF_TPU_SPLIT_DIR, as tests/test_cli.py:17-32 does. Tolerances:

- the host helpers are copies: equal results (bitwise);
- ``describe``: the same output, line for line;
- the feature-matching sweep and its cosine study (num_factors=4, emb_dim=8,
  one epoch; the GANMF inits come from different generators, so the numbers
  differ): the same files, the same JSON keys and result dicts;
- ``per_profile_length_map``: the per-user APs, averaged over the bins
  weighted by their ``n_users``, within 1e-6 of ``EvaluatorHoldout``'s
  MAP@20 for a factor model (ranked through K1's plain version in the
  evaluator) and one ranked by the dense route. The JAX function raises
  ``AttributeError`` (its evaluator has no ``_test_dense``): pinned here.
"""

import json
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from ganmf_tpu.cli import ablation as jab
from ganmf_tpu.cli import describe as jdescribe
from ganmf_tpu.cli import mf_learned as jml
from ganmf_tpu.eval import significance as jsig
from ganmf_tpu.utils import analysis as jan
from ganmf_tpu.utils import timing as jtiming
from ganmf_tpu_torch.cli import ablation as pab
from ganmf_tpu_torch.cli import describe as pdescribe
from ganmf_tpu_torch.cli import mf_learned as pml
from ganmf_tpu_torch.cli.experiment import load_urms
from ganmf_tpu_torch.data.splits import make_experiment_splits, save_experiment_splits
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.eval import significance as psig
from ganmf_tpu_torch.models import IALSRecommender, PureSVDRecommender, TopPop
from ganmf_tpu_torch.utils import analysis as pan
from ganmf_tpu_torch.utils import timing as ptiming

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture
def synth(tmp_path, monkeypatch):
    """A synthetic dataset under the experiment split layout, in a fresh
    working directory."""
    rng = np.random.RandomState(0)
    full = sps.csr_matrix((rng.rand(60, 40) < 0.3).astype(np.float32))
    split_dir = tmp_path / "experiments" / "datasets"
    save_experiment_splits(make_experiment_splits(full, seed=1337), "synth", str(split_dir))
    monkeypatch.setenv("GANMF_TPU_SPLIT_DIR", str(split_dir))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _urm(seed=3):
    rng = np.random.RandomState(seed)
    dense = (rng.rand(30, 20) < 0.25) * rng.randint(1, 6, (30, 20))
    dense[4] = 0  # a cold user
    dense[:, 7] = 0  # a cold item
    return sps.csr_matrix(dense.astype(np.float32))


HELPERS = {
    "gini": lambda m, x: m.gini(x.toarray().sum(0)),
    "gini_negative": lambda m, x: m.gini(x.toarray()[0] - 2.5),
    "dense_spmatrix": lambda m, x: m.dense_spmatrix(x),
    "dense_spmatrix_array": lambda m, x: m.dense_spmatrix(x.toarray().astype(np.float64)),
    "cosine_sim": lambda m, x: m.cosine_sim(x.toarray().astype(np.float64)),
    "cos_sim_pairs": lambda m, x: m.cos_sim_pairs(list(x.toarray()[:10]), list(x.toarray()[10:20])),
    "describe_urm": lambda m, x: m.describe_urm(x, "synth/train"),
    "estimate_sparse_size": lambda m, x: m.estimate_sparse_size(138493, 26744, 0.0054, 4, 8),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_analysis_helpers_match_jax(name):
    got, want = HELPERS[name](pan, _urm()), HELPERS[name](jan, _urm())
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("plot", ["plot_loss", "plot_metric_vs_param"])
def test_plots_behave_like_jax(plot, tmp_path, capsys):
    """With matplotlib the plot is written; without it both packages print
    the same skip message."""
    args = {"plot_loss": lambda m, p: m.plot_loss({"d": [3.0, 2.0, 1.5]}, p),
            "plot_metric_vs_param": lambda m, p: m.plot_metric_vs_param([1, 2], {"MAP": [0.1, 0.2]}, p, xlabel="K")}
    outs = []
    for mod, sub in ((pan, "port"), (jan, "jax")):
        path = str(tmp_path / sub / "plot.png")
        args[plot](mod, path)
        outs.append((os.path.exists(path), capsys.readouterr().out.replace(sub, "")))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("seconds", [0.5, 59.0, 61.0, 3600.0, 90000.0, 4e7])
def test_timing_matches_jax(seconds):
    assert ptiming.seconds_to_biggest_unit(seconds) == jtiming.seconds_to_biggest_unit(seconds)


def test_significance_matches_jax():
    rng = np.random.RandomState(1)
    repos = []
    for mod in (psig, jsig):
        rs = [mod.KFoldResultRepository(5) for _ in range(3)]
        for r_i, r in enumerate(rs):
            for fold in range(5):
                r.set_results_in_fold(fold, {"MAP": 0.1 + 0.01 * r_i + rng.rand() * 0.005,
                                             "NDCG": 0.2 + rng.rand() * 0.01})
        rng = np.random.RandomState(1)  # the same results for the other package
        repos.append(rs)
    got, want = psig.compute_k_fold_significance(repos[0]), jsig.compute_k_fold_significance(repos[1])
    assert got == want
    assert repos[0][0].get_results() == repos[1][0].get_results()
    with pytest.raises(ValueError):
        repos[0][0].set_results_in_fold(0, {"MAP": 0.0})


def test_describe_matches_jax(synth, capsys):
    pdescribe.main(["synth"])
    got = capsys.readouterr().out
    jdescribe.main(["synth"])
    want = capsys.readouterr().out
    assert got == want and got.count('"name"') == 5
    pdescribe.main([])
    assert "ganmf-torch-describe" in capsys.readouterr().out


BASE = dict(num_factors=4, emb_dim=8, batch_size=16, m=2, d_lr=1e-3, g_lr=1e-3, d_reg=1e-4,
            recon_coefficient=0.3)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".json"):
                with open(path) as fh:
                    out[rel] = sorted(json.load(fh))
            elif f.endswith(".pkl"):
                with open(path, "rb") as fh:
                    res = pickle.load(fh)
                out[rel] = {c: sorted(v) for c, v in res.items()}
            else:
                out[rel] = None
    return out


def test_feature_matching_studies_write_what_jax_writes(synth):
    """The sweep (11 alphas) and the cosine study: the same files and keys."""
    got = pab.feature_matching_coefficient("synth", base_params=BASE, out_dir="port", epochs=1, device=CPU)
    want = jab.feature_matching_coefficient("synth", base_params=BASE, out_dir="jax", epochs=1)
    assert got[0] == want[0] and len(got[1]) == len(got[2]) == 11
    assert all(np.isfinite(got[1])) and all(np.isfinite(got[2]))
    stats = pab.feature_matching_cos_sim("synth", base_params=BASE, out_dir="port", epochs=1, sample_users=20,
                                         device=CPU)
    jstats = jab.feature_matching_cos_sim("synth", base_params=BASE, out_dir="jax", epochs=1, sample_users=20)
    assert {k: sorted(v) for k, v in stats.items()} == {k: sorted(v) for k, v in jstats.items()}
    assert all(-1 <= s["mean_cos_sim"] <= 1 for s in stats.values())
    tree = _tree(synth / "port")
    assert tree == _tree(synth / "jax")
    assert sum(not f.endswith(".png") for f in tree) == 13  # 11 result pickles, 2 JSON files


def test_bin_ganmf_tunes_and_runs_best(synth, monkeypatch):
    """binGANMF: DisGANMF tuned by RecSysExp (2 evaluations, epochs cut to
    2) and trained by run_best from the tuned params, on the CPU."""
    from ganmf_tpu_torch.tune import Categorical

    dims = [Categorical([2], name="epochs") if d.name == "epochs" else d for d in pab.DICT_DIMENSIONS["DisGANMF"]]
    monkeypatch.setitem(pab.DICT_DIMENSIONS, "DisGANMF", dims)
    results = pab.run_binGANMF("synth", "user", evals=2, device=CPU)
    assert sorted(results) == [5, 10, 20, 50] and np.isfinite(results[5]["MAP"])
    assert sorted(os.listdir(synth / "experiments" / "DisGANMF_user_synth")) == [
        "best_params.pkl", "best_params.txt", "checkpoint.pkl", "results.txt"]
    assert os.path.isfile(synth / "test_results" / "DisGANMF_user_synth" / "test_results.txt")


def _fitted(name, train):
    if name == "PureSVD":
        model = PureSVDRecommender(train, device=CPU)
        model.fit(num_factors=6)
    elif name == "ALS":
        model = IALSRecommender(train, device=CPU)
        model.fit(num_factors=5, epochs=3)
    else:
        model = TopPop(train, device=CPU)
        model.fit()
    return model


@pytest.mark.parametrize("name", ["PureSVD", "ALS", "TopPop"])
def test_per_profile_length_map_averages_to_the_evaluators_map(synth, name):
    splits = load_urms("synth")
    model = _fitted(name, splits.train)
    bins = pml.per_profile_length_map(model, splits)
    assert len(bins) == 10 and [b["bin"] for b in bins] == list(range(10))
    ev = EvaluatorHoldout(splits.test, [20], device=CPU)
    want, _ = ev.evaluateRecommender(model)
    n = sum(b["n_users"] for b in bins)
    assert n == len(ev.usersToEvaluate)
    got = sum(b["MAP"] * b["n_users"] for b in bins) / n
    assert got == pytest.approx(want[20]["MAP"], abs=1e-6)
    users, aps = ev.per_user_ap(model, 20)
    assert np.array_equal(users, ev.usersToEvaluate) and np.all((aps >= 0) & (aps <= 1))


def test_jax_per_profile_length_map_raises(synth):
    """The JAX function reads ``evaluator._test_dense``
    (ganmf_tpu/cli/mf_learned.py:106), which its EvaluatorHoldout lacks."""
    from ganmf_tpu.data.splits import load_reference_splits
    from ganmf_tpu.models import PureSVDRecommender as JaxPureSVD

    splits = load_reference_splits("synth")
    model = JaxPureSVD(splits.train)
    model.fit(num_factors=6)
    with pytest.raises(AttributeError, match="_test_dense"):
        jml.per_profile_length_map(model, splits)


def test_latent_and_qualitative_studies_run(synth):
    series = pml.latent_factors_study("synth", out_dir="latent", epochs=1, k_grid=[2, 3], device=CPU)
    assert sorted(series) == ["ALS", "GANMF", "PureSVD"] and all(len(v) == 2 for v in series.values())
    with open(synth / "latent" / "latent_factors_synth.json") as fh:
        assert sorted(json.load(fh)) == ["ALS", "GANMF", "K", "PureSVD"]
    results = pml.mf_qualitative_study("synth", out_dir="qual", epochs=1, device=CPU)
    assert sorted(results) == ["ALS", "GANMF", "PureSVD"]
    assert all(len(b) == 10 for b in results.values())
    assert os.path.isfile(synth / "qual" / "profile_length_map_synth.json")
