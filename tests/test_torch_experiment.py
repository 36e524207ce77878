"""The port's experiment harness (cli/experiment.py: RecSysExp, main) against
the JAX package's, on the CPU.

Both packages tune on the synthetic five-way split of
tests/test_torch_run_best.py, each under its own logs root:

- TopPop, with no dimensions, runs no trial and records the same empty
  best_params.pkl and best_params.txt;
- ALS (the IALS space with ``epochs`` Categorical([6])): 4 evaluations from
  the same random starts, then a resume to 5 from JAX's checkpoint, whose
  point the GP proposes (the port's numpy GP, JAX's sklearn GP). The trial
  parameters in results.txt and checkpoint.pkl are equal, best_params.pkl is equal (early stopping's epochs
  included), and every metric and objective value lies within 1e-5;
- GANMF (its space with ``epochs`` Categorical([2])): 2 evaluations, with
  JAX's initial weights injected into the port's fit, under the harness's
  early stopping (every 5 epochs, so no stop) and under one that evaluates
  every epoch with no patience, so that the last-epoch rule of
  RecSysExp.py:223-226 may rewrite ``epochs``: the same parameters are
  recorded, metrics within 1e-5;
- ItemKNN with a similarity (its extra dimensions appended, as ``main``
  does): 2 evaluations, the same records, metrics within 1e-5;
- SLIM-BPR (its space with ``epochs`` Categorical([5])) takes the
  early-stopping branch, with JAX's draws replayed
  (tests/test_torch_slim_bpr.py): 2 evaluations, early stopping's epochs in
  best_params.pkl, the same records, metrics within 1e-5;
- ``main`` parses the JAX command lines into the same RecSysExp arguments,
  every name of ``ALL_RECOMMENDERS`` has a class and any other name raises;
  the card is the default device;
  a trial that runs the card out of memory scores 0, any other error raises.
"""

import json
import os
import pickle
import re
import shutil

import numpy as np
import pytest
import torch

from ganmf_tpu.cli import experiment as jexp
from ganmf_tpu.cli import spaces as jspaces
from ganmf_tpu.tune import Categorical as JaxCategorical
from ganmf_tpu_torch.cli import experiment, spaces
from ganmf_tpu_torch.tune import Categorical
from ganmf_tpu_torch.tune.gp import load
from test_torch_run_best import _inject_jax_state, synth  # noqa: F401  (a fixture)
from test_torch_slim_bpr import _jax_draws

NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def _dims(module, categorical, algo, epochs):
    dims = [d for d in module.DICT_DIMENSIONS[algo] if d.name != "epochs"]
    return dims + ([categorical([epochs], name="epochs")] if epochs is not None else [])


def _tune_both(algo, evals, epochs=None, mode="", before_tune=None, similarity=""):
    """Tune ``algo`` with both packages; returns the two experiment dirs."""
    out = []
    for pkg, module, cat, root in ((jexp, jspaces, JaxCategorical, "jax_experiments"),
                                   (experiment, spaces, Categorical, "experiments")):
        dims = _dims(module, cat, algo, epochs)
        if similarity:  # as main appends them
            dims += [cat([similarity], name="similarity")] + module.similarity_extra_dimensions(similarity)
        kw = dict(device="cpu") if pkg is experiment else {}
        exp = pkg.RecSysExp(pkg.DICT_REC_CLASSES[algo], "synth", fit_param_names=[d.name for d in dims],
                            train_mode=mode, similarity_mode=similarity, logs_root=root, **kw)
        if before_tune:
            before_tune(exp)
        exp.tune(dims, evals=evals)
        out.append(exp.logsdir)
    return out


def _trials(text):
    """[(params, the result string's numbers)] of results.txt's trials: a
    trial is a JSON line and the result lines up to the next blank line."""
    trials = []
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if line.startswith("{"):
            end = lines.index("", i)
            trials.append((json.loads(line), [float(x) for x in NUM.findall("\n".join(lines[i + 1:end]))]))
    return trials


def _assert_same_experiment(jax_dir, dir_, n_trials):
    with open(os.path.join(jax_dir, "best_params.pkl"), "rb") as fh:
        want = pickle.load(fh)
    with open(os.path.join(dir_, "best_params.pkl"), "rb") as fh:
        got = pickle.load(fh)
    assert got == want
    with open(os.path.join(dir_, "best_params.txt")) as fh, open(os.path.join(jax_dir, "best_params.txt")) as jfh:
        assert fh.read() == jfh.read()
    if n_trials == 0:
        assert sorted(os.listdir(dir_)) == sorted(os.listdir(jax_dir)) == ["best_params.pkl", "best_params.txt"]
        return
    assert sorted(os.listdir(dir_)) == sorted(os.listdir(jax_dir)) == [
        "best_params.pkl", "best_params.txt", "checkpoint.pkl", "results.txt"]
    with open(os.path.join(dir_, "results.txt")) as fh, open(os.path.join(jax_dir, "results.txt")) as jfh:
        text, jtext = fh.read(), jfh.read()
    trials, jtrials = _trials(text), _trials(jtext)
    assert len(trials) == len(jtrials) == n_trials
    for (params, numbers), (jparams, jnumbers) in zip(trials, jtrials):
        assert params == jparams
        np.testing.assert_allclose(numbers, jnumbers, rtol=0, atol=1e-5)
    assert [line.split(":")[0] for line in text.splitlines() if line.startswith("Best")] == \
        [line.split(":")[0] for line in jtext.splitlines() if line.startswith("Best")]
    ck, jck = load(os.path.join(dir_, "checkpoint.pkl")), load(os.path.join(jax_dir, "checkpoint.pkl"))
    with open(os.path.join(dir_, "checkpoint.pkl"), "rb") as fh:
        assert b"ganmf_tpu_torch.tune.gp" in fh.read()  # the port pickles its own class
    assert ck.x_iters == jck.x_iters and ck.x == jck.x
    np.testing.assert_allclose(ck.func_vals, jck.func_vals, rtol=0, atol=1e-5)


def test_toppop_records_an_empty_config(synth):
    jax_dir, dir_ = _tune_both("TopPop", evals=10)
    _assert_same_experiment(jax_dir, dir_, n_trials=0)
    with open(os.path.join(dir_, "best_params.pkl"), "rb") as fh:
        assert pickle.load(fh) == {}


def test_als_tunes_and_resumes_as_jax(synth):
    jax_dir, dir_ = _tune_both("ALS", evals=4, epochs=6)
    _assert_same_experiment(jax_dir, dir_, n_trials=4)
    # resumed, the GP proposes the fifth point. The port's objective values
    # lie within 1e-7 of JAX's, and a GP fitted to values that differ at all
    # may settle in another optimum of its likelihood, so the port resumes
    # from JAX's checkpoint: from equal histories the GPs propose equal points
    shutil.copy(os.path.join(jax_dir, "checkpoint.pkl"), os.path.join(dir_, "checkpoint.pkl"))
    _tune_both("ALS", evals=5, epochs=6)
    _assert_same_experiment(jax_dir, dir_, n_trials=5)
    with open(os.path.join(dir_, "best_params.pkl"), "rb") as fh:
        best = pickle.load(fh)
    assert set(best) == {"num_factors", "confidence_scaling", "alpha", "reg", "epsilon", "epochs"}
    assert best["epochs"] in (0, 5)  # early stopping validates every 5 epochs

    # run_best reads it: the same fit, from the card's default set to the CPU
    from ganmf_tpu_torch.cli.run_best import run

    results = run("synth", "ALS", device="cpu")
    assert np.isfinite(results[5]["MAP"])


@pytest.mark.parametrize("similarity", ["cosine", "asymmetric"])
def test_itemknn_with_a_similarity_tunes_as_jax(similarity, synth):
    jax_dir, dir_ = _tune_both("ItemKNN", evals=2, similarity=similarity)
    assert dir_.endswith(f"ItemKNNCFRecommender_{similarity}_synth")
    _assert_same_experiment(jax_dir, dir_, n_trials=2)
    with open(os.path.join(dir_, "best_params.pkl"), "rb") as fh:
        assert pickle.load(fh)["similarity"] == similarity


def test_slimbpr_takes_the_early_stopping_branch_as_jax(synth, monkeypatch):
    _jax_draws(monkeypatch, 1234, presample=False, chunk=64)  # fit's defaults
    jax_dir, dir_ = _tune_both("SLIMBPR", evals=2, epochs=5)
    _assert_same_experiment(jax_dir, dir_, n_trials=2)
    with open(os.path.join(dir_, "best_params.pkl"), "rb") as fh:
        best = pickle.load(fh)
    assert best["epochs"] == 5  # early stopping's, from the validation after epoch 5


def _every_epoch_no_patience(exp):
    exp.my_early_stopping.update(freq=1, allow_worse=0)


@pytest.mark.parametrize("stopping", ["default", "every_epoch"])
def test_ganmf_branch_matches_jax(stopping, synth, monkeypatch):
    _inject_jax_state("GANMF", monkeypatch)
    before = _every_epoch_no_patience if stopping == "every_epoch" else None
    jax_dir, dir_ = _tune_both("GANMF", evals=2, epochs=2, mode="user", before_tune=before)
    _assert_same_experiment(jax_dir, dir_, n_trials=2)
    if stopping == "default":
        # no stop: fit returns epochs + 1 (the reference's loop counter), and
        # the rule records 3 - allow_worse * freq = -22, as in JAX
        with open(os.path.join(dir_, "results.txt")) as fh:
            assert [params["epochs"] for params, _ in _trials(fh.read())] == [-22, -22]


def test_recsysexp_needs_a_card(synth, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiment.RecSysExp(experiment.TopPop, "synth")


def test_out_of_memory_scores_zero_and_nothing_else_is_caught(synth, monkeypatch, capsys):
    exp = experiment.RecSysExp(experiment.TopPop, "synth", device="cpu")
    exp.dimension_names = []

    def oom(self):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(experiment.TopPop, "fit", oom)
    assert exp.obj_func([]) == 0
    assert "out of device memory" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(exp.logsdir, "results.txt"))

    def other(self):
        raise RuntimeError("out of memory")  # the JAX package's string test would score this 0

    monkeypatch.setattr(experiment.TopPop, "fit", other)
    with pytest.raises(RuntimeError):
        exp.obj_func([])
    assert experiment.is_resource_exhausted(torch.cuda.OutOfMemoryError("x"))
    assert not experiment.is_resource_exhausted(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))


class _Recorder:
    calls = []

    def __init__(self, recommender_class, dataset, **kw):
        self.call = [recommender_class.RECOMMENDER_NAME, dataset, kw]
        _Recorder.calls.append(self.call)

    def tune(self, dims, evals=10):
        self.call.append(([d.name for d in dims], evals))


COMMAND_LINES = [
    ["1M", "GANMF", "--user"],
    ["--item", "CFGAN", "LastFM", "--evals", "7"],
    ["LastFM", "ALS"],
    ["TopPop", "1M", "--evals", "3"],
    ["PureSVD", "hetrec2011", "cosine"],
    ["DisGANMF", "--user", "1M", "--user", "--item"],
    ["CAAE", "LastFM", "--evals", "1"],
    ["LastFM", "SLIMBPR"],
    ["ItemKNN", "LastFM", "cosine"],
    ["P3Alpha", "1M"],
    ["--evals", "3", "ItemKNN", "asymmetric", "hetrec2011"],
]


@pytest.mark.parametrize("args", COMMAND_LINES, ids=[" ".join(a) for a in COMMAND_LINES])
def test_main_parses_as_the_jax_one(args, monkeypatch):
    got = []
    for module in (jexp, experiment):
        _Recorder.calls = []
        monkeypatch.setattr(module, "RecSysExp", _Recorder)
        module.main(list(args))
        got.append(_Recorder.calls)
    assert got[0] == got[1] and len(got[0]) == 1


def test_main_usage_build_and_unported(monkeypatch, capsys):
    experiment.main(["--help"])
    assert "usage: ganmf-torch-exp" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        experiment.main(["GANMF"])
    built = []
    monkeypatch.setattr(experiment, "load_urms", built.append)
    experiment.main(["--build-dataset", "LastFM", "GANMF"])
    assert built == ["LastFM"]
    monkeypatch.setattr(experiment, "RecSysExp", _Recorder)
    # every recommender of the JAX package's list is ported
    for algo in experiment.ALL_RECOMMENDERS:
        assert experiment.rec_class(algo) is experiment.DICT_REC_CLASSES[algo]
    assert experiment.EARLY_STOPPING_ALGOS == [experiment.IALSRecommender, experiment.SLIM_BPR]
    with pytest.raises(NotImplementedError, match="MF_BPR is not ported"):
        experiment.rec_class("MF_BPR")
    with pytest.raises(ValueError, match="no similarity"):
        experiment.main(["ItemKNN", "LastFM"])
