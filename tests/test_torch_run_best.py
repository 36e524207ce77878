"""The port's split host code and ``run_best`` against the JAX package's, on
the CPU.

A synthetic dataset gets its five-way split from the port's
``make_experiment_splits`` (which must equal the JAX package's), saved under
$GANMF_TPU_SPLIT_DIR as tests/test_cli.py:17-32 does. Both packages'
``run_best`` then train GANMF (user and item mode), DisGANMF, CFGAN, CAAE,
PureSVD, TopPop, IALS, P3alpha, ItemKNN (with its similarity) and SLIM-BPR
from the same best params. The JAX initial weights go
into the port
(``init_params`` monkeypatched), for CFGAN also JAX's per-epoch mask draws,
replayed from its key chain as tests/test_torch_cfgan.py does, for CAAE its
epoch draws (tests/test_torch_caae.py), for PureSVD JAX's Omega and for
SLIM-BPR JAX's triples (tests/test_torch_slim_bpr.py); the GAN shuffles and
the IALS initialisation are the same numpy draws in both packages, and
P3alpha and ItemKNN draw nothing.

Tolerance: every metric of test_results.pkl within 1e-5 of JAX's (float32
training taken in another order, as in tests/test_torch_ganmf_train.py). The
same files are written, and the same result-string lines up to their
numbers.
"""

import os
import pickle
import re

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax

from ganmf_tpu.cli.run_best import run as jax_run_best
from ganmf_tpu.data.splits import make_experiment_splits as jax_make_experiment_splits
from ganmf_tpu.models import cfgan as jcf
from ganmf_tpu.models import disganmf as jdg
from ganmf_tpu.models import ganmf as jgm
from ganmf_tpu_torch.cli import experiment, run_best
from ganmf_tpu_torch.cli.run_best import run
from ganmf_tpu_torch.data.splits import (
    find_split_dir,
    load_reference_splits,
    make_experiment_splits,
    save_experiment_splits,
)
from ganmf_tpu_torch.models import cfgan as pcf
from ganmf_tpu_torch.models import disganmf as pdg
from ganmf_tpu_torch.models import ganmf as pgm
from ganmf_tpu_torch.models import puresvd as psvd
from test_torch_caae import _inject as _inject_caae
from test_torch_slim_bpr import _jax_draws as _inject_slim_draws

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 1337  # run_best's seed
BEST = {
    "GANMF": dict(num_factors=4, emb_dim=8, epochs=3, batch_size=16, d_lr=1e-3, g_lr=1e-3,
                  d_reg=1e-4, g_reg=1e-4, recon_coefficient=0.1),
    "CFGAN": dict(d_nodes=8, g_nodes=16, d_layers=1, g_layers=1, scheme="ZR", d_hidden_act="tanh",
                  g_hidden_act="tanh", epochs=3, d_lr=1e-3, g_lr=1e-3, d_reg=1e-4, g_reg=1e-4,
                  d_batch_size=16, g_batch_size=32, zr_ratio=0.3, zr_coefficient=0.05),
    "DisGANMF": dict(num_factors=4, d_layers=1, d_nodes=8, d_hidden_act="relu", epochs=3, batch_size=16,
                     d_lr=1e-3, g_lr=1e-3, d_reg=1e-4, recon_coefficient=0.2),
    "CAAE": dict(epochs=2, d_steps=2, g_layers=1, g_units=16, num_factors=6, d_bsize=64, lr=0.05, beta=0.01),
    "PureSVD": dict(num_factors=5),
    "TopPop": {},
    # the factors agree within ~1e-5 (CG's residual exit), so the ranking
    # metrics need scores without near-ties: at these params no two
    # consecutive scores of a test user's ranking lie within 5.5e-5 (a CPU
    # measurement), 9x the largest score gap between the packages
    "ALS": dict(num_factors=8, confidence_scaling="linear", alpha=5.0, reg=1e-3, epochs=4),
    "P3Alpha": dict(topK=12, alpha=0.642, normalize_similarity=False),
    "ItemKNN": dict(topK=10, shrink=5, similarity="cosine", normalize=True),
    # presample: JAX's draws in one pass, which the port's fit replays
    "SLIMBPR": dict(topK=15, epochs=3, symmetric=True, sgd_mode="adagrad", lambda_i=2.9e-4, lambda_j=9.4e-9,
                    learning_rate=0.05, presample=True),
}


def _full_urm():
    rng = np.random.RandomState(0)
    return sps.csr_matrix((rng.rand(60, 40) < 0.3).astype(np.float32))


@pytest.fixture
def synth(tmp_path, monkeypatch):
    """A synthetic dataset under the experiment split layout, in a fresh
    working directory."""
    split_dir = tmp_path / "experiments" / "datasets"
    save_experiment_splits(make_experiment_splits(_full_urm(), seed=SEED), "synth", str(split_dir))
    monkeypatch.setenv("GANMF_TPU_SPLIT_DIR", str(split_dir))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_experiment_splits_match_jax():
    got = make_experiment_splits(_full_urm(), seed=SEED)
    want = jax_make_experiment_splits(_full_urm(), seed=SEED)
    for g, w in zip(got, want):
        assert g.shape == w.shape and (g != w).nnz == 0 and g.nnz > 0


def test_splits_load_from_the_split_dir(synth, monkeypatch):
    assert find_split_dir("synth") == os.environ["GANMF_TPU_SPLIT_DIR"]
    splits = experiment.load_urms("synth")
    for g, w in zip(splits, make_experiment_splits(_full_urm(), seed=SEED)):
        assert (g != w).nnz == 0
    monkeypatch.delenv("GANMF_TPU_SPLIT_DIR")
    monkeypatch.chdir(synth / "experiments")  # no experiments/datasets below here
    assert find_split_dir("synth") is None
    with pytest.raises(FileNotFoundError):
        load_reference_splits("synth")


def _inject_jax_state(algo, monkeypatch):
    """The JAX package's initial weights (and CFGAN's mask draws) for the
    port's fit at run_best's seed."""
    if algo == "GANMF":
        def init(n_rows, n_cols, k, e, generator, device):
            leaves = jgm._init_params(jax.random.PRNGKey(SEED), n_rows, n_cols, k, e)
            return pgm.params_from_jax([np.asarray(x) for x in leaves], device)

        monkeypatch.setattr(pgm, "init_params", init)
        return
    if algo == "DisGANMF":
        def init(n_rows, n_cols, k, layers, nodes, generator, device):
            leaves = jdg._init_params(jax.random.PRNGKey(SEED), n_rows, n_cols, k, layers, nodes)
            return pdg.params_from_jax([np.asarray(x) for x in jax.tree_util.tree_leaves(leaves)], device)

        monkeypatch.setattr(pdg, "init_params", init)
        return
    if algo == "CAAE":
        _inject_caae(monkeypatch, SEED)
        return
    if algo in ("TopPop", "ALS", "P3Alpha", "ItemKNN"):
        return  # no draws, or the same numpy initialisation in both packages
    if algo == "SLIMBPR":
        _inject_slim_draws(monkeypatch, 1234, chunk=64)  # fit's default random_seed and chunk_size
        return
    if algo == "PureSVD":
        monkeypatch.setattr(psvd, "draw_omega", lambda n_cols, k, random_seed, device: torch.from_numpy(
            np.array(jax.random.normal(jax.random.PRNGKey(random_seed), (n_cols, k)))).to(device))
        return
    k_g, k_d, chain = jax.random.split(jax.random.PRNGKey(SEED), 3)
    keys = {"epoch": chain}

    def init(g_dims, d_dims, generator, device):
        params = jcf.CFGANParams(G=jcf._init_mlp(k_g, g_dims), D=jcf._init_mlp(k_d, d_dims))
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
        return pcf.params_from_jax(leaves, BEST["CFGAN"]["g_layers"], device)

    def uniforms(self, n_rows, n_cols, scheme):
        keys["epoch"], sub = jax.random.split(keys["epoch"])
        return tuple(torch.from_numpy(np.array(jax.random.uniform(k, (n_rows, n_cols))))
                     for k in jax.random.split(sub))

    monkeypatch.setattr(pcf, "init_params", init)
    monkeypatch.setattr(pcf.CFGAN, "_epoch_uniforms", uniforms)


def _numbers_out(text):
    return [re.sub(r"-?\d+\.\d+", "#", line) for line in text.splitlines()]


@pytest.mark.parametrize("algo,mode", [("GANMF", "user"), ("GANMF", "item"), ("CFGAN", "user"),
                                       ("DisGANMF", "user"), ("CAAE", "user"), ("PureSVD", ""),
                                       ("TopPop", ""), ("ALS", ""), ("P3Alpha", ""), ("ItemKNN", ""),
                                       ("SLIMBPR", "")])
def test_run_best_matches_jax(algo, mode, synth, monkeypatch, capsys):
    sim = "cosine" if algo == "ItemKNN" else ""  # ItemKNN's artifacts carry its similarity
    rec_name = experiment.DICT_REC_CLASSES[algo].RECOMMENDER_NAME
    name = f"{rec_name}_{mode}{sim}_synth"
    (synth / "experiments" / name).mkdir(parents=True)
    (synth / "experiments" / name / "best_params.pkl").write_bytes(pickle.dumps(BEST[algo]))

    want = jax_run_best("synth", algo, train_mode=mode, sim=sim, out_root="jax_results")
    _inject_jax_state(algo, monkeypatch)
    got = run("synth", algo, train_mode=mode, sim=sim, device="cpu")

    out, jax_out = synth / "test_results" / name, synth / "jax_results" / name
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_out)) == [
        f"{rec_name}.zip", "test_results.pkl", "test_results.txt"]
    saved = pickle.loads((out / "test_results.pkl").read_bytes())
    jax_saved = pickle.loads((jax_out / "test_results.pkl").read_bytes())
    assert list(saved) == list(jax_saved) == [5, 10, 20, 50]
    for cutoff, metrics in jax_saved.items():
        assert list(saved[cutoff]) == list(metrics)
        for metric, value in metrics.items():
            assert saved[cutoff][metric] == pytest.approx(value, abs=1e-5, nan_ok=True), (cutoff, metric)
            assert got[cutoff][metric] == saved[cutoff][metric] or np.isnan(value)
    text = (out / "test_results.txt").read_text()
    assert _numbers_out(text) == _numbers_out((jax_out / "test_results.txt").read_text())
    assert "Training time: " in text and text.endswith(" s\n\n")

    # without --force it refuses, and the results stay as they are
    capsys.readouterr()
    assert run("synth", algo, train_mode=mode, sim=sim, device="cpu") is None
    assert "exists; use --force" in capsys.readouterr().out
    assert (out / "test_results.txt").read_text() == text


def test_run_best_needs_a_card_and_a_ported_model(synth, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("synth", "GANMF", train_mode="user")
    # every recommender of ALL_RECOMMENDERS is ported; any other name raises
    with pytest.raises(NotImplementedError, match="MF_BPR is not ported"):
        run("synth", "MF_BPR", device="cpu")
    assert not (synth / "test_results").exists()


def test_cli_parses_as_the_jax_one(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(run_best, "run", lambda *a, **kw: calls.append((a, kw)))
    run_best.main(["--item", "GANMF", "1M", "--force", "--bp", "bp_dir"])
    assert calls == [(("1M", "GANMF", "item", ""), dict(force=True, bp_dir="bp_dir"))]
    run_best.main(["--help"])
    assert "usage: ganmf-torch-run-best" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run_best.main(["GANMF"])
