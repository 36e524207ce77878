"""Ablation studies (rebuild of AblationStudy.py).

Port of ganmf_tpu/cli/ablation.py. Every study trains and evaluates on the
card unless it is given ``device="cpu"``.

1. binGANMF (:134-145): tune/evaluate DisGANMF — GANMF's MF generator with
   a binary-classifier discriminator — in user and item mode, through the
   port's ``RecSysExp`` and ``run_best``.
2. feature-matching coefficient (:33-63): sweep the GANMF
   recon_coefficient (feature-matching weight) alpha over {0.0 .. 1.0},
   train with the otherwise-best params and plot MAP@5 / NDCG@5 vs alpha.
3. feature-matching cosine similarity (:66-131): user-user cosine
   heatmap statistics of predictions with alpha = best vs alpha = 0.

CLI: python -m ganmf_tpu_torch.cli.ablation <dataset> [binGANMF|feature-matching]
         [--user|--item] [--epochs N] [--bp DIR]
"""

from __future__ import annotations

import json
import os
import pickle
import sys
from typing import List

import numpy as np

from ganmf_tpu_torch.cli.experiment import DICT_DIMENSIONS, DICT_REC_CLASSES, RecSysExp, load_urms
from ganmf_tpu_torch.cli.run_best import run as run_best
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import GANMF
from ganmf_tpu_torch.utils.analysis import cosine_sim, plot_metric_vs_param
from ganmf_tpu_torch.utils.seeding import set_seed


def run_binGANMF(dataset: str, train_mode: str = "user", evals: int = 50, device=None):
    """Tune then test DisGANMF (reference AblationStudy.py:134-145)."""
    dims = list(DICT_DIMENSIONS["DisGANMF"])
    exp = RecSysExp(
        DICT_REC_CLASSES["DisGANMF"], dataset=dataset,
        fit_param_names=[d.name for d in dims], seed=1337, train_mode=train_mode, device=device,
    )
    exp.tune(dims, evals=evals)
    return run_best(dataset, "DisGANMF", train_mode=train_mode, force=True, device=device)


def _base_params(base_params, bp_dir, train_mode, dataset, epochs):
    if base_params is None:
        path = os.path.join(bp_dir, f"GANMF_{train_mode}_{dataset}", "best_params.pkl")
        with open(path, "rb") as fh:
            base_params = pickle.load(fh)
    if epochs is not None:
        base_params = dict(base_params, epochs=epochs)
    return base_params


def feature_matching_coefficient(
    dataset: str,
    train_mode: str = "user",
    base_params: dict = None,
    out_dir: str = "feature_matching",
    epochs: int = None,
    bp_dir: str = "experiments",
    device=None,
):
    """Sweep recon_coefficient over 0.0..1.0 and plot MAP/NDCG@5."""
    base_params = _base_params(base_params, bp_dir, train_mode, dataset, epochs)
    splits = load_urms(dataset)
    evaluator = EvaluatorHoldout(splits.test, [5], exclude_seen=True, device=device)

    alphas = [round(a / 10, 1) for a in range(11)]
    maps, ndcgs = [], []
    for alpha in alphas:
        set_seed(1337)
        params = dict(base_params, recon_coefficient=alpha)
        model = GANMF(splits.train, mode=train_mode, seed=1337, is_experiment=True, device=device)
        model.fit(validation_evaluator=None, **params)
        results, _ = evaluator.evaluateRecommender(model)
        maps.append(results[5]["MAP"])
        ndcgs.append(results[5]["NDCG"])
        print(f"alpha={alpha}: MAP@5={maps[-1]:.5f} NDCG@5={ndcgs[-1]:.5f}", flush=True)

        run_dir = os.path.join(out_dir, f"GANMF_{train_mode}_{dataset}_{int(alpha*10):02d}")
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "test_results.pkl"), "wb") as fh:
            pickle.dump(results, fh)

    plot_metric_vs_param(
        alphas, {"MAP@5": maps, "NDCG@5": ndcgs},
        os.path.join(out_dir, f"feature_matching_{train_mode}_{dataset}.png"),
        xlabel="feature matching coefficient",
    )
    with open(os.path.join(out_dir, f"feature_matching_{train_mode}_{dataset}.json"), "w") as fh:
        json.dump({"alpha": alphas, "MAP@5": maps, "NDCG@5": ndcgs}, fh, indent=1)
    return alphas, maps, ndcgs


def feature_matching_cos_sim(
    dataset: str,
    train_mode: str = "user",
    base_params: dict = None,
    out_dir: str = "feature_matching",
    epochs: int = None,
    bp_dir: str = "experiments",
    sample_users: int = 512,
    device=None,
):
    """Mean user-user cosine similarity of predictions with and without
    feature matching (reference AblationStudy.py:66-131)."""
    base_params = _base_params(base_params, bp_dir, train_mode, dataset, epochs)
    splits = load_urms(dataset)
    rng = np.random.RandomState(1337)
    n_users = splits.train.shape[0]
    uids = rng.choice(n_users, size=min(sample_users, n_users), replace=False)

    stats = {}
    for label, alpha in [("with_fm", base_params["recon_coefficient"]), ("without_fm", 0.0)]:
        set_seed(1337)
        params = dict(base_params, recon_coefficient=alpha)
        model = GANMF(splits.train, mode=train_mode, seed=1337, is_experiment=True, device=device)
        model.fit(validation_evaluator=None, **params)
        preds = model._compute_item_score(uids).cpu().numpy()
        sim = cosine_sim(preds.astype(np.float64))
        off_diag = sim[~np.eye(len(uids), dtype=bool)]
        stats[label] = {"mean_cos_sim": float(off_diag.mean()), "std": float(off_diag.std())}
        print(label, stats[label], flush=True)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"cos_sim_{train_mode}_{dataset}.json"), "w") as fh:
        json.dump(stats, fh, indent=1)
    return stats


USAGE = (
    "usage: ganmf-torch-ablation <dataset> [binGANMF|feature-matching]"
    " [--user|--item] [--epochs N] [--bp DIR]"
)


def main(args: List[str]):
    if not args or "--help" in args or "-h" in args:
        print(USAGE)
        return
    dataset = args[0]
    study = args[1] if len(args) > 1 else "feature-matching"
    train_mode = "item" if "--item" in args else "user"
    epochs = None
    bp_dir = "experiments"
    if "--epochs" in args:
        epochs = int(args[args.index("--epochs") + 1])
    if "--bp" in args:
        bp_dir = args[args.index("--bp") + 1]

    if study == "binGANMF":
        run_binGANMF(dataset, train_mode)
    elif study == "feature-matching":
        feature_matching_coefficient(dataset, train_mode, epochs=epochs, bp_dir=bp_dir)
        feature_matching_cos_sim(dataset, train_mode, epochs=epochs, bp_dir=bp_dir)
    else:
        raise SystemExit(f"unknown study {study}")


if __name__ == "__main__":
    main(sys.argv[1:])
