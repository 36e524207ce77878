"""Qualitative MF studies (rebuild of MFLearned.py).

Port of ganmf_tpu/cli/mf_learned.py. Every study trains and evaluates on the
card unless it is given ``device="cpu"``.

1. latent_factors_study (:30-63): MAP@5 vs number of latent factors
   K in {10, 30, 50, 100, 150, 250} for GANMF / PureSVD / IALS; each point
   is trained.
2. mf_qualitative_study (:66-152): MAP@20 per user-profile-length decile,
   from the evaluator's per-user average precision.

``per_profile_length_map`` bins the evaluator's per-user AP
(``EvaluatorHoldout.per_user_ap``: the terms of its MAP, from its own
ranking route). The JAX function reads an attribute that its evaluator does
not have (``_test_dense``) and raises.

CLI: python -m ganmf_tpu_torch.cli.mf_learned <dataset> [latent|qualitative]
         [--epochs N] [--bp DIR]
"""

from __future__ import annotations

import json
import os
import pickle
import sys
from typing import Dict, List

import numpy as np

from ganmf_tpu_torch.cli.experiment import load_urms
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import GANMF, IALSRecommender, PureSVDRecommender
from ganmf_tpu_torch.utils.analysis import plot_metric_vs_param
from ganmf_tpu_torch.utils.seeding import set_seed

K_GRID = [10, 30, 50, 100, 150, 250]


def _fit_model(name: str, splits, k: int, base_params: Dict, epochs=None, device=None):
    set_seed(1337)
    if name == "GANMF":
        params = dict(base_params.get("GANMF", {}), num_factors=k)
        if epochs is not None:
            params["epochs"] = epochs
        model = GANMF(splits.train, mode="user", seed=1337, is_experiment=True, device=device)
        model.fit(validation_evaluator=None, **params)
    elif name == "PureSVD":
        model = PureSVDRecommender(splits.train, device=device)
        model.fit(num_factors=k)
    elif name == "ALS":
        params = dict(base_params.get("ALS", {}), num_factors=k)
        params.setdefault("epochs", 15)
        model = IALSRecommender(splits.train, device=device)
        model.fit(**params)
    else:
        raise ValueError(name)
    return model


def _load_best(bp_dir: str, dataset: str):
    out = {}
    for algo, dirname in [("GANMF", f"GANMF_user_{dataset}"), ("ALS", f"IALSRecommender__{dataset}")]:
        path = os.path.join(bp_dir, dirname, "best_params.pkl")
        if os.path.isfile(path):
            with open(path, "rb") as fh:
                out[algo] = pickle.load(fh)
    return out


def latent_factors_study(dataset: str, out_dir: str = "latent_factors", epochs=None,
                         bp_dir: str = "experiments", k_grid: List[int] = None, device=None):
    splits = load_urms(dataset)
    evaluator = EvaluatorHoldout(splits.test, [5], exclude_seen=True, device=device)
    base_params = _load_best(bp_dir, dataset)
    k_grid = k_grid or K_GRID

    series = {}
    for name in ["PureSVD", "ALS", "GANMF"]:
        vals = []
        for k in k_grid:
            model = _fit_model(name, splits, k, base_params, epochs=epochs, device=device)
            results, _ = evaluator.evaluateRecommender(model)
            vals.append(results[5]["MAP"])
            print(f"{name} K={k}: MAP@5={vals[-1]:.5f}", flush=True)
        series[name] = vals

    os.makedirs(out_dir, exist_ok=True)
    plot_metric_vs_param(k_grid, series, os.path.join(out_dir, f"latent_factors_{dataset}.png"),
                         xlabel="number of latent factors", ylabel="MAP@5")
    with open(os.path.join(out_dir, f"latent_factors_{dataset}.json"), "w") as fh:
        json.dump({"K": k_grid, **series}, fh, indent=1)
    return series


def per_profile_length_map(model, splits, cutoff: int = 20, n_bins: int = 10):
    """MAP@cutoff per user-profile-length bin (fast_eval equivalent,
    MFLearned.py:122-133)."""
    evaluator = EvaluatorHoldout(splits.test, [cutoff], exclude_seen=True, device=model.device)
    users, aps = evaluator.per_user_ap(model, cutoff)
    lens = np.ediff1d(splits.train.tocsr().indptr)

    # decile bins over profile length
    user_lens = lens[users]
    edges = np.quantile(user_lens, np.linspace(0, 1, n_bins + 1))
    edges[-1] += 1
    bins = np.digitize(user_lens, edges[1:-1])
    out = []
    for b in range(n_bins):
        mask = bins == b
        out.append({
            "bin": b,
            "len_range": [float(edges[b]), float(edges[b + 1])],
            "n_users": int(mask.sum()),
            "MAP": float(aps[mask].mean()) if mask.any() else 0.0,
        })
    return out


def mf_qualitative_study(dataset: str, out_dir: str = "qualitative_study", epochs=None,
                         bp_dir: str = "experiments", device=None):
    splits = load_urms(dataset)
    base_params = _load_best(bp_dir, dataset)

    results = {}
    for name in ["PureSVD", "ALS", "GANMF"]:
        k = base_params.get(name, {}).get("num_factors", 50)
        model = _fit_model(name, splits, k, base_params, epochs=epochs, device=device)
        results[name] = per_profile_length_map(model, splits)
        print(name, [round(b["MAP"], 4) for b in results[name]], flush=True)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_length_map_{dataset}.json"), "w") as fh:
        json.dump(results, fh, indent=1)

    xs = list(range(len(results["PureSVD"])))
    plot_metric_vs_param(
        xs, {name: [b["MAP"] for b in bins] for name, bins in results.items()},
        os.path.join(out_dir, f"profile_length_map_{dataset}.png"),
        xlabel="user profile length decile", ylabel="MAP@20",
    )
    return results


def main(args: List[str]):
    dataset = args[0]
    study = args[1] if len(args) > 1 else "latent"
    epochs = None
    bp_dir = "experiments"
    if "--epochs" in args:
        epochs = int(args[args.index("--epochs") + 1])
    if "--bp" in args:
        bp_dir = args[args.index("--bp") + 1]
    if study == "latent":
        latent_factors_study(dataset, epochs=epochs, bp_dir=bp_dir)
    else:
        mf_qualitative_study(dataset, epochs=epochs, bp_dir=bp_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
