"""Final test-set evaluation with tuned hyperparameters.

Port of ganmf_tpu/cli/run_best.py (the reference's RunBestParameters.py):
loads best_params.pkl for (dataset, algorithm, mode, similarity), trains on
the full URM_train, evaluates on URM_test at cutoffs [5, 10, 20, 50] and
writes test_results/{NAME}_{mode}{sim}_{dataset}/test_results.{txt,pkl} and
the saved model, in the JAX package's layout. Training runs on the card
unless ``run`` is given ``device="cpu"``; the training time is taken after
the device has finished.

CLI: python -m ganmf_tpu_torch.cli.run_best <dataset> <rec> [--user|--item]
         [<similarity>] [--force] [--bp <dir>]
"""

from __future__ import annotations

import os
import pickle
import sys
import time
from typing import List

import torch

from ganmf_tpu_torch.cli.experiment import (
    ALL_DATASETS,
    ALL_RECOMMENDERS,
    DICT_REC_CLASSES,
    SEED,
    SIMILARITIES,
    load_urms,
    rec_class,
)
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import GAN_MODELS
from ganmf_tpu_torch.utils.device import as_device
from ganmf_tpu_torch.utils.seeding import set_seed


def load_best_params(bp_dir: str, rec_name: str, mode: str, sim: str, dataset: str) -> dict:
    path = os.path.join(bp_dir, f"{rec_name}_{mode}{sim}_{dataset}", "best_params.pkl")
    if not os.path.isfile(path):
        return {}
    with open(path, "rb") as fh:
        return pickle.load(fh)


def run(
    dataset: str,
    algo: str,
    train_mode: str = "",
    sim: str = "",
    force: bool = False,
    bp_dir: str = "experiments",
    out_root: str = "test_results",
    seed: int = SEED,
    device=None,
):
    """Train ``algo`` with its best params and evaluate it on the test split;
    returns the results dict, or None when the results exist and ``force``
    is False. ``device`` defaults to the card and raises without one."""
    device = as_device(device)
    model_class = rec_class(algo)
    rec_name = model_class.RECOMMENDER_NAME
    out_dir = os.path.join(out_root, f"{rec_name}_{train_mode}{sim}_{dataset}")
    result_path = os.path.join(out_dir, "test_results.txt")

    if os.path.exists(result_path) and not force:
        print(f"{result_path} exists; use --force to recompute.")
        return None

    best_params = load_best_params(bp_dir, rec_name, train_mode, sim, dataset)
    print(f"Best params for {rec_name} {train_mode}{sim} on {dataset}: {best_params}")

    set_seed(seed)
    splits = load_urms(dataset)
    evaluator = EvaluatorHoldout(splits.test, [5, 10, 20, 50], exclude_seen=True, device=device)

    t0 = time.time()
    if model_class in GAN_MODELS:
        model = model_class(splits.train, mode=train_mode or "user", seed=seed, is_experiment=True,
                            device=device)
        model.fit(validation_evaluator=None, **best_params)
    else:
        model = model_class(splits.train, device=device)
        model.fit(**best_params)
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the training time includes the device's work
    train_seconds = time.time() - t0

    t0 = time.time()
    results_dict, results_string = evaluator.evaluateRecommender(model)
    test_seconds = time.time() - t0

    os.makedirs(out_dir, exist_ok=True)
    with open(result_path, "a") as fh:
        fh.write(results_string)
        fh.write(f"Training time: {train_seconds:.3f} s\n")
        fh.write(f"Testing time: {test_seconds:.3f} s\n\n")
    with open(os.path.join(out_dir, "test_results.pkl"), "wb") as fh:
        pickle.dump(results_dict, fh, pickle.HIGHEST_PROTOCOL)
    model.saveModel(out_dir)

    print(results_string)
    print(f"Training time: {train_seconds:.1f}s | Testing time: {test_seconds:.1f}s")
    return results_dict


USAGE = (
    "usage: ganmf-torch-run-best <dataset> <rec> [--user|--item] [<similarity>]"
    " [--force] [--bp DIR]\n"
    "  datasets:     " + " ".join(sorted(ALL_DATASETS)) + "\n"
    "  recommenders: " + " ".join(sorted(ALL_RECOMMENDERS))
    + " (ported: " + " ".join(sorted(DICT_REC_CLASSES)) + ")\n"
    "  similarities: " + " ".join(sorted(SIMILARITIES))
)


def main(args: List[str]):
    if not args or "--help" in args or "-h" in args:
        print(USAGE)
        return
    algo = dataset = None
    sim = ""
    train_mode = ""
    force = False
    bp_dir = "experiments"
    i = 0
    while i < len(args):
        arg = args[i]
        if arg in ALL_RECOMMENDERS and algo is None:
            algo = arg
        elif arg in ALL_DATASETS and dataset is None:
            dataset = arg
        elif arg in SIMILARITIES and not sim:
            sim = arg
        elif arg in ("--user", "--item") and not train_mode:
            train_mode = arg[2:]
        elif arg == "--force":
            force = True
        elif arg == "--bp":
            i += 1
            bp_dir = args[i]
        i += 1

    if algo is None or dataset is None:
        raise SystemExit(f"unrecognized or missing <dataset>/<rec> in {args!r}\n{USAGE}")
    run(dataset, algo, train_mode, sim, force=force, bp_dir=bp_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
