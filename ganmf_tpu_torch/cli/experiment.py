"""Hyperparameter-search experiment harness.

Port of ganmf_tpu/cli/experiment.py (the reference's RecSysExp.py:166-573):
one experiment directory per (algorithm, mode, similarity, dataset) with
best_params.pkl, best_params.txt, results.txt and checkpoint.pkl, a Bayesian
search over the reference's spaces (tune/, cli/spaces.py) with skopt-style
checkpoint resume, the GAN and baseline branches, and the five committed URM
splits as inputs. ``run_best`` shares its names and ``load_urms``.

Models and evaluators run on the card unless ``RecSysExp`` is given
``device="cpu"``. ``DICT_REC_CLASSES`` holds a class for every name of
``ALL_RECOMMENDERS``; ``rec_class`` raises for any other name.

CLI: python -m ganmf_tpu_torch.cli.experiment [--build-dataset] <dataset> <rec>
         [--user | --item] [<similarity>] [--evals N]
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time
from typing import List, Optional

import torch

from ganmf_tpu_torch.cli.spaces import DICT_DIMENSIONS, similarity_extra_dimensions
from ganmf_tpu_torch.data.splits import SplitSet, load_reference_splits, make_experiment_splits, save_experiment_splits
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import (
    CAAE,
    CFGAN,
    GAN_MODELS,
    GANMF,
    DisGANMF,
    IALSRecommender,
    ItemKNNCFRecommender,
    P3alphaRecommender,
    PureSVDRecommender,
    SLIM_BPR,
    TopPop,
)
from ganmf_tpu_torch.tune import Categorical, Integer
from ganmf_tpu_torch.tune.gp import CheckpointSaver, dummy_minimize, gp_minimize, load
from ganmf_tpu_torch.utils.device import as_device
from ganmf_tpu_torch.utils.seeding import set_seed

SEED = 1337

DATASET_KWARGS = dict(
    use_local=True, force_rebuild=True, implicit=True, save_local=False,
    verbose=False, split=True, split_ratio=[0.8, 0.2, 0], min_ratings_user=2,
)

# the reference's experiment trio plus the larger Movielens versions
ALL_DATASETS = ["1M", "hetrec2011", "LastFM", "100K", "10M", "20M"]
ALL_RECOMMENDERS = [
    "TopPop", "PureSVD", "ALS", "SLIMBPR", "ItemKNN", "P3Alpha",
    "CFGAN", "CAAE", "GANMF", "DisGANMF",
]
SIMILARITIES = ["cosine", "jaccard", "tversky", "dice", "euclidean", "asymmetric"]
SIMILARITY_ALGOS = ["ItemKNN"]

DICT_REC_CLASSES = {
    "CAAE": CAAE,
    "CFGAN": CFGAN,
    "GANMF": GANMF,
    "DisGANMF": DisGANMF,
    "TopPop": TopPop,
    "ALS": IALSRecommender,
    "PureSVD": PureSVDRecommender,
    "SLIMBPR": SLIM_BPR,
    "P3Alpha": P3alphaRecommender,
    "ItemKNN": ItemKNNCFRecommender,
}

EARLY_STOPPING_ALGOS = [IALSRecommender, SLIM_BPR]


def rec_class(algo: str):
    """The model class for a recommender name of ``ALL_RECOMMENDERS``;
    raises for any other name."""
    if algo not in DICT_REC_CLASSES:
        raise NotImplementedError(
            f"{algo} is not ported to ganmf_tpu_torch yet (ported: {', '.join(sorted(DICT_REC_CLASSES))})")
    return DICT_REC_CLASSES[algo]


def notify(message: str) -> None:
    """Experiment push notifications. The reference shells out to
    telegram-send (RecSysExp.py:335); here any notifier command can be set
    via GANMF_TPU_NOTIFY (default: print)."""
    cmd = os.environ.get("GANMF_TPU_NOTIFY")
    if cmd:
        try:
            subprocess.run([cmd, message], check=False)
        except OSError:
            pass
    print(f"[notify] {message}")


def load_urms(dataset: str, exp_path: str = os.path.join("experiments", "datasets")) -> SplitSet:
    """Load the five committed splits, building and saving them from the raw
    data if absent (RecSysExp.load_URMs, :153-163)."""
    try:
        return load_reference_splits(dataset, split_dir=None)
    except FileNotFoundError:
        pass
    from ganmf_tpu_torch.data.datasets import LastFM, Movielens

    set_seed(SEED)
    if dataset == "LastFM":
        reader = LastFM(**DATASET_KWARGS)
    else:
        reader = Movielens(version=dataset, **DATASET_KWARGS)
    splits = make_experiment_splits(reader.urm, seed=SEED)
    os.makedirs(exp_path, exist_ok=True)
    save_experiment_splits(splits, dataset, exp_path)
    return splits


def is_resource_exhausted(err: Exception) -> bool:
    """True for the card running out of memory: the one failure a trial is
    scored 0 for (RecSysExp.py:290-291)."""
    return isinstance(err, torch.cuda.OutOfMemoryError)


class RecSysExp:
    def __init__(
        self,
        recommender_class,
        dataset: str,
        fit_param_names: Optional[List[str]] = None,
        metric: str = "MAP",
        method: str = "bayesian",
        at: int = 5,
        verbose: bool = True,
        seed: int = SEED,
        train_mode: str = "",
        similarity_mode: str = "",
        logs_root: str = "experiments",
        *,
        device=None,
    ):
        """``device`` defaults to the card and raises without one."""
        self.device = as_device(device)
        set_seed(seed)
        self.recommender_class = recommender_class
        self.dataset_name = dataset
        self.fit_param_names = list(fit_param_names or [])
        self.metric = metric
        self.method = method
        self.at = at
        self.verbose = verbose
        self.seed = seed
        self.train_mode = train_mode
        self.similarity_mode = similarity_mode
        self.isGAN = recommender_class in GAN_MODELS

        self.logsdir = os.path.join(
            logs_root,
            recommender_class.RECOMMENDER_NAME + "_" + train_mode + similarity_mode + "_" + dataset,
        )
        os.makedirs(self.logsdir, exist_ok=True)

        splits = load_urms(dataset)
        self.URM_train = splits.train
        self.URM_test = splits.test
        self.URM_validation = splits.validation
        self.URM_train_small = splits.train_small
        self.URM_early_stop = splits.early_stop

        self.evaluator_validation = EvaluatorHoldout(self.URM_validation, [self.at], exclude_seen=True,
                                                     device=self.device)
        self.evaluator_earlystop = EvaluatorHoldout(self.URM_early_stop, [self.at], exclude_seen=True,
                                                    device=self.device)

        self.fit_params = {}

        # reference early-stopping parameter sets (RecSysExp.py:207-223)
        self.early_stopping_parameters = {
            "epochs_min": 0,
            "validation_every_n": 5,
            "stop_on_validation": True,
            "validation_metric": self.metric,
            "lower_validations_allowed": 5,
            "evaluator_object": self.evaluator_earlystop,
        }
        self.my_early_stopping = {
            "allow_worse": 5,
            "freq": 5,
            "validation_evaluator": self.evaluator_earlystop,
            "validation_set": None,
            "sample_every": None,
        }

    # -- bookkeeping (RecSysExp.py:225-242) -----------------------------------
    def build_fit_params(self, params):
        for i, val in enumerate(params):
            name = self.dimension_names[i]
            if name in self.fit_param_names:
                self.fit_params[name] = val
            elif name == "epochs" and self.recommender_class in EARLY_STOPPING_ALGOS:
                self.fit_params[name] = val

    def save_best_params(self, additional_params=None):
        d = dict(self.fit_params)
        if additional_params is not None:
            d.update(additional_params)
        with open(os.path.join(self.logsdir, "best_params.pkl"), "wb") as fh:
            pickle.dump(d, fh, pickle.HIGHEST_PROTOCOL)

    def load_best_params(self):
        with open(os.path.join(self.logsdir, "best_params.pkl"), "rb") as fh:
            return pickle.load(fh)

    # -- objective (RecSysExp.py:244-311) --------------------------------------
    def obj_func(self, params):
        print(
            "Optimizing", self.recommender_class.RECOMMENDER_NAME,
            self.train_mode, self.similarity_mode, "for", self.dataset_name,
        )
        self.build_fit_params(params)

        try:
            if self.isGAN:
                model = self.recommender_class(
                    self.URM_train_small, mode=self.train_mode or "user", seed=self.seed, is_experiment=True,
                    device=self.device,
                )
                fit_early_params = dict(self.fit_params)
                fit_early_params.update(self.my_early_stopping)
                last_epoch = model.fit(**fit_early_params)
                if last_epoch != self.fit_params.get("epochs"):
                    self.fit_params["epochs"] = (
                        last_epoch - self.my_early_stopping["allow_worse"] * self.my_early_stopping["freq"]
                    )
            else:
                model = self.recommender_class(self.URM_train_small, device=self.device)
                if self.recommender_class in EARLY_STOPPING_ALGOS:
                    fit_early_params = dict(self.fit_params)
                    fit_early_params.update(self.early_stopping_parameters)
                    model.fit(**fit_early_params)
                else:
                    model.fit(**self.fit_params)

            results_dic, results_run_string = self.evaluator_validation.evaluateRecommender(model)
            fitness = -results_dic[self.at][self.metric]
        except Exception as err:  # the reference's OOM guard (RecSysExp.py:290-291)
            if not is_resource_exhausted(err):
                raise
            print(f"[tune] out of device memory, the trial scores 0: {err}")
            return 0

        if not hasattr(self, "best_res") or fitness < self.best_res:
            self.best_res = fitness
            extra = None
            if self.recommender_class in EARLY_STOPPING_ALGOS:
                extra = model.get_early_stopping_final_epochs_dict()
            self.save_best_params(additional_params=extra)

        with open(os.path.join(self.logsdir, "results.txt"), "a") as fh:
            d = dict(self.fit_params)
            if self.recommender_class in EARLY_STOPPING_ALGOS:
                d.update(model.get_early_stopping_final_epochs_dict())
            fh.write(json.dumps(d, default=str))
            fh.write("\n")
            fh.write(results_run_string)
            fh.write("\n\n")

        return fitness

    # -- search driver (RecSysExp.py:313-412) ----------------------------------
    def tune(self, params, evals: int = 10, seed: Optional[int] = None):
        notify(
            "Started " + self.recommender_class.RECOMMENDER_NAME
            + self.train_mode + self.similarity_mode + " " + self.dataset_name
        )

        U, I = self.URM_test.shape

        if self.recommender_class is GANMF:
            params.append(Integer(4, int(I * 0.75) if I <= 1024 else 1024, name="emb_dim"))
            self.fit_param_names.append("emb_dim")
        if self.recommender_class is DisGANMF:
            params.append(Integer(4, int(I * 0.75) if I <= 1024 else 1024, name="d_nodes"))
            self.fit_param_names.append("d_nodes")

        self.dimension_names = [p.name for p in params]

        try:
            idx = self.dimension_names.index("num_factors")
            if not isinstance(params[idx], Categorical):
                if params[idx].bounds[1] > min(U, I):
                    params[idx] = Integer(1, min(U, I), name="num_factors")
        except ValueError:
            pass

        if len(params) > 0:
            checkpoint_path = os.path.join(self.logsdir, "checkpoint.pkl")
            checkpoint_saver = CheckpointSaver(checkpoint_path)
            seed = self.seed if seed is None else seed
            minimize = gp_minimize if self.method == "bayesian" else dummy_minimize

            t_start = int(time.time())
            if os.path.exists(checkpoint_path):
                previous = load(checkpoint_path)
                results = minimize(
                    self.obj_func, params, n_calls=max(0, evals - len(previous.func_vals)),
                    x0=previous.x_iters, y0=previous.func_vals, n_random_starts=0,
                    random_state=seed, verbose=True, callback=[checkpoint_saver],
                ) if self.method == "bayesian" else minimize(
                    self.obj_func, params, n_calls=max(0, evals - len(previous.func_vals)),
                    x0=previous.x_iters, y0=previous.func_vals,
                    random_state=seed, verbose=True, callback=[checkpoint_saver],
                )
            else:
                results = minimize(
                    self.obj_func, params, n_calls=evals, random_state=seed,
                    verbose=True, callback=[checkpoint_saver],
                )
            t_end = int(time.time())

            best_params = self.load_best_params()
            with open(os.path.join(self.logsdir, "results.txt"), "a") as fh:
                fh.write(f"Experiment ran for {t_end - t_start} seconds\n")
                fh.write(f"Best {self.metric} score: {results.fun}. Best result found at: {best_params}\n")

        bp_path = os.path.join(self.logsdir, "best_params.pkl")
        if not os.path.exists(bp_path):
            # parameterless algorithms (TopPop): record an empty config
            self.save_best_params()
        with open(bp_path, "rb") as fh:
            d = pickle.load(fh)
        with open(os.path.join(self.logsdir, "best_params.txt"), "w") as fh:
            fh.write(json.dumps(d, default=str))

        notify(
            "Finished " + self.recommender_class.RECOMMENDER_NAME
            + self.train_mode + self.similarity_mode + " " + self.dataset_name
        )


USAGE = (
    "usage: ganmf-torch-exp [--build-dataset] <dataset> <rec> [--user|--item]"
    " [<similarity>] [--evals N]\n"
    "  datasets:     " + " ".join(sorted(ALL_DATASETS)) + "\n"
    "  recommenders: " + " ".join(sorted(ALL_RECOMMENDERS))
    + " (ported: " + " ".join(sorted(DICT_REC_CLASSES)) + ")\n"
    "  similarities: " + " ".join(sorted(SIMILARITIES))
)


def main(arguments: List[str]):
    # 50 evals like the reference (RecSysExp.py:417); --evals N overrides
    EVALS = 50
    algo = None
    sim = None
    dataset = None
    build_dataset = False
    train_mode = ""
    similarity_mode = ""

    arguments = list(arguments)
    if not arguments or "--help" in arguments or "-h" in arguments:
        print(USAGE)
        return
    if "--evals" in arguments:
        i = arguments.index("--evals")
        EVALS = int(arguments[i + 1])
        del arguments[i : i + 2]

    for arg in arguments:
        if arg == "--build-dataset":
            # keep scanning: the dataset name may follow the flag
            build_dataset = True
            continue
        if arg in ALL_RECOMMENDERS and algo is None:
            algo = arg
        if arg in SIMILARITIES and sim is None:
            sim = arg
            similarity_mode = sim
        if arg in ALL_DATASETS and dataset is None:
            dataset = arg
        if arg in ["--user", "--item"] and train_mode == "":
            train_mode = arg[2:]

    if build_dataset:
        print(f"Building {dataset}. Skipping other arguments!")
        load_urms(dataset)
        return

    if algo is None or dataset is None:
        raise SystemExit(
            f"unrecognized or missing <dataset>/<rec> in {arguments!r}\n{USAGE}"
        )
    dims = list(DICT_DIMENSIONS[algo])
    if algo in SIMILARITY_ALGOS:
        if sim is None:
            raise ValueError(f"{algo} selected but no similarity specified!")
        dims.append(Categorical([sim], name="similarity"))
        dims.extend(similarity_extra_dimensions(sim))

    exp = RecSysExp(
        rec_class(algo),
        dataset=dataset,
        fit_param_names=[d.name for d in dims],
        method="bayesian",
        seed=SEED,
        train_mode=train_mode,
        similarity_mode=similarity_mode,
    )
    exp.tune(dims, evals=EVALS)


if __name__ == "__main__":
    main(sys.argv[1:])
