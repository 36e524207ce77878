"""What the experiment harness shares with ``run_best``.

Port of ganmf_tpu/cli/experiment.py:52-117: the seed, the dataset and
recommender names the command lines accept, the model classes, and
``load_urms``, which loads the five committed splits of a dataset or builds
and saves them from its raw data. ``DICT_REC_CLASSES`` holds the models ported
so far; ``rec_class`` names any other as not ported. The hyperparameter search
(``RecSysExp`` and the GP tuner) is not ported yet.
"""

from __future__ import annotations

import os

from ganmf_tpu_torch.data.splits import SplitSet, load_reference_splits, make_experiment_splits, save_experiment_splits
from ganmf_tpu_torch.models import CAAE, CFGAN, GANMF, DisGANMF, PureSVDRecommender
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

DICT_REC_CLASSES = {
    "PureSVD": PureSVDRecommender,
    "CFGAN": CFGAN,
    "CAAE": CAAE,
    "GANMF": GANMF,
    "DisGANMF": DisGANMF,
}


def rec_class(algo: str):
    """The model class for a recommender name of ``ALL_RECOMMENDERS``."""
    if algo not in DICT_REC_CLASSES:
        raise NotImplementedError(
            f"{algo} is not ported to ganmf_tpu_torch yet (ported: {', '.join(sorted(DICT_REC_CLASSES))})")
    return DICT_REC_CLASSES[algo]


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
