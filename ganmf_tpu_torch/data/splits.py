"""Experiment split management.

A copy of ganmf_tpu/data/splits.py, which uses no framework; the port's
search path holds only the checkout's experiments/datasets (and
$GANMF_TPU_SPLIT_DIR).

The reference pins all published numbers to five committed split matrices per
dataset (``experiments/datasets/<DS>_URM_{train,test,validation,train_small,
early_stop}.npz`` — reference: RecSysExp.py:68,129-163). This module loads
those artifacts when available (bit-exact eval-set parity) and can rebuild
the same five-way split from a raw URM with the reference's construction:

    train/test       <- split(full, [0.8, 0.2, 0])        (dataset config)
    train_small_parent/validation <- split(train, [0.75, 0, 0.25])
    train_small/early_stop        <- split(parent, [0.85, 0, 0.15])
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sps

from ganmf_tpu_torch.data.reader import split_urm
from ganmf_tpu_torch.utils.seeding import GLOBAL_SEED, set_seed

URM_SUFFIXES = (
    "_URM_train.npz",
    "_URM_test.npz",
    "_URM_validation.npz",
    "_URM_train_small.npz",
    "_URM_early_stop.npz",
)

#: canonical dataset names used in the committed artifacts
DATASET_FILE_PREFIX = {
    "1M": "Movielens1M",
    "hetrec2011": "Movielenshetrec2011",
    "LastFM": "LastFM",
}

_DEFAULT_SPLIT_DIRS = (os.path.join("experiments", "datasets"),)


@dataclass
class SplitSet:
    """The five URMs every experiment runs on."""

    train: sps.csr_matrix
    test: sps.csr_matrix
    validation: sps.csr_matrix
    train_small: sps.csr_matrix
    early_stop: sps.csr_matrix

    def __iter__(self):
        yield from (self.train, self.test, self.validation, self.train_small, self.early_stop)


def find_split_dir(dataset: str, search_dirs=None) -> Optional[str]:
    """Locate a directory containing all five split files for ``dataset``."""
    prefix = DATASET_FILE_PREFIX.get(dataset, dataset)
    dirs = list(search_dirs or ())
    env = os.environ.get("GANMF_TPU_SPLIT_DIR")
    if env:
        dirs.insert(0, env)
    dirs.extend(_DEFAULT_SPLIT_DIRS)
    for d in dirs:
        if all(os.path.isfile(os.path.join(d, prefix + s)) for s in URM_SUFFIXES):
            return d
    return None


def load_reference_splits(dataset: str, split_dir: Optional[str] = None) -> SplitSet:
    """Load the committed five-way split for a dataset.

    ``dataset`` is one of '1M', 'hetrec2011', 'LastFM' (or a raw file
    prefix). Looks in $GANMF_TPU_SPLIT_DIR, then ./experiments/datasets.
    """
    d = split_dir or find_split_dir(dataset)
    if d is None:
        raise FileNotFoundError(
            f"No split artifacts found for dataset '{dataset}'. Set "
            "GANMF_TPU_SPLIT_DIR or build them with make_experiment_splits()."
        )
    prefix = DATASET_FILE_PREFIX.get(dataset, dataset)
    mats = [sps.load_npz(os.path.join(d, prefix + s)).tocsr() for s in URM_SUFFIXES]
    return SplitSet(*mats)


def make_experiment_splits(
    urm_full: sps.spmatrix,
    split_ratio=(0.8, 0.2, 0),
    implicit: bool = True,
    min_ratings_user: int = 2,
    seed: int = GLOBAL_SEED,
) -> SplitSet:
    """Construct the five-way experiment split from a raw URM.

    Reproduces the reference construction order and RNG usage
    (RecSysExp.make_dataset, RecSysExp.py:129-150): the global numpy RNG is
    seeded once, then three sequential split passes consume it.
    """
    set_seed(seed)
    train, test, _ = split_urm(
        urm_full, split_ratio=split_ratio, implicit=implicit, min_ratings_user=min_ratings_user
    )
    parent, _, validation = split_urm(
        train.tocoo(), split_ratio=(0.75, 0, 0.25), min_ratings_user=1
    )
    train_small, _, early_stop = split_urm(
        parent.tocoo(), split_ratio=(0.85, 0, 0.15), min_ratings_user=1
    )
    return SplitSet(train.tocsr(), test.tocsr(), validation.tocsr(), train_small.tocsr(), early_stop.tocsr())


def save_experiment_splits(splits: SplitSet, dataset: str, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    prefix = DATASET_FILE_PREFIX.get(dataset, dataset)
    for suffix, mat in zip(URM_SUFFIXES, splits):
        sps.save_npz(os.path.join(out_dir, prefix + suffix), mat.tocsr(), compressed=True)
