"""Interaction-data ingestion and per-user holdout splitting.

A copy of the parts of ganmf_tpu/data/reader.py that ``split_urm`` and the
dataset builders need, which use no framework: streaming interaction parsing
with dedup (reference datasets/DataReader.py:275-379, the Python parser
only), dense user/item reindexing (:386-480), iterative k-core filtering and
the per-user multinomial train/test/validation assignment (:482-633), and the
config-compared process cache (:700-792), and the item-feature (ICM)
readers that feed ItemKNNCBFRecommender. The splitter reproduces the
reference's numpy RNG call sequence exactly. Not copied: the native parser
and the k-fold generator.
"""

from __future__ import annotations

import math
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sps


def _dedup(rows, cols, data, keep="first"):
    """Keep first/last occurrence of duplicate (user, item) pairs.

    Vectorized with the exact semantics of the reference's dict pass
    (datasets/DataReader.py:275-379): output order is first-occurrence
    order, and keep='last' keeps the LAST duplicate's value at the FIRST
    occurrence's position (dict insertion-order semantics)."""
    if len(rows) == 0:
        return rows, cols, data
    key = rows.astype(np.int64) * (np.int64(cols.max()) + 1) + cols
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    first_idx = order[starts]  # stable sort: first position in each group
    if keep == "first":
        sel = first_idx
    else:
        ends = np.r_[starts[1:], len(ks)] - 1
        sel = order[ends]  # stable sort: last position in each group
    keep_idx = sel[np.argsort(first_idx, kind="stable")]
    return rows[keep_idx], cols[keep_idx], data[keep_idx]


def read_interactions(
    path: str,
    use_cols: Dict[str, int] = None,
    delimiter: str = ",",
    header: bool = False,
    duplicate: str = "first",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a ratings file into (user, item, rating) arrays.

    Mirrors reference DataReader.read_interactions (datasets/DataReader.py:275)
    including duplicate handling ('first'/'last'). The JAX package's native
    parser (ganmf_tpu/ops/host.py) is not copied: this is its Python path.
    """
    use_cols = use_cols or {"user_id": 0, "item_id": 1, "rating": 2}
    u_col, i_col = use_cols["user_id"], use_cols["item_id"]
    r_col = use_cols.get("rating", None)

    rows: List[int] = []
    cols: List[int] = []
    data: List[float] = []
    with open(path, "r", errors="replace") as fh:
        first = True
        for line in fh:
            if first and header:
                first = False
                continue
            first = False
            line = line.strip()
            if not line:
                continue
            parts = line.split(delimiter)
            rows.append(int(parts[u_col]))
            cols.append(int(parts[i_col]))
            data.append(float(parts[r_col]) if r_col is not None and r_col < len(parts) else 1.0)

    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    data = np.asarray(data, dtype=np.float32)
    return _dedup(rows, cols, data, keep=duplicate)


def read_item_features(
    path: str,
    item_col: int = 0,
    feature_col: int = 2,
    delimiter: str = "::",
    feature_sep: str = "|",
    header: bool = False,
) -> Tuple[np.ndarray, List[str]]:
    """Parse an item-metadata file into (item_id, feature_token) pairs.

    Covers movies.dat-style files (``MovieID::Title::Genres`` with
    ``|``-separated genre tokens). The reference has no ICM ingestion at
    root — this is the minimal path that feeds ItemKNNCBFRecommender
    (reference KNN/ItemKNNCBFRecommender.py:24-27 takes a prebuilt ICM).
    Returns parallel arrays of raw item ids and feature token strings.
    """
    item_ids: List[int] = []
    tokens: List[str] = []
    with open(path, "r", errors="replace") as fh:
        first = True
        for line in fh:
            if first and header:
                first = False
                continue
            first = False
            line = line.strip()
            if not line:
                continue
            parts = line.split(delimiter)
            if len(parts) <= max(item_col, feature_col):
                continue
            iid = int(parts[item_col])
            for tok in parts[feature_col].split(feature_sep):
                tok = tok.strip()
                if tok:
                    item_ids.append(iid)
                    tokens.append(tok)
    return np.asarray(item_ids, dtype=np.int64), tokens


def build_icm(
    item_ids: np.ndarray,
    feature_tokens: List[str],
    col_to_item: Dict[int, int],
    n_items: Optional[int] = None,
) -> Tuple[sps.csr_matrix, Dict[str, int]]:
    """Build a binary ICM [n_items, n_features] aligned to the URM's item axis.

    ``col_to_item`` is the raw-item-id -> URM-column map produced by
    build_urm; items absent from it (filtered by k-core / top-pop removal)
    are dropped. Features are indexed in sorted-token order for
    determinism. Returns (ICM csr, feature_token -> column map).
    """
    n_items = n_items if n_items is not None else len(col_to_item)
    feat_names = sorted(set(feature_tokens))
    feat_to_col = {f: c for c, f in enumerate(feat_names)}

    rows: List[int] = []
    cols: List[int] = []
    for iid, tok in zip(item_ids, feature_tokens):
        col = col_to_item.get(int(iid))
        if col is not None:
            rows.append(col)
            cols.append(feat_to_col[tok])
    icm = sps.csr_matrix(
        (np.ones(len(rows), dtype=np.float32), (rows, cols)),
        shape=(n_items, len(feat_names)),
    )
    icm.sum_duplicates()
    icm.data[:] = np.minimum(icm.data, 1.0)
    return icm, feat_to_col


def build_urm(
    rows: np.ndarray,
    cols: np.ndarray,
    data: np.ndarray,
    remove_top_pop: float = 0.0,
) -> Tuple[sps.coo_matrix, Dict[int, int], Dict[int, int]]:
    """Reindex raw ids to dense [0, n) ids and build the COO URM.

    Mirrors reference DataReader.build_URM (datasets/DataReader.py:386-480),
    including the optional removal of the top fraction of popular items.
    Returns (URM, user_id->row, item_id->col).
    """
    unique_items, item_counts = np.unique(cols, return_counts=True)

    if remove_top_pop > 0.0:
        k = int(np.floor(len(unique_items) * remove_top_pop))
        keep_items = unique_items[np.argsort(item_counts)[::-1]][k:]
        mask = np.isin(cols, keep_items)
        rows, cols, data = rows[mask], cols[mask], data[mask]
        unique_items = keep_items

    unique_users = np.unique(rows)
    row_to_user = {u: r for r, u in enumerate(unique_users)}
    col_to_item = {i: c for c, i in enumerate(np.sort(unique_items))}

    coo_rows = np.array([row_to_user[u] for u in rows], dtype=np.int64)
    coo_cols = np.array([col_to_item[i] for i in cols], dtype=np.int64)

    urm = sps.coo_matrix(
        (data, (coo_rows, coo_cols)),
        shape=(len(unique_users), len(unique_items)),
        dtype=np.float32,
    )
    return urm, row_to_user, col_to_item


def _remove_coldstart_items(urm_csr: sps.csr_matrix) -> sps.csr_matrix:
    """Drop all-zero item columns (reference DataReader.py:381-384)."""
    csc = urm_csr.tocsc()
    mask = np.asarray(csc.sum(axis=0)).ravel() > 0
    return csc[:, mask].tocsr()


def kcore_filter(
    urm: sps.csr_matrix, min_ratings_user: int = 2, min_ratings_item: int = 1
) -> sps.csr_matrix:
    """Iterative dense-core filter (reference DataReader.py:539-567).

    Repeatedly removes users with < min_ratings_user interactions (then cold
    items) and items with < min_ratings_item interactions until stable.
    """
    urm = urm.tocsr()
    if min_ratings_user + min_ratings_item <= 2:
        return urm
    done = False
    while not done:
        if min_ratings_user >= 2:
            user_mask = np.ediff1d(urm.indptr) >= min_ratings_user
            urm = urm[user_mask]
            urm = _remove_coldstart_items(urm)
        if min_ratings_item >= 2:
            urm_t = urm.T.tocsr()
            item_mask = np.ediff1d(urm_t.indptr) >= min_ratings_item
            urm_t = urm_t[item_mask]
            urm_t = _remove_coldstart_items(urm_t)
            urm = urm_t.T.tocsr()
        bad_users = (np.ediff1d(urm.indptr) < min_ratings_user).sum()
        bad_items = (np.ediff1d(urm.T.tocsr().indptr) < min_ratings_item).sum()
        done = bad_users + bad_items == 0
    return urm


def split_urm(
    urm: sps.spmatrix,
    split_ratio=(0.6, 0.2, 0.2),
    implicit: bool = False,
    min_ratings_user: int = 2,
    min_ratings_item: int = 1,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[sps.csr_matrix, sps.csr_matrix, sps.csr_matrix]:
    """Per-user multinomial train/test/validation split.

    Reproduces the reference splitter semantics and RNG call sequence
    (datasets/DataReader.py:482-633) exactly:

    * interactions optionally binarized (implicit),
    * iterative k-core filtering,
    * per-user draws: 1 interaction -> train; 2 interactions -> coin flip
      between train and (test or validation); otherwise a multinomial draw
      with a deterministic re-draw fallback guaranteeing non-empty splits.

    ``rng`` defaults to the *global* numpy RNG, matching the reference which
    relies on ``np.random.seed`` being set by the caller.
    """
    rand = rng if rng is not None else np.random

    urm = urm.tocoo(copy=True)
    if implicit:
        urm.data = np.ones(len(urm.data), dtype=np.float32)

    urm_csr = sps.csr_matrix(urm)
    urm_csr = kcore_filter(urm_csr, min_ratings_user, min_ratings_item)
    urm_csr.eliminate_zeros()

    choice: List[str] = []
    for u in range(urm_csr.shape[0]):
        n = urm_csr.indptr[u + 1] - urm_csr.indptr[u]
        if n == 1:
            choice.append("train")
        elif n == 2:
            # Reference flips between train and the non-empty second split.
            if split_ratio[1] == 0:
                first = ["train", "validation"][rand.randint(2)]
                second = "train" if first == "validation" else "validation"
            else:
                first = ["train", "test"][rand.randint(2)]
                second = "train" if first == "test" else "test"
            choice.extend([first, second])
        else:
            selection = rand.choice(["train", "test", "valid"], p=split_ratio, size=n)
            degenerate = (
                (selection == "train").sum() == 0
                or (split_ratio[1] != 0 and (selection == "test").sum() == 0)
                or (split_ratio[2] != 0 and (selection == "validation").sum() == 0)
            )
            if degenerate:
                # Deterministic-count fallback, same draws as the reference.
                no_trains = int(n * split_ratio[0])
                no_tests = math.ceil(n * split_ratio[1])
                selection = np.array(["train"] * n)
                possibilities = np.arange(n)
                select_trains = rand.choice(possibilities, size=no_trains, replace=False)
                remaining = list(set(possibilities).difference(set(select_trains)))
                select_tests = rand.choice(remaining, size=no_tests, replace=False)
                select_validation = list(set(remaining).difference(set(select_tests)))
                selection[select_tests] = "test"
                selection[select_validation] = "validation"
            choice.extend(selection.tolist())

    coo = sps.coo_matrix(urm_csr)
    choice_arr = np.array(choice)
    shape = coo.shape

    def _pick(label):
        m = choice_arr == label
        return sps.coo_matrix(
            (coo.data[m], (coo.row[m], coo.col[m])), shape=shape, dtype=np.float32
        ).tocsr()

    # Note: the reference labels the multinomial bucket 'valid' but the
    # fallback bucket 'validation'; both land in the third split only if
    # named 'valid' at extraction time. We faithfully extract 'train',
    # 'test' and 'valid' — entries labeled 'validation' are dropped exactly
    # as in the reference (DataReader.py:617-619).
    return _pick("train"), _pick("test"), _pick("valid")


@dataclass
class DatasetConfig:
    """Typed dataset-processing config; hash-compared to decide rebuilds
    (reference: datasets/DataReader.py:71-84, 717-735)."""

    use_local: bool = True
    force_rebuild: bool = False
    implicit: bool = True
    save_local: bool = False
    verbose: bool = False
    split: bool = True
    split_ratio: Tuple[float, float, float] = (0.8, 0.2, 0)
    min_ratings_user: int = 2
    min_ratings_item: int = 1
    use_cols: Dict[str, int] = field(
        default_factory=lambda: {"user_id": 0, "item_id": 1, "rating": 2}
    )
    delimiter: str = ","
    header: bool = False
    duplicate: str = "first"
    remove_top_pop: float = 0.0
    sample: float = 1.0

    def as_dict(self):
        return dict(self.__dict__)


class InteractionReader:
    """End-to-end dataset pipeline: parse -> reindex -> split, with a
    config-compared on-disk cache (the reference's ``process`` state machine,
    datasets/DataReader.py:700-792)."""

    DATASET_NAME = "generic"

    def __init__(self, ratings_file: str, cache_dir: Optional[str] = None, config: Optional[DatasetConfig] = None):
        self.ratings_file = ratings_file
        self.cache_dir = cache_dir
        self.config = config or DatasetConfig()
        self.urm = None
        self.urm_train = self.urm_test = self.urm_validation = None

    # -- cache handling -----------------------------------------------------
    def _cache_paths(self):
        d = self.cache_dir
        return {
            "config": os.path.join(d, "config.pkl"),
            "train": os.path.join(d, "URM_train.npz"),
            "test": os.path.join(d, "URM_test.npz"),
            "validation": os.path.join(d, "URM_validation.npz"),
        }

    def _cache_valid(self) -> bool:
        if self.cache_dir is None or self.config.force_rebuild:
            return False
        paths = self._cache_paths()
        if not all(os.path.isfile(p) for p in paths.values()):
            return False
        with open(paths["config"], "rb") as fh:
            cached = pickle.load(fh)
        return cached == self.config.as_dict()

    def process(self):
        """Build (or load from cache) the train/test/validation splits."""
        if self._cache_valid():
            paths = self._cache_paths()
            self.urm_train = sps.load_npz(paths["train"])
            self.urm_test = sps.load_npz(paths["test"])
            self.urm_validation = sps.load_npz(paths["validation"])
            return self

        cfg = self.config
        rows, cols, data = read_interactions(
            self.ratings_file,
            use_cols=cfg.use_cols,
            delimiter=cfg.delimiter,
            header=cfg.header,
            duplicate=cfg.duplicate,
        )
        self.urm, self.row_to_user, self.col_to_item = build_urm(
            rows, cols, data, remove_top_pop=cfg.remove_top_pop
        )

        if cfg.sample != 1.0:
            # user-wise random sampling with cold-item removal
            # (reference DataReader.py:464-467)
            n_keep = int(self.urm.shape[0] * cfg.sample)
            keep_rows = np.random.randint(0, self.urm.shape[0], size=n_keep)
            self.urm = _remove_coldstart_items(self.urm.tocsr()[keep_rows]).tocoo()

        if cfg.split:
            self.urm_train, self.urm_test, self.urm_validation = split_urm(
                self.urm,
                split_ratio=cfg.split_ratio,
                implicit=cfg.implicit,
                min_ratings_user=cfg.min_ratings_user,
                min_ratings_item=cfg.min_ratings_item,
            )

        if self.cache_dir is not None and cfg.save_local:
            os.makedirs(self.cache_dir, exist_ok=True)
            paths = self._cache_paths()
            sps.save_npz(paths["train"], self.urm_train, compressed=True)
            sps.save_npz(paths["test"], self.urm_test, compressed=True)
            sps.save_npz(paths["validation"], self.urm_validation, compressed=True)
            with open(paths["config"], "wb") as fh:
                pickle.dump(cfg.as_dict(), fh)
        return self

    # -- accessors (reference DataReader.py:673-698) ------------------------
    def get_URM_train(self):
        return self.urm_train

    def get_URM_test(self):
        return self.urm_test

    def get_URM_validation(self):
        return self.urm_validation
