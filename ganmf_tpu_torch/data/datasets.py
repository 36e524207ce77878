"""Built-in dataset definitions (Movielens family, LastFM-hetrec2011).

A copy of ganmf_tpu/data/datasets.py without the Kaggle fetch; it uses no
framework.

Mirrors the reference dataset catalog (datasets/Movielens.py:25-57,
datasets/LastFM.py:21-38): download URLs, archive layout, parse settings.
Downloading is attempted with urllib when the environment has network
access; in air-gapped environments point ``data_dir`` (or $GANMF_TPU_DATA)
at pre-downloaded files, or rely on the committed split artifacts
(ganmf_tpu_torch.data.splits) which make raw data unnecessary for parity runs.
"""

from __future__ import annotations

import os
import zipfile
from dataclasses import dataclass, replace
from typing import Dict, Optional

from ganmf_tpu_torch.data.reader import DatasetConfig, InteractionReader


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    url: str
    archive_member: str  # path of the ratings file inside the zip
    delimiter: str
    header: bool = False
    use_cols: Optional[Dict[str, int]] = None


MOVIELENS_SPECS = {
    "100K": DatasetSpec("Movielens100K", "http://files.grouplens.org/datasets/movielens/ml-100k.zip", "ml-100k/u.data", "\t"),
    "1M": DatasetSpec("Movielens1M", "http://files.grouplens.org/datasets/movielens/ml-1m.zip", "ml-1m/ratings.dat", "::"),
    "10M": DatasetSpec("Movielens10M", "http://files.grouplens.org/datasets/movielens/ml-10m.zip", "ml-10M100K/ratings.dat", "::"),
    "20M": DatasetSpec("Movielens20M", "http://files.grouplens.org/datasets/movielens/ml-20m.zip", "ml-20m/ratings.csv", ",", True),
    "small": DatasetSpec("Movielenssmall", "http://files.grouplens.org/datasets/movielens/ml-latest-small.zip", "ml-latest-small/ratings.csv", ",", True),
    "latest": DatasetSpec("Movielenslatest", "http://files.grouplens.org/datasets/movielens/ml-latest.zip", "ml-latest/ratings.csv", ",", True),
    "hetrec2011": DatasetSpec(
        "Movielenshetrec2011",
        "http://files.grouplens.org/datasets/hetrec2011/hetrec2011-movielens-2k-v2.zip",
        "user_ratedmovies-timestamps.dat",
        "\t",
        True,
    ),
}

LASTFM_SPEC = DatasetSpec(
    "LastFM",
    "http://files.grouplens.org/datasets/hetrec2011/hetrec2011-lastfm-2k.zip",
    "user_artists.dat",
    "\t",
    True,
)


def _data_dir(override: Optional[str]) -> str:
    return override or os.environ.get("GANMF_TPU_DATA", os.path.join("datasets", "all_datasets"))


def _fetch(spec: DatasetSpec, data_dir: str, verbose: bool = False) -> str:
    """Return the local path of the ratings file, downloading if needed."""
    os.makedirs(data_dir, exist_ok=True)
    target = os.path.join(data_dir, spec.name, os.path.basename(spec.archive_member))
    if os.path.isfile(target):
        return target
    # also accept the archive's internal layout dropped directly in data_dir
    alt = os.path.join(data_dir, spec.archive_member)
    if os.path.isfile(alt):
        return alt

    import urllib.request

    zip_path = os.path.join(data_dir, os.path.basename(spec.url))
    if not os.path.isfile(zip_path):
        if verbose:
            print(f"Downloading {spec.url} ...")
        urllib.request.urlretrieve(spec.url, zip_path)  # raises in air-gapped envs
    with zipfile.ZipFile(zip_path) as zf:
        extracted = zf.extract(spec.archive_member, os.path.join(data_dir, spec.name))
    os.makedirs(os.path.dirname(target), exist_ok=True)
    if os.path.abspath(extracted) != os.path.abspath(target):
        os.replace(extracted, target)
    return target


def _reader_for(spec: DatasetSpec, data_dir: Optional[str] = None, **config_overrides) -> InteractionReader:
    cfg = DatasetConfig(
        delimiter=spec.delimiter,
        header=spec.header,
        use_cols=spec.use_cols or {"user_id": 0, "item_id": 1, "rating": 2},
    )
    known = {k: v for k, v in config_overrides.items() if hasattr(cfg, k)}
    cfg = replace(cfg, **known)
    base = _data_dir(data_dir)
    path = _fetch(spec, base, verbose=config_overrides.get("verbose", False))
    reader = InteractionReader(path, cache_dir=os.path.join(base, spec.name, "cache"), config=cfg)
    reader.DATASET_NAME = spec.name
    return reader


def Movielens(version: str = "10M", data_dir: Optional[str] = None, **config) -> InteractionReader:
    if version not in MOVIELENS_SPECS:
        raise KeyError(
            f"{version} is not supported. Accepted Movielens versions: {', '.join(MOVIELENS_SPECS)}"
        )
    return _reader_for(MOVIELENS_SPECS[version], data_dir, **config).process()


def LastFM(data_dir: Optional[str] = None, **config) -> InteractionReader:
    return _reader_for(LASTFM_SPEC, data_dir, **config).process()
