"""The ML-20M stand-in: a seeded ratings.csv of ML-20M's shape, without pandas.

A copy of scripts/synthesize_ml20m.py's ``synthesize`` (same seed, same
constants, same ``np.random.RandomState`` call order), whose rows are written
by vectorized numpy formatting in place of pandas' ``to_csv``: the machine
with the card has no pandas. The file is byte for byte the one
``DataFrame.to_csv(index=False)`` writes: the header
``userId,movieId,rating,timestamp``, 1-based ids, the half-star ratings as
``3.5`` / ``4.0`` and integer timestamps, one ``\\n``-terminated line a row.

The stand-in has the real dataset's published marginals: 138,493 users x
26,744 movies and about 20.0M ratings, Zipf item popularity over a shuffled
order, 64 taste clusters over a disjoint partition of the catalog (a user's
cluster boosts its ~418-item slice 60x), log-normal user activity clipped to
[20, 1600], and ratings in {0.5, ..., 5.0} skewed toward 3.5-4.5. It lands
where ``Movielens("20M")`` looks before it would download:
``<data_dir>/ml-20m/ratings.csv``.

``synthetic_urm`` is the uniform 0/1 URM of scripts/beyond_hbm_demo.py:30-40
(``per_user`` uniform item draws a user, duplicates merged), copied with its
``RandomState`` call order. ``ml1m_shaped_split`` and ``lastfm_shaped_split``
are the 0/1 train/test splits of bench.py:49-66's form (numpy seed 0, a
Bernoulli matrix at the dataset's density, 80/20) that stand in for the
reference splits, which are absent from the repository.
"""

from __future__ import annotations

import os
import time

import numpy as np
import scipy.sparse as sps

N_USERS = 138_493
N_ITEMS = 26_744
TARGET_NNZ = 20_000_263
MIN_PER_USER = 20
MAX_PER_USER = 1_600
SEED = 20_000_263
N_CLUSTERS = 64
HEADER = b"userId,movieId,rating,timestamp\n"


def ratings_path(data_dir: str) -> str:
    """Where ``Movielens("20M", data_dir=data_dir)`` finds the stand-in."""
    return os.path.join(data_dir, "ml-20m", "ratings.csv")


def draw(seed: int = SEED, *, n_users: int = N_USERS, n_items: int = N_ITEMS, target_nnz: int = TARGET_NNZ,
         min_per_user: int = MIN_PER_USER, max_per_user: int = MAX_PER_USER, log=None):
    """(users, items, ratings, timestamps) of the stand-in, 0-based ids
    grouped by user (scripts/synthesize_ml20m.py:54-109)."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)

    # user activity: log-normal, clipped, scaled to the target total
    acts = rng.lognormal(mean=4.0, sigma=1.0, size=n_users)
    acts = np.clip(acts, min_per_user, max_per_user)
    acts = np.maximum((acts * (target_nnz / acts.sum())).astype(np.int64), min_per_user)
    acts = np.minimum(acts, max_per_user)

    # item popularity: Zipf over a shuffled item order
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    pop = ranks ** -0.9
    rng.shuffle(pop)
    pop /= pop.sum()

    # taste clusters: cluster c boosts its own slice of a disjoint item
    # partition 60x
    cluster_of = rng.randint(0, N_CLUSTERS, size=n_users).astype(np.int32)
    item_cluster = rng.randint(0, N_CLUSTERS, size=n_items).astype(np.int32)

    # oversample each user's draws from its cluster's distribution, drop
    # within-user duplicates, then trim each user to its nominal count
    over_counts = np.minimum((acts * 1.7).astype(np.int64), max_per_user + 900)
    users = np.repeat(np.arange(n_users, dtype=np.int32), over_counts)
    items = np.empty(len(users), dtype=np.int32)
    user_cluster = cluster_of[users]
    for c in range(N_CLUSTERS):
        p_c = pop * np.where(item_cluster == c, 60.0, 1.0)
        p_c /= p_c.sum()
        sel = np.nonzero(user_cluster == c)[0]
        cdf = np.cumsum(p_c)
        cdf[-1] = 1.0
        items[sel] = np.searchsorted(cdf, rng.rand(len(sel))).astype(np.int32)

    keys = users.astype(np.int64) * n_items + items
    _, first_idx = np.unique(keys, return_index=True)  # the first occurrence of each pair
    first_idx.sort()
    users, items = users[first_idx], items[first_idx]

    counts = np.bincount(users, minlength=n_users)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_in_user = np.arange(len(users)) - np.repeat(starts, counts)
    keep = pos_in_user < acts[users]
    users, items = users[keep], items[keep]

    levels = np.arange(0.5, 5.01, 0.5)
    probs = np.array([0.01, 0.02, 0.03, 0.05, 0.09, 0.13, 0.21, 0.20, 0.16, 0.10])
    probs /= probs.sum()
    ratings = levels[rng.choice(len(levels), size=len(users), p=probs)]
    timestamps = rng.randint(789_652_009, 1_427_784_002, size=len(users))
    if log is not None:
        log(f"{len(users):,} pairs after dedup+trim ({time.perf_counter() - t0:.1f} s)")
    return users, items, ratings, timestamps


def _digits(x: np.ndarray) -> np.ndarray:
    """Decimal digits of each non-negative integer (1 for 0)."""
    return np.searchsorted(10 ** np.arange(1, 19, dtype=np.int64), x, side="right") + 1


def _put_ints(buf: np.ndarray, at: np.ndarray, x: np.ndarray, nd: np.ndarray) -> None:
    """Write each x[r] in decimal at buf[at[r]:at[r] + nd[r]]."""
    rest = x.astype(np.int64)
    for j in range(int(nd.max()) if len(nd) else 0):  # j-th digit from the right
        live = nd > j
        buf[at[live] + nd[live] - 1 - j] = 48 + rest[live] % 10
        rest = rest // 10


def _put_table(buf: np.ndarray, at: np.ndarray, idx: np.ndarray, table: np.ndarray, lens: np.ndarray) -> None:
    """Write table row idx[r] (its first lens[idx[r]] bytes) at buf[at[r]:]."""
    for j in range(table.shape[1]):
        live = lens[idx] > j
        buf[at[live] + j] = table[idx[live], j]


def csv_bytes(users: np.ndarray, items: np.ndarray, ratings: np.ndarray, timestamps: np.ndarray) -> np.ndarray:
    """The rows as pandas' ``to_csv(index=False)`` writes them (without the
    header), as one uint8 array. Ids must be non-negative integers; a rating
    is written as Python's ``repr`` of its float64 value, as pandas does."""
    if np.any(users < 0) or np.any(items < 0) or np.any(timestamps < 0):
        raise ValueError("ids and timestamps must be non-negative")
    levels, level_idx = np.unique(np.asarray(ratings, dtype=np.float64), return_inverse=True)
    texts = [repr(float(v)).encode() for v in levels]
    lens = np.array([len(t) for t in texts], dtype=np.int64)
    table = np.zeros((len(texts), int(lens.max()) if len(texts) else 0), dtype=np.uint8)
    for r, t in enumerate(texts):
        table[r, : len(t)] = np.frombuffer(t, dtype=np.uint8)

    nd_u, nd_i, nd_t = _digits(users), _digits(items), _digits(timestamps)
    nd_r = lens[level_idx] if len(texts) else np.zeros(0, np.int64)
    line = nd_u + nd_i + nd_r + nd_t + 4  # three commas and the newline
    start = np.zeros(len(line), dtype=np.int64)
    np.cumsum(line[:-1], out=start[1:])
    buf = np.empty(int(line.sum()), dtype=np.uint8)
    at = start
    _put_ints(buf, at, users, nd_u)
    at = at + nd_u
    buf[at] = ord(",")
    _put_ints(buf, at + 1, items, nd_i)
    at = at + 1 + nd_i
    buf[at] = ord(",")
    _put_table(buf, at + 1, level_idx, table, lens)
    at = at + 1 + nd_r
    buf[at] = ord(",")
    _put_ints(buf, at + 1, timestamps, nd_t)
    buf[at + 1 + nd_t] = ord("\n")
    return buf


def synthesize(path: str, seed: int = SEED, verbose: bool = True, *, n_users: int = N_USERS,
               n_items: int = N_ITEMS, target_nnz: int = TARGET_NNZ, min_per_user: int = MIN_PER_USER,
               max_per_user: int = MAX_PER_USER) -> str:
    """Write the stand-in's ratings.csv at ``path`` (kept if already there),
    through a temporary file and ``os.replace``. Returns ``path``."""
    log = print if verbose else None
    if os.path.isfile(path):
        if log:
            log(f"already present: {path}")
        return path
    t0 = time.perf_counter()
    users, items, ratings, timestamps = draw(seed, n_users=n_users, n_items=n_items, target_nnz=target_nnz,
                                             min_per_user=min_per_user, max_per_user=max_per_user, log=log)
    body = csv_bytes(users + 1, items + 1, ratings, timestamps)  # raw ids are 1-based, as in the real file
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(HEADER)
        fh.write(memoryview(body))
    os.replace(tmp, path)
    if log:
        log(f"done: {len(users):,} ratings, {os.path.getsize(path) / 1e6:.0f} MB, {time.perf_counter() - t0:.1f} s")
    return path


def synthetic_urm(u: int, i: int, per_user: int, seed: int = 0) -> sps.csr_matrix:
    """A ``u`` x ``i`` float32 0/1 CSR matrix of ``per_user`` uniform item
    draws a user, duplicates merged to 1 (scripts/beyond_hbm_demo.py:30-40)."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(u, dtype=np.int64), per_user)
    cols = rng.randint(0, i, size=u * per_user).astype(np.int64)
    mat = sps.csr_matrix((np.ones(u * per_user, np.float32), (rows, cols)), shape=(u, i))
    mat.sum_duplicates()
    mat.data[:] = 1.0
    return mat


def shaped_split(n_users: int, n_items: int, density: float):
    """(train, test) float32 CSR of a Bernoulli(``density``) 0/1 matrix,
    each entry in train with probability 0.8 (numpy seed 0, bench.py:49-66)."""
    rng = np.random.RandomState(0)
    dense = (rng.rand(n_users, n_items) < density).astype(np.float32)
    mask = rng.rand(n_users, n_items) < 0.8
    return sps.csr_matrix(dense * mask), sps.csr_matrix(dense * ~mask)


def ml1m_shaped_split():
    """The ML-1M-shaped split: 6040 x 3706, density 0.0446."""
    return shaped_split(6040, 3706, 0.0446)


def lastfm_shaped_split():
    """The LastFM-shaped split (BASELINE.md:11): 1884 x 17632, density 0.00279."""
    return shaped_split(1884, 17632, 0.00279)
