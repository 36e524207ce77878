"""A 0/1 rating matrix at a MovieLens release's published counts, from a seed.

The marginals are those of the ML-20M stand-in of
``ganmf_tpu_torch/data/synthetic.py`` (``draw``): log-normal user activity
clipped to [min, max] and scaled to the published total, Zipf item
popularity over a shuffled order, and taste clusters over a disjoint
partition of the catalog, each boosting its own items ``cluster_boost``
times. Two things differ, so that every seed gives the same amount of work:

- the activities are the log-normal's quantiles, scaled so that they sum to
  the published number of ratings exactly; the seed only decides which user
  has which;
- each user's items are drawn without replacement (exponential keys over the
  user's cluster weights, Efraimidis-Spirakis), which is what the stand-in's
  oversample, deduplicate and trim approximates.

The holdout gives each user ``round(test_share * n)`` of its n ratings as
test, chosen uniformly, so the train and test totals are fixed too. All
draws run on ``device`` from a ``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sps
import torch

from benchmark.data import derive_seed

#: rows of the [rows, items] key block drawn at once
CHUNK_ELEMENTS = 1 << 28


class Ratings(NamedTuple):
    train: sps.csr_matrix  # [users, items] float32 0/1
    test: sps.csr_matrix
    user_cluster: torch.Tensor  # [users] int64 on the device
    item_cluster: torch.Tensor  # [items] int64 on the device


def activities(spec: dict) -> np.ndarray:
    """Ratings per user, sorted ascending: the log-normal's quantiles at
    (i + 0.5) / users, scaled and clipped to [min, max], summing to
    ``n_ratings`` exactly."""
    n, total = int(spec["n_users"]), int(spec["n_ratings"])
    lo, hi = int(spec["min_per_user"]), int(spec["max_per_user"])
    mu, sigma = spec["activity_lognormal"]
    if not lo * n <= total <= hi * n:
        raise ValueError(f"{total} ratings do not fit {n} users at [{lo}, {hi}] each")
    q = torch.special.ndtri((torch.arange(n, dtype=torch.float64) + 0.5) / n).numpy()
    x = np.exp(mu + sigma * q)
    a, b = 0.0, hi / x.min()
    for _ in range(200):  # the scale at which the clipped sum meets the total
        s = 0.5 * (a + b)
        a, b = (s, b) if np.clip(s * x, lo, hi).sum() < total else (a, s)
    acts = np.floor(np.clip(b * x, lo, hi)).astype(np.int64)
    short = total - int(acts.sum())
    room = np.flatnonzero(acts < hi)[::-1]  # the heaviest users below the clip take the rest
    if short < 0 or short > len(room):
        raise ValueError("cannot place the remainder of the ratings")
    acts[room[:short]] += 1
    return np.sort(acts)


def zipf_popularity(n_items: int, exponent: float) -> torch.Tensor:
    ranks = torch.arange(1, n_items + 1, dtype=torch.float64)
    pop = ranks ** -exponent
    return pop / pop.sum()


def generate(spec: dict, seed: int, device: torch.device) -> Ratings:
    """The train and test matrices of ``spec`` (a configuration's ``data``)
    for ``seed``."""
    U, I = int(spec["n_users"]), int(spec["n_items"])
    C = int(spec["n_clusters"])
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, 0))

    def perm(n):
        return torch.randperm(n, generator=g, device=device)

    acts = torch.from_numpy(activities(spec)).to(device)[perm(U)]
    n_test = torch.round(acts.double() * float(spec["test_share"])).long()
    pop = zipf_popularity(I, float(spec["zipf_exponent"])).to(device)[perm(I)]
    user_cluster = (torch.arange(U, device=device) % C)[perm(U)]
    item_cluster = (torch.arange(I, device=device) % C)[perm(I)]
    # the weight of every item for a user of each cluster, [C, I]
    boost = torch.where(item_cluster[None, :] == torch.arange(C, device=device)[:, None],
                        float(spec["cluster_boost"]), 1.0)
    weights = (pop[None, :] * boost).float()

    rows_per_chunk = max(1, CHUNK_ELEMENTS // I)
    users, items, is_test = [], [], []
    for lo in range(0, U, rows_per_chunk):
        hi = min(U, lo + rows_per_chunk)
        a = acts[lo:hi]
        kmax = int(a.max())
        keys = torch.empty((hi - lo, I), device=device).exponential_(generator=g)
        keys /= weights.index_select(0, user_cluster[lo:hi])
        picked = torch.topk(keys, kmax, dim=1, largest=False, sorted=False).indices
        del keys
        valid = torch.arange(kmax, device=device)[None, :] < a[:, None]
        # the test share: the n_test smallest of uniform draws over the valid slots
        u = torch.rand((hi - lo, kmax), generator=g, device=device).masked_fill(~valid, 2.0)
        rank = torch.empty_like(picked)
        order = torch.argsort(u, dim=1)
        rank.scatter_(1, order, torch.arange(kmax, device=device).expand(hi - lo, kmax).contiguous())
        test = rank < n_test[lo:hi, None]
        row = torch.arange(lo, hi, device=device)[:, None].expand(hi - lo, kmax)
        users.append(row[valid])
        items.append(picked[valid])
        is_test.append(test[valid])
    users, items, is_test = torch.cat(users), torch.cat(items), torch.cat(is_test)
    return Ratings(_csr(users[~is_test], items[~is_test], U, I), _csr(users[is_test], items[is_test], U, I),
                   user_cluster, item_cluster)


def _csr(users: torch.Tensor, items: torch.Tensor, U: int, I: int) -> sps.csr_matrix:
    """A float32 0/1 CSR matrix of the (user, item) pairs, sorted on the
    device and assembled on the host."""
    key = torch.sort(users * I + items).values
    users, items = (key // I).cpu().numpy(), (key % I).cpu().numpy()
    indptr = np.zeros(U + 1, dtype=np.int64)
    np.cumsum(np.bincount(users, minlength=U), out=indptr[1:])
    return sps.csr_matrix((np.ones(len(items), np.float32), items.astype(np.int32), indptr), shape=(U, I))
