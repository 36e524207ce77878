"""Interactive serving latency: the port's counterpart of
scripts/serving_latency.py.

    python -m ganmf_tpu_torch.cli.serving_latency [dataset ...] [--out PATH]

p50 and p99 of ``recommend(cutoff=20, remove_seen_flag=True)`` at b=1
(``N_SINGLE`` calls) and b=32 (``N_BATCH`` calls) for the MF (PureSVD, K=50),
ItemKNN (cosine, topK 300, shrink 0) and GANMF (user mode, seed 1337, 2
epochs, K=64, emb_dim 128, batch 256) families, after a warm-up call of each
shape, the users drawn from ``RandomState(0)`` as in the JAX script. Each
call is timed by the host clock: ``recommend`` returns host lists, so the
device has finished. After the timed calls, the same users go through an
untimed ``recommend`` each, whose lists must equal the timed ones.

The datasets are the synthetic ML-1M-shaped and LastFM-shaped splits
(``data.synthetic``; the JAX script reads the reference splits, absent
here): "1M" (6040 x 3706, density 0.0446) and "LastFM" (1884 x 17632,
0.00279), 80/20, numpy seed 0. MF and GANMF rank through K1 (its fused
kernel at k=20); on the card every timed call of theirs must launch it, and
none its wide pair. ItemKNN ranks by the dense route.

Each row is the JAX script's PERF row, its name, p50 as its seconds and its
note, with p50 and p99 in ms, users/s at p50, K1's launches over the timed
calls and the card; one JSON line a row on standard output, all of them in
``--out`` (default chiprun_out/serving_latency.json; never PERF.json). It
runs on the card unless ``main`` is given the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, List

import numpy as np
import torch

from ganmf_tpu_torch.cli.scale20m import card_line
from ganmf_tpu_torch.data.synthetic import lastfm_shaped_split, ml1m_shaped_split
from ganmf_tpu_torch.utils.device import as_device

N_SINGLE = 200
N_BATCH = 100
BATCH = 32
CUTOFF = 20
FAMILIES = ("MF", "ItemKNN", "GANMF")
PURESVD_PARAMS = dict(num_factors=50)
ITEMKNN_PARAMS = dict(topK=300, shrink=0, similarity="cosine")
GANMF_PARAMS = dict(epochs=2, num_factors=64, emb_dim=128, batch_size=256)
GANMF_SEED = 1337


SPLITS = {"1M": ml1m_shaped_split, "LastFM": lastfm_shaped_split}


def fit_family(family: str, train, device):
    """The family's model fitted on ``train`` at the JAX script's settings."""
    from ganmf_tpu_torch.models import GANMF, ItemKNNCFRecommender, PureSVDRecommender

    if family == "MF":
        m = PureSVDRecommender(train, device=device)
        m.fit(**PURESVD_PARAMS)
    elif family == "ItemKNN":
        m = ItemKNNCFRecommender(train, device=device)
        m.fit(**ITEMKNN_PARAMS)
    elif family == "GANMF":
        m = GANMF(train, mode="user", seed=GANMF_SEED, is_experiment=True, device=device)
        m.fit(**GANMF_PARAMS)
    else:
        raise ValueError(f"unknown family {family!r}; the families are {', '.join(FAMILIES)}")
    return m


def percentiles(samples) -> tuple:
    """(p50, p99) of the samples (``np.percentile``, as the JAX script)."""
    a = np.asarray(samples)
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def _timed_calls(model, draws: List) -> tuple:
    """(walls, lists, K1 fused launches, wide launches) of one timed
    ``recommend`` a draw (a user id or an id array)."""
    from ganmf_tpu_torch.ops import scorer

    walls, lists, fused, wide = [], [], [], []
    for users in draws:
        n0, w0 = scorer.LAUNCHES, scorer.WIDE_LAUNCHES
        t0 = time.perf_counter()
        lists.append(model.recommend(users, cutoff=CUTOFF, remove_seen_flag=True))
        walls.append(time.perf_counter() - t0)
        wide.append(scorer.WIDE_LAUNCHES - w0)
        fused.append(scorer.LAUNCHES - n0 - wide[-1])
    return walls, lists, fused, wide


def measure(model, family: str, ds: str, n_users: int, device, card: str, log: Callable = print) -> List[dict]:
    """The b=1 and b=32 rows of one model (scripts/serving_latency.py:46-66).
    Raises when an untimed call's lists differ from the timed call's, or,
    on the card, when a K1 family's timed call launched no fused kernel or a
    wide pair."""
    device = torch.device(device)
    rng = np.random.RandomState(0)
    # warm-up of both shapes
    model.recommend(int(rng.randint(n_users)), cutoff=CUTOFF, remove_seen_flag=True)
    model.recommend(rng.randint(0, n_users, size=BATCH), cutoff=CUTOFF, remove_seen_flag=True)
    singles = [int(rng.randint(n_users)) for _ in range(N_SINGLE)]
    batches = [rng.randint(0, n_users, size=BATCH) for _ in range(N_BATCH)]
    k1 = model._ranks_with_k1()
    rows = []
    for b, draws in ((1, singles), (BATCH, batches)):
        walls, lists, fused, wide = _timed_calls(model, draws)
        for users, got in zip(draws, lists):
            if model.recommend(users, cutoff=CUTOFF, remove_seen_flag=True) != got:
                raise RuntimeError(f"{family} on {ds} at b={b}: an untimed recommend's lists differ from the "
                                   f"timed call's (users {users})")
        if device.type == "cuda" and k1 and (min(fused) == 0 or sum(wide)):
            raise RuntimeError(f"{family} on {ds} at b={b}: K1's fused kernel launched {min(fused)} times on "
                               f"a timed call at the least, its wide pair {sum(wide)} times in all")
        p50, p99 = percentiles(walls)
        n = len(walls)
        note = (f"p99 {p99 * 1e3:.1f} ms, n={n}" if b == 1
                else f"p99 {p99 * 1e3:.1f} ms ({b / p50:,.0f} users/s at p50), n={n}")
        row = {"name": f"Latency[{ds}] {family} recommend b={b}", "seconds": p50, "note": note,
               "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3, "users_per_s_at_p50": b / p50, "n": n,
               "route": "K1 fused" if k1 else "dense", "k1_fused_launches": int(sum(fused)),
               "k1_wide_launches": int(sum(wide)), "lists_equal_untimed": True, "card": card}
        log(f"{row['name']:40s} p50 {p50 * 1e3:8.3f} ms, p99 {p99 * 1e3:8.3f} ms, {b / p50:,.0f} users/s at "
            f"p50, n={n}  [{card}]")
        rows.append(row)
    return rows


def main(argv=None, device=None) -> int:
    """Measure every family on the named datasets (default both) on the card
    (``device``: a caller may ask for the CPU); returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("datasets", nargs="*", metavar="dataset", help=f"any of {', '.join(SPLITS)} (default: all)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "serving_latency.json"))
    args = ap.parse_args(argv)
    unknown = sorted(set(args.datasets) - set(SPLITS))
    if unknown:
        ap.error(f"unknown datasets {unknown}; the datasets are {', '.join(SPLITS)} (no split of another "
                 "shape is in the repository)")
    device = as_device(device)
    card = card_line() if device.type == "cuda" else str(device)
    log = lambda line: print(line, flush=True)  # noqa: E731
    rows = []
    for ds in args.datasets or list(SPLITS):
        train, _ = SPLITS[ds]()
        for family in FAMILIES:
            model = fit_family(family, train, device)
            for row in measure(model, family, ds, train.shape[0], device, card, log):
                rows.append(row)
                log(json.dumps(row))
            del model
            if device.type == "cuda":
                torch.cuda.empty_cache()
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
