#!/usr/bin/env python3
"""The port's counterpart of bench.py's rows, on one CUDA card.

    python3 scripts/torch_bench.py            # the ML-1M rows
    python3 scripts/torch_bench.py --ml20m    # the two ML-20M rows

Runs on the ML-1M-shaped split that bench.py synthesizes when the reference
splits are absent (6040 x 3706, density 0.0446, 80/20 train/test, numpy seed
0), at bench.py's configurations:

- ganmf_ml1m_train_epoch_time (the headline): GANMF at BEST_PARAMS_ML1M
  (num_factors=250, emb_dim=992, batch_size=64, m=10), user mode, s/epoch;
- cfgan_ml1m_train_epoch_time: CFGAN at bench.py:127-128 (d_nodes=64,
  g_nodes=256, ZR 0.3, zr_coefficient 0.1, batches of 128), user mode, s/epoch;
- ials_ml1m_epoch_time: IALS at num_factors=50, alpha=5, s/epoch;
- eval_ml1m_users_per_s: PureSVD at num_factors=50 evaluated at cutoffs
  [5, 10, 20, 50] over every test user;
- serve_all_ml1m_users_per_s: the same model's serve_all(cutoff=20).

Each value is the median of REPS synchronized repetitions after WARM warm
ones (a host-timed call spreads up to 2.7x), printed with its min and max.
The card's name and power limit come first, then one JSON line in bench.py's
shape (``metric``, ``value``, ``unit``, ``basket``) with ``min``, ``max`` and
``reps`` beside each value; it has no ``vs_baseline``, because bench.py's
baselines are the reference's walls on another card. The script needs a
card: without one it exits nonzero.

With ``--ml20m`` it prints bench.py:207-254's two rows instead, on the
ML-20M stand-in's implicit split (ganmf_tpu_torch.cli.scale20m.load_splits:
the ratings.csv of ganmf_tpu_torch.data.synthetic under $GANMF_TPU_DATA,
written when missing, and the split under experiments/datasets, loaded when
there), each the median of ML20M_REPS repetitions after ML20M_WARM warm ones:

- ials20m_epoch_time: one IALS epoch at K=96, alpha 5, reg 1e-2,
  urm_storage="csr", after a fit of one epoch, s;
- serve20m_users_per_s: PureSVD at num_factors=128, serve_all(cutoff=20)
  over all 138,493 users.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WARM, REPS = 2, 10
ML20M_WARM, ML20M_REPS = 1, 5  # an ML-20M epoch takes seconds
SEED = 1337
# bench.py:42-46
BEST_PARAMS_ML1M = dict(num_factors=250, emb_dim=992, batch_size=64, m=10, d_lr=0.0001,
                        g_lr=0.0001653241474168571, d_reg=0.0001, recon_coefficient=0.01)
# bench.py:127-128
CFGAN_PARAMS = dict(d_nodes=64, g_nodes=256, scheme="ZR", zr_ratio=0.3, zr_coefficient=0.1,
                    d_batch_size=128, g_batch_size=128)
IALS_PARAMS = dict(num_factors=50, alpha=5.0)
SVD_FACTORS = 50
CUTOFFS = [5, 10, 20, 50]


def ml1m_split():
    """bench.py:49-66's synthetic split: 6040 x 3706, density 0.0446, 80/20."""
    from ganmf_tpu_torch.data.synthetic import ml1m_shaped_split

    return ml1m_shaped_split()


def timed_runs(fn, warm=WARM, reps=REPS):
    """Seconds of ``warm`` + ``reps`` synchronized calls of fn(); the warm
    ones are dropped."""
    import torch

    secs = []
    for _ in range(warm + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs[warm:]


def epoch_seconds(model_class, train, dev, **params):
    """Seconds of each of WARM + REPS epochs of one fit without validation
    (the fit's own loop: the shuffle, the epoch and, for CFGAN, K2's draws);
    the warm ones are dropped."""
    from ganmf_tpu_torch.cli.scale20m import with_epoch_walls

    model = with_epoch_walls(model_class, dev)(train, mode="user", seed=SEED, is_experiment=True, device=dev)
    model.fit(**params, epochs=WARM + REPS, validation_evaluator=None)
    return model.epoch_walls[WARM:]


def row(metric, unit, values):
    med, lo, hi = float(np.median(values)), float(np.min(values)), float(np.max(values))
    print(f"{metric}: {med} {unit} (min {lo}, max {hi}, median of {len(values)})", flush=True)
    return {"metric": metric, "value": med, "unit": unit, "min": lo, "max": hi, "reps": len(values)}


def ml20m_rows(dev):
    """bench.py's bench_20m rows on the ML-20M stand-in."""
    from ganmf_tpu_torch.cli import scale20m
    from ganmf_tpu_torch.data import synthetic
    from ganmf_tpu_torch.models import IALSRecommender, PureSVDRecommender

    data_dir = scale20m.default_data_dir()
    synthetic.synthesize(synthetic.ratings_path(data_dir))
    splits, _, _ = scale20m.load_splits(data_dir, os.path.join("experiments", "datasets"))
    train = splits.train
    runs = dict(warm=ML20M_WARM, reps=ML20M_REPS)

    ials = IALSRecommender(train, device=dev)
    ials.fit(epochs=1, **{k: v for k, v in scale20m.IALS_PARAMS.items() if k != "epochs"})
    rows = [row("ials20m_epoch_time", "s", timed_runs(lambda: ials._run_epoch(0), **runs))]
    del ials

    svd = PureSVDRecommender(train, device=dev)
    svd.fit(**scale20m.PURESVD_PARAMS)
    rates = [train.shape[0] / s for s in timed_runs(lambda: svd.serve_all(cutoff=20), **runs)]
    rows.append(row("serve20m_users_per_s", "users/s", rates))
    return rows


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ml20m", action="store_true", help="bench.py's two ML-20M rows in place of the ML-1M ones")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench: no CUDA device is available", file=sys.stderr)
        return 1
    from ganmf_tpu_torch.cli.scale20m import card_line

    print(card_line(), flush=True)

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import CFGAN, GANMF, IALSRecommender, PureSVDRecommender
    from ganmf_tpu_torch.utils.device import cuda_device

    dev = cuda_device()
    if args.ml20m:
        head, *basket = ml20m_rows(dev)
        print(json.dumps(dict(head, basket=basket)))
        return 0
    train, test = ml1m_split()
    rows = [row("ganmf_ml1m_train_epoch_time", "s", epoch_seconds(GANMF, train, dev, **BEST_PARAMS_ML1M)),
            row("cfgan_ml1m_train_epoch_time", "s", epoch_seconds(CFGAN, train, dev, **CFGAN_PARAMS))]

    ials = IALSRecommender(train, device=dev)
    ials.fit(epochs=1, **IALS_PARAMS)
    rows.append(row("ials_ml1m_epoch_time", "s", timed_runs(lambda: ials._run_epoch(0))))

    svd = PureSVDRecommender(train, device=dev)
    svd.fit(num_factors=SVD_FACTORS)
    ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
    n_eval = len(ev.usersToEvaluate)
    rates = [n_eval / s for s in timed_runs(lambda: ev.evaluateRecommender(svd))]
    rows.append(row("eval_ml1m_users_per_s", "users/s", rates))
    rates = [train.shape[0] / s for s in timed_runs(lambda: svd.serve_all(cutoff=20))]
    rows.append(row("serve_all_ml1m_users_per_s", "users/s", rates))

    head, *basket = rows
    print(json.dumps(dict(head, basket=basket)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
