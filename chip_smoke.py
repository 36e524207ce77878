#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ganmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

1. require CUDA;
2. print the card's name and power limit (nvidia-smi);
3. build the CUDA kernels from ganmf_tpu_torch/csrc and print the build time;
4. hold K1 (the fused masked top-k scorer) against its plain PyTorch version
   on the card, at the evaluation block's shapes in user and item
   orientation, at a ragged item count, with exact ties and with fully
   masked rows; print both times (median of 20 runs);
5. drive the serving slice at GANMF's ML-1M width (num_factors=250,
   emb_dim=992, random weights from a seed) on an ML-1M-shaped synthetic
   split, in user and then item mode: recommend, serve_all and the holdout
   evaluation, each held against the same model's plain path on the CPU;
   check that the kernel carried the run and print eval users/s;
6. print one JSON line with every kernel's launches, error and times, then
   the card line, then the result line.

Imports nothing of JAX. It needs the repository checkout: alone it fails.
"""

import json
import subprocess
import sys
import time

import numpy as np

CUTOFFS = [5, 10, 20, 50]
NUM_FACTORS, EMB_DIM = 250, 992  # GANMF's ML-1M best params (bench.py)
SEED = 1337
RTOL, ATOL = 1e-5, 1e-7  # f32 scores, summed in another order than cuBLAS
METRIC_TOL = 1e-5


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def ml1m_split():
    """The ML-1M-shaped synthetic split of bench.py: 6040 x 3706, density
    0.0446, 80/20 train/test, numpy seed 0."""
    import scipy.sparse as sps

    rng = np.random.RandomState(0)
    dense = (rng.rand(6040, 3706) < 0.0446).astype(np.float32)
    mask = rng.rand(6040, 3706) < 0.8
    return sps.csr_matrix(dense * mask), sps.csr_matrix(dense * ~mask)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps=20):
    """Median of ``reps`` CUDA-event timings of fn(), after two warm-ups."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def ids_agree(ids_a, ids_b, scores, finite):
    """Ids equal at every finite slot, except where the two candidates' plain
    scores differ by less than the tolerance (a near-tie the two summation
    orders may break either way)."""
    import torch

    diff = (ids_a != ids_b) & finite
    if not bool(diff.any()):
        return 0
    sa = torch.gather(scores, 1, ids_a)[diff]
    sb = torch.gather(scores, 1, ids_b)[diff]
    if not bool(((sa - sb).abs() <= RTOL * sb.abs() + ATOL).all()):
        fail("K1 ids differ from the plain version's beyond a near-tie")
    return int(diff.sum())


def compare_k1(name, U, V, mask, k):
    """K1 against its plain version on the same CUDA tensors."""
    import torch

    from ganmf_tpu_torch.ops.scorer import masked_topk_scores, masked_topk_scores_reference

    kv, ki = masked_topk_scores(U, V, mask, k)
    pv, pi = masked_topk_scores_reference(U, V, mask, k)
    torch.cuda.synchronize()
    scores = (U @ V.T).masked_fill(mask, float("-inf"))
    fin = torch.isfinite(pv)
    if not torch.equal(torch.isfinite(kv), fin):
        fail(f"{name}: K1 and plain differ in which slots are finite")
    if not (bool((ki >= 0).all()) and bool((ki < V.shape[0]).all())):
        fail(f"{name}: K1 returned an id outside [0, I)")
    if bool(torch.gather(mask, 1, ki)[fin].any()):
        fail(f"{name}: K1 ranked a masked item")
    err = (kv[fin] - pv[fin]).abs()
    max_abs_err = float(err.max()) if err.numel() else 0.0
    if not bool((err <= RTOL * pv[fin].abs() + ATOL).all()):
        fail(f"{name}: K1 values differ beyond rtol {RTOL}")
    swaps = ids_agree(ki, pi, scores, fin)
    print(f"  {name}: B={U.shape[0]} K={U.shape[1]} I={V.shape[0]} k={k} "
          f"max_abs_err={max_abs_err:.3e} near-tie swaps={swaps} finite={int(fin.sum())}/{fin.numel()}")
    return max_abs_err


def phase_kernel(dev, card):
    import torch

    from ganmf_tpu_torch.ops.scorer import masked_topk_scores, masked_topk_scores_reference

    print("[4] K1 against its plain version")
    g = torch.Generator().manual_seed(SEED)

    def factors(B, I, K, scale=0.05):
        U = (torch.rand(B, K, generator=g) * 2 - 1) * scale
        V = (torch.rand(I, K, generator=g) * 2 - 1) * scale
        return U.to(dev), V.to(dev)

    def seen(B, I, p=0.0446 * 0.8):
        return (torch.rand(B, I, generator=g) < p).to(dev)

    errs = []
    # the evaluation block of the slice, in user orientation (items = 3706)
    U, V = factors(3024, 3706, NUM_FACTORS)
    M = seen(3024, 3706)
    errs.append(compare_k1("user orientation", U, V, M, 50))
    # item orientation: ranking over the other axis (items = 6040)
    Ui, Vi = factors(1856, 6040, NUM_FACTORS)
    errs.append(compare_k1("item orientation", Ui, Vi, seen(1856, 6040), 50))
    # ragged item count and row count, serve_all's and recommend's k
    Ur, Vr = factors(37, 1001, 64)
    errs.append(compare_k1("ragged I, k=20", Ur, Vr, seen(37, 1001, 0.3), 20))
    errs.append(compare_k1("ragged I, k=5", Ur[:5].contiguous(), Vr, seen(5, 1001, 0.3), 5))
    # exact ties: duplicated item rows on an exactly representable grid, and
    # fully masked rows (plus one row with fewer than k unmasked items)
    Ut = (torch.randint(-4, 5, (64, 32), generator=g).float() / 8).to(dev)
    base = torch.randint(-4, 5, (40, 32), generator=g).float() / 8
    Vt = base[torch.randint(0, 40, (700,), generator=g)].to(dev)
    Mt = seen(64, 700, 0.2)
    Mt[3] = True
    Mt[10] = True
    Mt[11, :] = True
    Mt[11, ::100] = False  # 7 unmasked items, k = 50
    errs.append(compare_k1("exact ties + masked rows", Ut, Vt, Mt, 50))

    ms = cuda_ms(lambda: masked_topk_scores(U, V, M, 50))
    plain_ms = cuda_ms(lambda: masked_topk_scores_reference(U, V, M, 50))
    print(f"  K1 time at B=3024 K=250 I=3706 k=50: {ms:.4f} ms; plain (matmul + masked_fill +"
          f" stable sort): {plain_ms:.4f} ms  [{card}]")
    return max(errs), ms, plain_ms


def phase_slice(dev, card, train, test):
    import copy

    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import GANMF, init_params
    from ganmf_tpu_torch.ops import scorer

    cpu = torch.device("cpu")
    for mode in ("user", "item"):
        print(f"[5] GANMF {mode} mode: num_factors={NUM_FACTORS} emb_dim={EMB_DIM} "
              f"on {train.shape[0]} x {train.shape[1]}")
        model = GANMF(train, mode=mode, seed=SEED, is_experiment=True, device=dev)
        n_rows, n_cols = model._train_matrix().shape
        model.params = init_params(n_rows, n_cols, NUM_FACTORS, EMB_DIM,
                                   torch.Generator().manual_seed(SEED), dev)
        plain = GANMF(train, mode=mode, seed=SEED, is_experiment=True, device=cpu)
        plain.params = copy.deepcopy(model.params).to(cpu)

        users = np.arange(5)
        recs = model.recommend(users, cutoff=20)
        precs = plain.recommend(users, cutoff=20)
        if recs != precs:
            scores = plain.score_device(torch.as_tensor(users))
            for a, b, s in zip(recs, precs, scores):
                if len(a) != len(b) or not np.allclose(s[a].numpy(), s[b].numpy(), rtol=RTOL, atol=ATOL):
                    fail(f"{mode}: recommend lists differ from the plain path beyond near-ties")
        print(f"  recommend(users 0-4, cutoff=20): user 0 -> {recs[0][:10]} ...")

        t0 = time.perf_counter()
        idx, vals = model.serve_all(cutoff=20)
        serve_s = time.perf_counter() - t0
        pidx, pvals = plain.serve_all(cutoff=20)
        if idx.shape != (train.shape[0], 20) or not np.isfinite(vals).all():
            fail(f"{mode}: serve_all returned {idx.shape} or non-finite scores")
        if not np.allclose(vals, pvals, rtol=RTOL, atol=ATOL):
            fail(f"{mode}: serve_all scores differ from the plain path")
        full = plain.score_device(torch.arange(train.shape[0]))
        swaps = ids_agree(torch.from_numpy(idx).long(), torch.from_numpy(pidx).long(), full,
                          torch.ones(idx.shape, dtype=torch.bool))
        print(f"  serve_all(cutoff=20): {idx.shape[0]} users in {serve_s:.4f} s "
              f"(first call), near-tie swaps vs plain: {swaps}")

        ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
        before = scorer.LAUNCHES
        results, text = ev.evaluateRecommender(model)
        torch.cuda.synchronize()
        if scorer.LAUNCHES <= before:
            fail(f"{mode}: the evaluation did not launch K1")
        t0 = time.perf_counter()
        results, text = ev.evaluateRecommender(model)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        n_eval = len(ev.usersToEvaluate)
        print(text, end="")

        presults, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(plain)
        worst = 0.0
        for c in CUTOFFS:
            for metric, value in results[c].items():
                ref = presults[c][metric]
                if not (np.isfinite(value) and np.isfinite(ref)):
                    fail(f"{mode}: {metric}@{c} is not finite ({value}, plain {ref})")
                worst = max(worst, abs(value - ref))
        if worst > METRIC_TOL:
            fail(f"{mode}: a metric differs from the plain CPU path by {worst:.3e} > {METRIC_TOL}")
        print(f"  every metric at every cutoff within {worst:.3e} of the plain CPU path")
        print(f"  eval: {n_eval} users x {len(CUTOFFS)} cutoffs in {eval_s:.4f} s = "
              f"{n_eval / eval_s:.1f} users/s (second call)  [{card}]")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"[1] CUDA: {torch.cuda.device_count()} device(s); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    card = card_line()
    print(f"[2] card: {card}")

    from ganmf_tpu_torch.ops import _build, scorer
    from ganmf_tpu_torch.utils.device import cuda_device

    dev = cuda_device()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[3] built and loaded {_build.library_path().name} in {time.perf_counter() - t0:.2f} s")

    max_err, ms, plain_ms = phase_kernel(dev, card)

    train, test = ml1m_split()
    scorer.LAUNCHES = 0  # count only the main path's launches
    phase_slice(dev, card, train, test)
    launches = scorer.LAUNCHES
    if launches == 0:
        fail("the main path never launched K1")

    print(json.dumps({"kernels": [{
        "name": "masked_topk_scores (K1)",
        "route": "cuda",
        "source": "ganmf_tpu_torch/csrc/masked_topk.cu",
        "replaces": "ganmf_tpu/ops/pallas_scorer.py:26",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
