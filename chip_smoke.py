#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ganmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

1. require CUDA;
2. print the card's name and power limit (nvidia-smi);
3. build the CUDA kernels from ganmf_tpu_torch/csrc (one nvcc per source, all
   at once), print the build time and what ptxas reports for each kernel
   (registers, spills);
4. hold K1 (the masked top-k scorer) against its plain PyTorch version on
   the card: its fused kernel (k <= 64) at the evaluation block's shapes in
   user and item orientation, at serve_all's and recommend's, at a ragged
   item count, with exact ties and with fully masked rows; its wide pair
   (k > 64) at recommend's default cutoff (B=5 and B=1), at LastFM's item
   count (k=100 and k=I-1) and with exact ties and masked rows; print each
   form's time beside its plain version's, the library composition's
   (matmul + masked_fill_ + topk, a yardstick the port never calls) and its
   bound (median of 20 runs), the fused kernel also at serve_all's, item
   mode's and recommend's shapes (B=5 and B=1 at cutoff 20), with the item
   splits its wrapper launched, the wide pair at recommend's default cutoff
   (B=5 and B=1) and at k=100 above the fused kernel's cutoffs (B=3024,
   I=3706 and B=64, I=17632);
5. hold K2 (exact-k row selection) against its plain PyTorch version on the
   card, bitwise, at CFGAN's mask shapes (user and item mode, and the
   padded batches), the streamed batch shape, the widest row, with heavy
   ties, negative keys, signed zeros and rows with k = 0 and k = I; print
   its time through the wrapper and the launch alone, its plain version's
   and its bound at [2048, 17632], [1884, 17632] and [17632, 1884] (median
   of 20 runs);
6. drive the serving slice at GANMF's ML-1M width (num_factors=250,
   emb_dim=992, random weights from a seed) on an ML-1M-shaped synthetic
   split, in user and then item mode: recommend (at cutoff 20 and at the
   default cutoff), serve_all and the holdout evaluation, each held against
   the same model's plain path on the CPU; check that both forms of K1
   carried the run, the fused kernel with its merge pass, and print eval
   users/s;
7. train GANMF at its ML-1M best params (num_factors=250, emb_dim=992,
   batch_size=64, m=10; bench.py) on the same split for 3 epochs, with early
   stopping evaluating the test split every epoch, in user and then item
   mode; check that those evaluations launched K1's fused kernel and that
   recommend at the default cutoff on the trained model launched the wide
   pair; print seconds per epoch and the final losses, and check that the
   losses are finite and every parameter moved;
8. hold GANMF's training against its plain path on the CPU: one epoch from
   the same state and permutation (parameters within a stated bound, the
   mean losses within rtol 1e-4), and the trained model's evaluation on the
   card against its copy on the CPU (every metric within 1e-5);
9. train CFGAN at its published LastFM width (g_nodes=1024, d_layers=5) for
   3 epochs with early stopping on a LastFM-shaped synthetic split, in user
   and then item mode; check that K2 drew every epoch's masks; print seconds
   per epoch, then recommend (default cutoff), serve_all and the evaluation;
10. hold the CFGAN path against its plain path on the CPU: one epoch from the
    same state and draws (masks bitwise, parameters within a stated bound),
    the generator output, and the evaluation and serve_all on the same
    scores;
11. print one JSON line with every kernel's launches, error, times and bound
    (K1's two forms as entries of their own), then the card line, then the
    result line.

Imports nothing of JAX. It needs the repository checkout: alone it fails.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np

CUTOFFS = [5, 10, 20, 50]
NUM_FACTORS, EMB_DIM = 250, 992  # GANMF's ML-1M best params (bench.py)
SEED = 1337
RTOL, ATOL = 1e-5, 1e-7  # f32 scores, summed in another order than cuBLAS
METRIC_TOL = 1e-5
# an H100 SXM's peaks (NVIDIA's data sheet): float32 FMAs on the CUDA cores
# (no TF32: the reference scores at Precision.HIGHEST) and HBM3 bandwidth
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
# CFGAN's published best params, user mode on LastFM (scripts/parity_check.py:46-54)
CFGAN_PARAMS = dict(
    g_nodes=1024, g_layers=1, g_hidden_act="tanh",
    d_nodes=4, d_layers=5, d_hidden_act="linear",
    scheme="ZR", zr_ratio=0.4515475140394092, zr_coefficient=0.05049684341469494,
    d_batch_size=128, g_batch_size=1024,
    d_lr=1e-4, g_lr=0.00018640602403973558, d_reg=1e-4, g_reg=1e-4, d_steps=1, g_steps=1,
)
CFGAN_EPOCHS = 3
# GANMF's published best params on ML-1M (bench.py:42-46); g_reg stays 0
GANMF_PARAMS = dict(
    num_factors=NUM_FACTORS, emb_dim=EMB_DIM, batch_size=64, m=10,
    d_lr=1e-4, g_lr=0.0001653241474168571, d_reg=1e-4, recon_coefficient=0.01,
)
GANMF_EPOCHS = 3
LOSS_RTOL = 1e-4  # the epoch's mean losses, card against CPU
# the evaluation on the card and on the CPU from the same score block: only
# the order of float32 metric sums differs
SAME_SCORES_TOL = 1e-6
# generator output, card against CPU, same parameters: float32 sums in
# another order; atol covers outputs near zero (about 1e-5 of their scale)
GEN_RTOL, GEN_ATOL = 1e-5, 1e-6


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


def lastfm_split():
    """A LastFM-shaped synthetic split (BASELINE.md:11): 1884 x 17632,
    density 0.00279, 80/20 train/test, numpy seed 0."""
    import scipy.sparse as sps

    rng = np.random.RandomState(0)
    dense = (rng.rand(1884, 17632) < 0.00279).astype(np.float32)
    mask = rng.rand(1884, 17632) < 0.8
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


def bound(flops, nbytes):
    """(ms, what bounds it): the least time an H100 takes to do ``flops``
    float32 operations and move ``nbytes``."""
    ops_ms, bytes_ms = 1e3 * flops / F32_FLOPS, 1e3 * nbytes / HBM_BYTES_PER_S
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def k1_bound(B, I, K, k):
    """K1's bound: the scores' FMAs; U, V and the mask read once, the lists
    (f32 values, int64 ids) written once."""
    return bound(2 * B * I * K, 4 * (B + I) * K + B * I + 12 * B * k)


def ptxas_lines(report):
    """One line per kernel from ptxas's -v report: registers, stack, spills."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            short = re.search(r"\d([a-z][a-z_]*_kernel)", m.group(1))  # after its length
            name = short.group(1) if short else m.group(1)
        elif name and "bytes stack frame" in line:
            spills = line.strip()
        elif name and "Used" in line:
            out.append(f"  {name}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
    return out


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


def time_k1(U, V, M, k):
    """K1's, its plain version's and the library composition's times on the
    same tensors, with K1's bound."""
    import torch

    from ganmf_tpu_torch.ops.scorer import masked_topk_scores, masked_topk_scores_reference

    B, K = U.shape
    I = V.shape[0]
    t = {
        "ms": cuda_ms(lambda: masked_topk_scores(U, V, M, k)),
        "plain_ms": cuda_ms(lambda: masked_topk_scores_reference(U, V, M, k)),
        "library_ms": cuda_ms(lambda: torch.topk(torch.matmul(U, V.T).masked_fill_(M, float("-inf")), k)),
    }
    t["bound_ms"], t["bound_by"] = k1_bound(B, I, K, k)
    return t


def phase_kernel(dev, card):
    import torch

    from ganmf_tpu_torch.ops import scorer

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
    Ui, Vi = factors(3706, 6040, NUM_FACTORS)
    Mi = seen(3706, 6040)
    errs.append(compare_k1("item orientation", Ui, Vi, Mi, 50))
    # ragged item count and row count, serve_all's and recommend's k
    Ur, Vr = factors(37, 1001, 64)
    errs.append(compare_k1("ragged I, k=20", Ur, Vr, seen(37, 1001, 0.3), 20))
    errs.append(compare_k1("ragged I, k=5", Ur[:5].contiguous(), Vr, seen(5, 1001, 0.3), 5))
    # serve_all's block (k=20) and recommend for one user at an explicit cutoff
    Us, Ms = U[:2048].contiguous(), M[:2048].contiguous()
    errs.append(compare_k1("serve_all block", Us, V, Ms, 20))
    errs.append(compare_k1("one user, k=20", U[:1].contiguous(), V, M[:1].contiguous(), 20))
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

    fused = {}
    for name, (Ub, Vb, Mb, k) in {
        "evaluation block, B=3024 K=250 I=3706 k=50": (U, V, M, 50),
        "serve_all block, B=2048 K=250 I=3706 k=20": (Us, V, Ms, 20),
        "item-mode evaluation, B=3706 K=250 I=6040 k=50": (Ui, Vi, Mi, 50),
        "recommend, B=5 K=250 I=3706 k=20": (U[:5].contiguous(), V, M[:5].contiguous(), 20),
        "recommend, B=1 K=250 I=3706 k=20": (U[:1].contiguous(), V, M[:1].contiguous(), 20),
    }.items():
        t = time_k1(Ub, Vb, Mb, k)
        t["splits"] = scorer.LAST_SPLITS  # the plan of the launches just timed
        fused[name] = t
        print(f"  K1 fused at {name}: {t['ms']:.4f} ms over {t['splits']} item splits; plain "
              f"(matmul + masked_fill + stable sort) {t['plain_ms']:.4f} ms; library (matmul + "
              f"masked_fill_ + topk) {t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})  [{card}]")

    # the wide pair (k > 64): recommend's default cutoff on the slice's shape
    # (B=5 and B=1), LastFM's item count (35 tiles of 512) at k=100 and at
    # k=I-1, and exact ties with masked rows
    wide_errs = []
    Uw, Mw = U[:5].contiguous(), M[:5].contiguous()
    wide_errs.append(compare_k1("wide: recommend's default cutoff", Uw, V, Mw, 3705))
    wide_errs.append(compare_k1("wide: one user, default cutoff", U[:1].contiguous(), V,
                                M[:1].contiguous(), 3705))
    Ul, Vl = factors(64, 17632, 64)
    Ml = seen(64, 17632, 0.00279)
    wide_errs.append(compare_k1("wide: LastFM item count, k=100", Ul, Vl, Ml, 100))
    wide_errs.append(compare_k1("wide: LastFM item count, k=I-1", Ul[:5].contiguous(), Vl,
                                Ml[:5].contiguous(), 17631))
    wide_errs.append(compare_k1("wide: exact ties + masked rows, k=650", Ut, Vt, Mt, 650))
    UL, VL = factors(64, 17632, NUM_FACTORS)
    wide = {}
    for name, (Ub, Vb, Mb, k) in {
        "recommend, B=5 K=250 I=3706 k=3705": (Uw, V, Mw, 3705),
        "recommend, B=1 K=250 I=3706 k=3705": (U[:1].contiguous(), V, M[:1].contiguous(), 3705),
        "evaluation above cutoff 64, B=3024 K=250 I=3706 k=100": (U, V, M, 100),
        "LastFM items, B=64 K=250 I=17632 k=100": (UL, VL, Ml, 100),
    }.items():
        t = wide[name] = time_k1(Ub, Vb, Mb, k)
        print(f"  K1 wide pair at {name}: {t['ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
              f"library {t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})  [{card}]")
    return max(errs), fused, max(wide_errs), wide


def phase_slice(dev, card, train, test):
    import copy

    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import GANMF, init_params
    from ganmf_tpu_torch.ops import scorer

    cpu = torch.device("cpu")
    for mode in ("user", "item"):
        print(f"[6] GANMF {mode} mode: num_factors={NUM_FACTORS} emb_dim={EMB_DIM} "
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
        before = scorer.WIDE_LAUNCHES
        recs = model.recommend(users)  # the default cutoff, n_items - 1
        if scorer.WIDE_LAUNCHES != before + 1:
            fail(f"{mode}: recommend at the default cutoff did not launch K1's wide pair")
        precs = plain.recommend(users)
        scores = plain.score_device(torch.as_tensor(users))
        for u, (a, b, s) in enumerate(zip(recs, precs, scores)):
            if len(a) != train.shape[1] - train[u].nnz or len(a) != len(b):
                fail(f"{mode}: recommend(default cutoff) gave {len(a)} items for user {u}")
            if a != b and not np.allclose(s[a].numpy(), s[b].numpy(), rtol=RTOL, atol=ATOL):
                fail(f"{mode}: default-cutoff lists differ from the plain path beyond near-ties")
        print(f"  recommend(users 0-4, default cutoff): {[len(r) for r in recs]} items, "
              f"equal to the plain path up to near-ties")

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


def adam_bound_check(name, card_params, cpu_params, steps_lrs):
    """Parameters after the same Adam steps on the card and on the CPU. An
    element whose gradient sits at rounding level may move by up to about lr
    a step in either direction (|m_hat / sqrt(v_hat)| <= 1.1 over the first
    steps): the bound is 2.2 * lr * steps; and the bulk, 99% of the
    elements, must agree to 1% of lr. Returns the largest difference."""
    worst = 0.0
    for i, (a, b, (steps, lr)) in enumerate(zip(card_params, cpu_params, steps_lrs)):
        diff = (a - b).abs()
        bulk = float((diff <= 0.01 * lr).float().mean())
        worst = max(worst, float(diff.max()))
        if float(diff.max()) > 2.2 * lr * steps or bulk < 0.99:
            fail(f"{name}: parameter {i} differs by {float(diff.max()):.3e} (bound "
                 f"{2.2 * lr * steps:.3e}), {bulk:.4f} of it within 0.01 lr")
    return worst


def phase_ganmf_train(dev, card, train, test):
    """GANMF trained on the card in both modes through fit() with early
    stopping, then recommend on the trained model. Returns the models."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import GANMF, init_params
    from ganmf_tpu_torch.ops import scorer

    class TimedGANMF(GANMF):
        """Times each epoch (synchronized)."""

        def _run_training_loop(self, *args, epoch_fn, **kwargs):
            self.epoch_log = []

            def timed(epoch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                epoch_fn(epoch)
                torch.cuda.synchronize()
                self.epoch_log.append(time.perf_counter() - t0)

            return super()._run_training_loop(*args, epoch_fn=timed, **kwargs)

    models = {}
    for mode in ("user", "item"):
        print(f"[7] GANMF training, {mode} mode: {GANMF_PARAMS} on {train.shape[0]} x "
              f"{train.shape[1]}, {GANMF_EPOCHS} epochs, early stopping every epoch")
        model = TimedGANMF(train, mode=mode, seed=SEED, is_experiment=True, device=dev)
        ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
        fused_before = scorer.LAUNCHES - scorer.WIDE_LAUNCHES
        returned = model.fit(**GANMF_PARAMS, epochs=GANMF_EPOCHS, validation_evaluator=ev, freq=1)
        torch.cuda.synchronize()
        fused = scorer.LAUNCHES - scorer.WIDE_LAUNCHES - fused_before
        if len(model.epoch_log) != GANMF_EPOCHS:
            fail(f"{mode}: {len(model.epoch_log)} epochs ran, not {GANMF_EPOCHS} (fit returned {returned})")
        if fused < GANMF_EPOCHS:
            fail(f"{mode}: the early-stopping evaluations launched K1's fused kernel {fused} times")
        secs = model.epoch_log
        print(f"  fit returned {returned}; epoch seconds {[round(t, 4) for t in secs]}; median of "
              f"epochs 2-3: {float(np.median(secs[1:])):.4f} s/epoch; K1 fused launches in the "
              f"early-stopping evaluations: {fused}  [{card}]")
        losses = [(float(d), float(g)) for d, g in zip(model.train_d_loss, model.train_g_loss)]
        if not np.isfinite(losses).all():
            fail(f"{mode}: a loss is not finite: {losses}")
        print(f"  (d_loss, g_loss) per epoch: {[(round(d, 6), round(g, 6)) for d, g in losses]}")
        n_rows, n_cols = model._train_matrix().shape
        init = init_params(n_rows, n_cols, NUM_FACTORS, EMB_DIM, torch.Generator().manual_seed(SEED), dev)
        for name, t, t0 in zip(("user_emb", "item_emb", "enc_w", "enc_b", "dec_w", "dec_b"),
                               model.params.parameters(), init.parameters()):
            if not bool(torch.isfinite(t).all()):
                fail(f"{mode}: {name} is not finite after training")
            if not bool((t != t0).any()):
                fail(f"{mode}: {name} did not move in training")

        before = scorer.WIDE_LAUNCHES
        recs = model.recommend(np.arange(5))  # the default cutoff, n_items - 1
        if scorer.WIDE_LAUNCHES != before + 1:
            fail(f"{mode}: recommend at the default cutoff on the trained model did not launch K1's wide pair")
        seen = np.ediff1d(train.indptr)[:5]
        for u, lst in enumerate(recs):
            if len(lst) != train.shape[1] - seen[u] or len(set(lst)) != len(lst):
                fail(f"{mode}: recommend(default cutoff) gave {len(lst)} items for user {u}")
        print(f"  recommend(users 0-4, default cutoff) on the trained model: {[len(r) for r in recs]} "
              f"items; user 0 -> {recs[0][:10]} ...")
        models[mode] = (model, ev)
    return models


def phase_ganmf_train_plain(dev, card, train, test, models):
    """GANMF's training and the trained model on the card against the plain
    path on the CPU."""
    import copy

    import torch

    from ganmf_tpu_torch.data.device import dense_from_sparse
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import GANMF, init_params
    from ganmf_tpu_torch.models import ganmf as pgm
    from ganmf_tpu_torch.models.gan_base import make_batches, padded_weights, shuffled_padded_perm

    cpu = torch.device("cpu")
    p = GANMF_PARAMS
    bs = p["batch_size"]
    for mode in ("user", "item"):
        print(f"[8] GANMF training, {mode} mode, against the plain path on the CPU")
        model, ev = models[mode]
        mat = model._train_matrix()
        n_rows, n_cols = mat.shape
        n, padded = make_batches(n_rows, bs)
        perm = torch.from_numpy(shuffled_padded_perm(np.random.RandomState(SEED), n_rows, padded))
        w = torch.from_numpy(padded_weights(n_rows, padded))
        runs = []
        for d in (dev, cpu):
            params = init_params(n_rows, n_cols, NUM_FACTORS, EMB_DIM, torch.Generator().manual_seed(SEED), d)
            d_opt = torch.optim.Adam(params.d_params(), lr=p["d_lr"], betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
            item_opt = torch.optim.Adam([params.item_emb], lr=p["g_lr"], betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
            urm = dense_from_sparse(mat, d)
            t0 = time.perf_counter()
            dl, gl = pgm.ganmf_epoch(
                params, d_opt, item_opt, pgm.user_adam_state(params.user_emb), urm,
                perm.to(d, torch.int64), w.to(d), g_lr=p["g_lr"], m=p["m"],
                recon_coefficient=p["recon_coefficient"], d_reg=p["d_reg"], g_reg=0.0,
                n_batches=n, batch_size=bs, d_steps=1, g_steps=1)
            losses = (float(dl), float(gl))  # waits for the epoch
            runs.append(([t.detach().cpu() for t in params.parameters()], losses, time.perf_counter() - t0))
        (card_p, card_losses, card_s), (cpu_p, cpu_losses, cpu_s) = runs
        worst = adam_bound_check(mode, card_p, cpu_p, [(n, p["g_lr"])] * 2 + [(n, p["d_lr"])] * 4)
        if not np.allclose(card_losses, cpu_losses, rtol=LOSS_RTOL, atol=0):
            fail(f"{mode}: the epoch's mean losses {card_losses} differ from the CPU's {cpu_losses}")
        print(f"  one epoch ({n} minibatches in each phase) from the same state and "
              f"permutation: largest parameter difference {worst:.3e} (bounds G {2.2 * p['g_lr'] * n:.3e}, "
              f"D {2.2 * p['d_lr'] * n:.3e}); losses card {card_losses} CPU {cpu_losses}; "
              f"card {card_s:.4f} s (first call), CPU {cpu_s:.4f} s")

        plain = GANMF(train, mode=mode, seed=SEED, is_experiment=True, device=cpu)
        plain.params = copy.deepcopy(model.params).to(cpu)
        results, _ = ev.evaluateRecommender(model)
        presults, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(plain)
        worst_m = 0.0
        for c in CUTOFFS:
            for metric, value in results[c].items():
                ref = presults[c][metric]
                if not (np.isfinite(value) and np.isfinite(ref)):
                    fail(f"{mode}: trained {metric}@{c} is not finite ({value}, CPU {ref})")
                worst_m = max(worst_m, abs(value - ref))
        if worst_m > METRIC_TOL:
            fail(f"{mode}: a trained model's metric differs from the CPU copy's by {worst_m:.3e}")
        print(f"  trained model: every metric at every cutoff within {worst_m:.3e} of its CPU copy "
              f"(MAP@5 {results[5]['MAP']:.6f}, NDCG@10 {results[10]['NDCG']:.6f})")


def select_case(name, R, I, gen, ratio=CFGAN_PARAMS["zr_ratio"], density=0.00279):
    """CFGAN-style selection input: uniform keys, +inf at the interactions,
    k = int(n_zeros * ratio) in float32; the first row takes k = 0 and the
    last k = I."""
    import torch

    keys = torch.rand(R, I, generator=gen)
    if name == "ties":
        keys = torch.round(keys * 8)  # heavy ties across the boundary
    elif name == "signed":
        keys = keys - 0.5  # negative keys, and both zeros in every row
        keys[:, 0:16:2] = 0.0
        keys[:, 1:16:2] = -0.0
    inter = torch.rand(R, I, generator=gen) < density
    keys = keys.masked_fill(inter, float("inf"))
    k = ((~inter).sum(1).to(torch.float32) * torch.tensor(ratio, dtype=torch.float32)).to(torch.int32)
    k[0], k[-1] = 0, I
    return keys, k


def time_k2(keys, k):
    """K2's time through its wrapper and as the launch alone, its plain
    version's, and its bound: the keys and k read once, the mask written
    once."""
    import torch

    from ganmf_tpu_torch.ops import _build
    from ganmf_tpu_torch.ops.select import smallest_k_mask_cuda
    from ganmf_tpu_torch.ops.topk import smallest_k_mask_reference

    lib = _build.load_library()
    R, I = keys.shape
    out = torch.empty(R, I, dtype=torch.bool, device=keys.device)
    stream = _build.stream_handle(keys.device)

    def launch():
        code = lib.ganmf_smallest_k_mask(keys.data_ptr(), k.data_ptr(), k.dtype == torch.int64,
                                         out.data_ptr(), R, I, stream)
        _build.check(lib, code, "chip_smoke: K2 launch")

    t = {
        "ms": cuda_ms(lambda: smallest_k_mask_cuda(keys, k)),
        "launch_ms": cuda_ms(launch),
        "plain_ms": cuda_ms(lambda: smallest_k_mask_reference(keys, k)),
        "library_ms": None,
    }
    t["bound_ms"], t["bound_by"] = bound(0, keys.numel() * 5 + k.numel() * k.element_size())
    return t


def phase_select(dev, card):
    import torch

    from ganmf_tpu_torch.ops.select import smallest_k_mask_cuda
    from ganmf_tpu_torch.ops.topk import smallest_k_mask_reference

    print("[5] K2 against its plain version (bitwise)")
    g = torch.Generator().manual_seed(SEED)
    cases = [
        ("LastFM user-mode masks", 1884, 17632, "uniform", 0.00279),
        ("LastFM item-mode masks", 17632, 1884, "uniform", 0.00279),
        ("LastFM user-mode batch", 2048, 17632, "uniform", 0.00279),
        ("LastFM item-mode batch", 18432, 1884, "uniform", 0.00279),
        ("ML-1M masks", 6040, 3706, "uniform", 0.0446),
        ("streamed batch", 128, 65536, "uniform", 0.00279),
        ("MAX_KERNEL_COLS", 5, 131072, "uniform", 0.00279),
        ("low-resolution keys", 512, 3706, "ties", 0.0446),
        ("negative keys and signed zeros", 512, 1000, "signed", 0.02),
    ]
    worst = 0.0
    for name, R, I, kind, density in cases:
        keys, k = (t.to(dev) for t in select_case(kind, R, I, g, density=density))
        got = smallest_k_mask_cuda(keys, k)
        want = smallest_k_mask_reference(keys, k)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        worst = max(worst, float(n_diff > 0))
        if n_diff:
            fail(f"K2 {name}: {n_diff} mask entries differ from the plain version")
        if not torch.equal(got.sum(1), k.long()):
            fail(f"K2 {name}: a row's count differs from its k")
        print(f"  {name}: [{R}, {I}] {kind}, bitwise equal, every row count = k")
    times = {}
    for R, I in ((2048, 17632), (1884, 17632), (17632, 1884)):
        keys, k = (t.to(dev) for t in select_case("uniform", R, I, g))
        t = times[f"[{R}, {I}]"] = time_k2(keys, k)
        print(f"  K2 at [{R}, {I}]: {t['ms']:.4f} ms through the wrapper, {t['launch_ms']:.4f} ms "
              f"the launch alone; plain (stable int64 sort + rank scatter) {t['plain_ms']:.4f} ms; "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{100 * t['bound_ms'] / t['launch_ms']:.1f}% of it  [{card}]")
    return worst, times


def phase_cfgan(dev, card, train, test):
    """CFGAN trained, served and evaluated on the card in both modes. Returns
    the fitted models."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import CFGAN
    from ganmf_tpu_torch.ops import select

    class TimedCFGAN(CFGAN):
        """Times each epoch (synchronized) and counts its K2 launches."""

        def _run_training_loop(self, *args, epoch_fn, **kwargs):
            self.epoch_log = []

            def timed(epoch):
                torch.cuda.synchronize()
                before, t0 = select.LAUNCHES, time.perf_counter()
                epoch_fn(epoch)
                torch.cuda.synchronize()
                self.epoch_log.append((time.perf_counter() - t0, select.LAUNCHES - before))

            return super()._run_training_loop(*args, epoch_fn=timed, **kwargs)

    models = {}
    for mode in ("user", "item"):
        print(f"[9] CFGAN {mode} mode: g_nodes={CFGAN_PARAMS['g_nodes']} d_nodes={CFGAN_PARAMS['d_nodes']} "
              f"d_layers={CFGAN_PARAMS['d_layers']} on {train.shape[0]} x {train.shape[1]}, "
              f"{CFGAN_EPOCHS} epochs")
        model = TimedCFGAN(train, mode=mode, seed=SEED, is_experiment=True, device=dev)
        ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
        returned = model.fit(**CFGAN_PARAMS, epochs=CFGAN_EPOCHS, validation_evaluator=ev,
                             freq=1, allow_worse=5)
        torch.cuda.synchronize()
        if len(model.epoch_log) != CFGAN_EPOCHS:
            fail(f"{mode}: {len(model.epoch_log)} epochs ran, not {CFGAN_EPOCHS} (fit returned {returned})")
        for e, (_, n) in enumerate(model.epoch_log, 1):
            if n < 1:
                fail(f"{mode}: epoch {e} did not launch K2")
        secs = [t for t, _ in model.epoch_log]
        print(f"  fit returned {returned}; epoch seconds {[round(t, 4) for t in secs]}, K2 launches per "
              f"epoch {[n for _, n in model.epoch_log]}; median of epochs 2-3: "
              f"{float(np.median(secs[1:])):.4f} s/epoch  [{card}]")
        for t in model.params.parameters():
            if not bool(torch.isfinite(t).all()):
                fail(f"{mode}: a parameter is not finite after training")

        recs = model.recommend(np.arange(5))  # the default cutoff, n_items - 1
        seen = np.ediff1d(train.indptr)[:5]
        for u, lst in enumerate(recs):
            if len(lst) != train.shape[1] - seen[u] or len(set(lst)) != len(lst):
                fail(f"{mode}: recommend(default cutoff) gave {len(lst)} items for user {u}")
        print(f"  recommend(users 0-4, default cutoff): {[len(r) for r in recs]} items; user 0 -> {recs[0][:10]} ...")

        t0 = time.perf_counter()
        idx, vals = model.serve_all(cutoff=20)
        serve_s = time.perf_counter() - t0
        if idx.shape != (train.shape[0], 20) or not np.isfinite(vals).all():
            fail(f"{mode}: serve_all returned {idx.shape} or non-finite scores")
        print(f"  serve_all(cutoff=20): {idx.shape[0]} users in {serve_s:.4f} s")

        t0 = time.perf_counter()
        results, text = ev.evaluateRecommender(model)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        for c in CUTOFFS:
            if not all(np.isfinite(v) for v in results[c].values()):
                fail(f"{mode}: a metric at cutoff {c} is not finite")
        n_eval = len(ev.usersToEvaluate)
        print(text, end="")
        print(f"  eval: {n_eval} users x {len(CUTOFFS)} cutoffs in {eval_s:.4f} s = "
              f"{n_eval / eval_s:.1f} users/s (warm call)  [{card}]")
        models[mode] = (model, ev)
    return models


def cfgan_epoch_inputs(mat):
    """(urm, weights, cfgan_epoch keywords, g_dims, d_dims) for one epoch at
    CFGAN_PARAMS on a training-orientation matrix, on the CPU."""
    import torch

    from ganmf_tpu_torch.models.gan_base import make_batches

    p = CFGAN_PARAMS
    n_rows, n_cols = mat.shape
    d_n, d_pad = make_batches(n_rows, p["d_batch_size"])
    g_n, g_pad = make_batches(n_rows, p["g_batch_size"])
    padded = max(d_pad, g_pad)
    urm = torch.zeros((padded, n_cols))
    urm[:n_rows] = torch.from_numpy(mat.toarray())
    w = torch.zeros(padded)
    w[:n_rows] = 1.0
    kw = dict(d_reg=p["d_reg"], g_reg=p["g_reg"], zr_ratio=p["zr_ratio"], zp_ratio=0.0,
              zr_coefficient=p["zr_coefficient"], scheme=p["scheme"],
              d_hidden_act=p["d_hidden_act"], g_hidden_act=p["g_hidden_act"],
              d_n_batches=d_n, d_batch=p["d_batch_size"], g_n_batches=g_n,
              g_batch=p["g_batch_size"], d_steps=p["d_steps"], g_steps=p["g_steps"])
    g_dims = [n_cols] + [p["g_nodes"]] * p["g_layers"] + [n_cols]
    d_dims = [2 * n_cols] + [p["d_nodes"]] * p["d_layers"] + [1]
    return urm, w, kw, g_dims, d_dims


def phase_cfgan_plain(dev, card, train, test, models):
    """The CFGAN path on the card against its plain path on the CPU."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import CFGAN
    from ganmf_tpu_torch.models import cfgan as pcf

    cpu = torch.device("cpu")
    p = CFGAN_PARAMS
    for mode in ("user", "item"):
        print(f"[10] CFGAN {mode} mode against the plain path on the CPU")
        model, ev = models[mode]
        urm, w, kw, g_dims, d_dims = cfgan_epoch_inputs(model._train_matrix())
        padded, n_cols = urm.shape
        d_n, g_n = kw["d_n_batches"], kw["g_n_batches"]
        u_zr = torch.rand((padded, n_cols), generator=torch.Generator().manual_seed(SEED + 1))
        runs = []
        for d in (dev, cpu):
            params = pcf.init_params(g_dims, d_dims, torch.Generator().manual_seed(SEED), d)
            d_opt = torch.optim.Adam(params.D.parameters(), lr=p["d_lr"], betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
            g_opt = torch.optim.Adam(params.G.parameters(), lr=p["g_lr"], betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
            uniforms = (u_zr.to(d), None)
            zr, _ = pcf.sample_negative_masks(urm.to(d), p["zr_ratio"], 0.0, p["scheme"], uniforms=uniforms)
            pcf.cfgan_epoch(params, d_opt, g_opt, urm.to(d), uniforms, w.to(d), w.to(d), **kw)
            runs.append((zr.cpu(), [t.detach().cpu() for t in params.parameters()]))
        if not torch.equal(runs[0][0], runs[1][0]):
            fail(f"{mode}: the card's ZR mask differs from the CPU's")
        n_g = 2 * (p["g_layers"] + 1)
        card_p, cpu_p = runs[0][1], runs[1][1]
        worst_g = adam_bound_check(mode, card_p[:n_g], cpu_p[:n_g], [(g_n, p["g_lr"])] * n_g)
        worst_d = adam_bound_check(mode, card_p[n_g:], cpu_p[n_g:], [(d_n, p["d_lr"])] * (len(card_p) - n_g))
        print(f"  one epoch from the same state and draws: masks bitwise equal "
              f"({int(runs[0][0].sum())} selected); largest parameter difference {max(worst_g, worst_d):.3e} "
              f"(G {worst_g:.3e} against bound {2.2 * p['g_lr'] * g_n:.3e}, "
              f"D {worst_d:.3e} against {2.2 * p['d_lr'] * d_n:.3e})")

        plain = CFGAN(train, mode=mode, seed=SEED, is_experiment=True, device=cpu)
        plain.config = dict(model.config)
        plain.params = pcf.params_from_jax([t.detach().cpu().numpy() for t in model.params.parameters()],
                                           p["g_layers"], cpu)
        card_out = model._full_generator_output()
        plain_out = plain._full_generator_output()
        got = card_out.cpu()
        if not torch.allclose(got, plain_out, rtol=GEN_RTOL, atol=GEN_ATOL):
            fail(f"{mode}: the card's generator output differs from the CPU's beyond rtol {GEN_RTOL}")
        print(f"  generator output [{got.shape[0]}, {got.shape[1]}]: max abs diff "
              f"{float((got - plain_out).abs().max()):.3e} (scale {float(plain_out.abs().max()):.3e}), "
              f"within rtol {GEN_RTOL} atol {GEN_ATOL}")

        plain._score_cache = got  # the card's scores: no BLAS rounding in what follows
        results, _ = ev.evaluateRecommender(model)
        presults, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(plain)
        worst_m = max(abs(results[c][m] - presults[c][m]) for c in CUTOFFS for m in results[c])
        if not worst_m <= SAME_SCORES_TOL:
            fail(f"{mode}: the evaluation differs from the CPU's on the same scores by {worst_m:.3e}")
        idx, _ = model.serve_all(cutoff=20)
        pidx, _ = plain.serve_all(cutoff=20)
        if not np.array_equal(idx, pidx):
            fail(f"{mode}: serve_all ids differ from the CPU's on the same scores")
        print(f"  on the card's scores: every metric within {worst_m:.3e} of the CPU path, "
              f"serve_all ids equal")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"[1] CUDA: {torch.cuda.device_count()} device(s); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    card = card_line()
    print(f"[2] card: {card}")

    from ganmf_tpu_torch.ops import _build, scorer, select
    from ganmf_tpu_torch.utils.device import cuda_device

    dev = cuda_device()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[3] built and loaded {_build.library_path().name} in {time.perf_counter() - t0:.2f} s")
    print("\n".join(ptxas_lines(_build.ptxas_report())))

    k1_err, fused, wide_err, wide = phase_kernel(dev, card)
    k2_err, k2_times = phase_select(dev, card)

    train, test = ml1m_split()
    # count only the main path's launches
    scorer.LAUNCHES = scorer.WIDE_LAUNCHES = scorer.MERGE_LAUNCHES = 0
    phase_slice(dev, card, train, test)
    wide_launches = scorer.WIDE_LAUNCHES
    k1_launches = scorer.LAUNCHES - wide_launches  # the fused kernel's
    merge_launches = scorer.MERGE_LAUNCHES
    if k1_launches == 0 or wide_launches == 0 or merge_launches == 0:
        fail(f"the GANMF path launched K1's fused kernel {k1_launches} times (its merge pass "
             f"{merge_launches} times) and its wide pair {wide_launches} times")

    # GANMF's training path, its counts read alone
    scorer.LAUNCHES = scorer.WIDE_LAUNCHES = scorer.MERGE_LAUNCHES = 0
    ganmf_models = phase_ganmf_train(dev, card, train, test)
    train_wide = scorer.WIDE_LAUNCHES
    train_fused = scorer.LAUNCHES - train_wide
    train_merge = scorer.MERGE_LAUNCHES
    if train_fused == 0 or train_wide == 0:
        fail(f"GANMF's training path launched K1's fused kernel {train_fused} times and its wide "
             f"pair {train_wide} times")
    phase_ganmf_train_plain(dev, card, train, test, ganmf_models)
    del ganmf_models

    train, test = lastfm_split()
    select.LAUNCHES = 0
    models = phase_cfgan(dev, card, train, test)
    k2_launches = select.LAUNCHES
    if k2_launches < 2 * CFGAN_EPOCHS:
        fail(f"the CFGAN path launched K2 {k2_launches} times, under once per epoch")
    phase_cfgan_plain(dev, card, train, test, models)

    eval_shape, *other_shapes = fused
    wide_shape, *wide_others = wide
    k2_shape, *k2_others = k2_times
    # K1 carries two GANMF paths, serving (phase 6) and training (phase 7, its
    # early-stopping evaluations and recommend on the trained model): its
    # launches are the sum of the two runs, each counted alone
    print(json.dumps({"kernels": [
        {
            "name": "masked_topk_scores (K1, fused kernel and merge pass, k <= 64)",
            "route": "cuda",
            "source": "ganmf_tpu_torch/csrc/masked_topk.cu",
            "replaces": "ganmf_tpu/ops/pallas_scorer.py:26",
            "launches": k1_launches + train_fused,
            "launches_by_path": {"GANMF serving": k1_launches, "GANMF training": train_fused},
            "merge_launches": merge_launches + train_merge,
            "max_abs_err": k1_err,
            "shape": eval_shape,
            **fused[eval_shape],
            "other_shapes": [{"shape": name, **fused[name]} for name in other_shapes],
        },
        {
            "name": "masked_topk_scores (K1, wide pair, k > 64)",
            "route": "cuda",
            "source": "ganmf_tpu_torch/csrc/masked_topk.cu",
            "replaces": "ganmf_tpu/ops/pallas_scorer.py:26",
            "launches": wide_launches + train_wide,
            "launches_by_path": {"GANMF serving": wide_launches, "GANMF training": train_wide},
            "max_abs_err": wide_err,
            "shape": wide_shape,
            **wide[wide_shape],
            "other_shapes": [{"shape": name, **wide[name]} for name in wide_others],
        },
        {
            "name": "smallest_k_mask (K2)",
            "route": "cuda",
            "source": "ganmf_tpu_torch/csrc/select.cu",
            "replaces": "ganmf_tpu/ops/pallas_select.py:39",
            "launches": k2_launches,
            "max_abs_err": k2_err,
            "shape": k2_shape,
            **k2_times[k2_shape],
            "other_shapes": [{"shape": name, **k2_times[name]} for name in k2_others],
        },
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
