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
   mode's and recommend's shapes (B=5 and B=1 at cutoff 20) and at
   DisGANMF's (B=1884 K=95 I=17632), PureSVD's (B=3024 K=41 I=3706) and
   IALS's (B=1884 K=130 I=17632) evaluation blocks, with the item splits its
   wrapper launched, the wide pair at recommend's default cutoff (B=5 and
   B=1, and DisGANMF's, PureSVD's and IALS's B=5) and at k=100 above the
   fused kernel's cutoffs (B=3024, I=3706 and B=64, I=17632);
5. hold K2 (exact-k row selection) against its plain PyTorch version on the
   card, bitwise, at CFGAN's mask shapes (user and item mode, and the
   padded batches), the streamed batch shape, the widest row, CAAE's G-phase
   shape (negated Gumbel keys, +inf on seen items, k = int(n_nonint * S)),
   with heavy ties, negative keys, signed zeros and rows with k = 0 and
   k = I; print its time through the wrapper and the launch alone, its plain
   version's and its bound at [2048, 17632], [1884, 17632], [17632, 1884]
   and [32, 3706] (median of 20 runs);
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
11. train DisGANMF at the repo's tuned LastFM params (num_factors=95,
    d_layers=1, d_nodes=996, relu, batch_size=64;
    runs/tuning/DisGANMF_user_LastFM/best_params.pkl) for 3 epochs with early
    stopping every epoch on the LastFM-shaped split, in user and then item
    mode; check that those evaluations launched K1's fused kernel and that
    recommend at the default cutoff launched its wide pair; print seconds per
    epoch, then evaluate, recommend (cutoff 20 and default), recommend_fused
    and serve_all; hold one epoch against the CPU (parameters within the Adam
    bound, losses finite and within rtol 1e-4) over the epoch's first 8
    minibatches of each phase (the model is chaotic at these params: a
    one-ulp change moves a whole epoch past the bound), and the trained
    model's metrics against its CPU copy (1e-5);
12. fit PureSVD at its ML-1M best params (num_factors=41;
    experiments/PureSVDRecommender__1M/best_params.pkl) on the ML-1M-shaped
    split with four users made cold (empty training rows); print the fit's
    seconds, evaluate, recommend (cutoff 20 and default, cold users empty),
    recommend_fused and serve_all through K1; hold the fit against the CPU's
    from the same Omega (scores within 2e-4 of their scale) and the model's
    metrics against its CPU copy (1e-5);
13. train CAAE at the reference's ML-1M best params (d_steps=10, g_layers=5,
    g_units=100, num_factors=43, d_bsize=9216, lr=1e-3, beta=0.1;
    scripts/caae_dphase_roofline.py:54-55) for 3 epochs with early stopping
    every epoch on the ML-1M-shaped split; check that K2 drew the G phase's
    masks every epoch; print seconds per epoch, then evaluate, recommend,
    recommend_fused and serve_all; hold one epoch against the CPU from the
    same state and draws (the D-phase negatives drawn from each device's
    tables, every tensor within 1% of the distance the epoch moved it) and
    the evaluation on the card's scores against the CPU (1e-6);
14. fit TopPop on the ML-1M-shaped split; evaluate, recommend (cutoff 20 and
    default), recommend_fused and serve_all by the dense route (no kernel);
    hold the lists against the CPU (ids equal) and the metrics (1e-6);
15. IALS: run_best("LastFM", "ALS") with the committed best params
    (experiments/IALSRecommender__LastFM/best_params.pkl: K=130, alpha 38.6,
    80 epochs, the published width and depth) on a LastFM-shaped five-way
    split under build/chip_smoke; print seconds per epoch, CG iterations per
    chunk, the host reads of CG's exit test and the test metrics, and check
    that the test evaluation launched K1. Fit at the same params with early
    stopping (epochs cut to 10, a validation every 5; the validations launch
    K1's fused kernel), then evaluate, recommend (the wide pair at the
    default cutoff), recommend_fused and serve_all. Fit with urm_storage
    "csr" in padded and flat form for 2 epochs each, within rtol 2e-4 / atol
    2e-6 of the dense fit on the card. One dense epoch at bench.py's ML-1M
    configuration (K=50, alpha=5) from the same initial factors on the card
    and the CPU: every factor row within 1e-4 of its norm (IALS_ROW_GAP); the
    card's factors' metrics within 1e-5 on the CPU;
16. the tuner (RecSysExp) on an ML-1M-shaped five-way split under
    build/chip_smoke: ALS (epochs Categorical([10])) with 3 fresh evaluations
    and a resume to 5, whose 2 points the GP proposes without scikit-learn;
    GANMF (epochs Categorical([3])) with 2; check every artifact, that the
    validations launched K1 and that run_best trains from the tuned
    best_params.pkl; read every committed experiments/*/checkpoint.pkl
    through the port's load and print its trial count and best value;
17. ItemKNN-CF on the LastFM-shaped split at the JAX package's defaults
    (topK=50, shrink=100) with the cosine, asymmetric and euclidean
    similarities: the Gram on the card bitwise equal to the CPU's, also by
    the streamed route (``_DENSE_A_BYTE_LIMIT`` lowered) with its wall; W
    from it within rtol 1e-6 of the CPU's, ids equal but at near ties; the
    similarity route's ranking (``masked_topk_matmul``) of 256 users on the
    card against the CPU's from the same W and profile rows, values within
    rtol 1e-6 and ids equal but at near ties; the fit's wall and the
    evaluation's users/s by the similarity route;
18. P3alpha: run_best("LastFM", "P3Alpha") at the committed params
    (experiments/P3alphaRecommender__LastFM/best_params.pkl: topK=462,
    alpha=0.642) on phase 15's LastFM-shaped five-way split, on the card and
    on the CPU: the training and testing seconds, the two W within rtol 1e-5
    but at near ties, the similarity route's ranking of 256 users held as in
    phase 17 on the card's W, and the metrics' largest gap to the CPU run;
19. SLIM-BPR at the committed LastFM params
    (experiments/SLIM_BPR_Recommender__LastFM/best_params.pkl: topK=761, 85
    epochs, symmetric, adagrad): one epoch on the card against the CPU from
    the same state and triples (W within 1e-5), then run_best's 85
    epochs, with the epoch wall (median, min, max) and the prunes' walls;
20. RecSysExp on phase 16's ML-1M-shaped five-way split: 2 SLIM-BPR trials
    (epochs [10], early stopping) and 2 ItemKNN trials with the cosine
    similarity;
21. PureSVD (K=41) with the "itemKNN" cold-user estimate on the ML-1M-shaped
    split with cold users: the estimate's build timed; the model ranked by
    the dense route (no K1 launch) with metrics within 1e-5 of a CPU copy's.
    The estimate itself scores no user, in the JAX package as here (the cold
    and warm masks come from one URM; ROADMAP section 3): this is checked and
    printed, and the scores are the factor product's. Phases 17-21 launch
    neither K1 nor K2 (their counts are set to 0 before each and read after);
22. the MF-SGD family (BPR, FunkSVD, AsySVD) at the JAX fit's defaults (K=10,
    batch 256, adagrad, lr 1e-3, 780 chunks an epoch) on the ML-1M-shaped
    split, 5 epochs with a validation through K1's fused kernel every epoch,
    then evaluated and served (the wide pair at the default cutoff); BPR with
    urm_storage "csr": the same draws as the dense storage, 2 epochs within
    1e-5 of the dense fit; one BPR and one AsySVD epoch on the card against
    the CPU from the same state and draws (within 1e-5, against a flipped
    update's 2e-3); the draws and an epoch under
    set_sync_debug_mode("error");
23. IRGAN at the JAX fit's defaults on the LastFM-shaped split (290 chunks
    an epoch): 2 pretraining and 3 adversarial epochs with a validation
    through K1 every epoch, evaluated and served; the first 8 chunks of each
    epoch kind on the card against the CPU from the same Gumbel noise, every
    table within 1% of the distance it moved, the flipped negative draws
    counted;
24. NMF at its defaults (K=100, 200 iterations) on the ML-1M-shaped split,
    evaluated and served through K1; 5 iterations card against CPU from one
    init (within 1e-4 of the largest factor); a PredefinedList from its
    serve_all (lists equal to recommend's, PRECISION / RECALL / MAP / NDCG
    of its lists within 1e-5 of NMF's evaluation, serve_all raises). EASE-R
    without topK on the LastFM-shaped split (a 1.24 GB W, ~13 TFLOP), timed
    and evaluated by the similarity route; with topK 100 at the ML-1M shape,
    card against CPU (the pruned W within 1e-4 of max|B|, 256 users' top 50
    equal but at near ties). EASE-R launches neither K1 nor K2;
25. the studies on phase 16's ML-1M-shaped five-way split: describe, the
    feature-matching sweep (11 alphas) and its cosine study at GANMF's ML-1M
    best params, the latent-factor study (K 10-250 for PureSVD, ALS and
    GANMF) and the profile-length study, GANMF's epochs cut to 2; the
    profile-length bins of a PureSVD model averaged to the evaluator's
    MAP@20 (1e-5). Phases 22-25 read K1's and K2's counts per path: K1's
    fused kernel above 0 and K2 at 0 on each, but EASE-R's, where both are 0;
26. the keyed per-row draw of CFGAN's csr storage (csrc/keyed.cu) against its
    plain version, bitwise, and K2 on keys drawn so, bitwise, at the csr
    minibatch shapes [128, 17632] and [1024, 17632] (D and G batches in user
    mode on the LastFM-shaped split), [1024, 1884] (item mode) and
    [1024, 26744] (ML-20M's width); each timed beside its plain version and
    its bound (the keyed draw's: its output written once);
27. CFGAN with urm_storage="csr" at the published LastFM params, both modes:
    2 epochs with early stopping (K2 and the keyed draw launched once a
    minibatch for each mask the phase draws: the ZR scheme draws one a G
    minibatch), epoch walls, the fit's peak device memory beside a dense
    fit's, the last G minibatch's masks bitwise card against CPU, one csr
    epoch card against CPU within the Adam bound, and the trained model's
    metrics (streamed scoring) within 1e-5 of a CPU copy's;
28. one csr epoch at the same params on a 0/1 matrix of ML-20M's shape
    (138,493 x 26,744, about 20M entries, drawn on the card from the seed),
    whose dense storage would not fit the card: the epoch's wall and the
    peak device memory, which must stay under the card's;
29. the column-blocked similarity build (cosine, topK 50, shrink 100) of a
    25,000 x 65,536 0/1 matrix (its float32 A passes _DENSE_A_BYTE_LIMIT and
    its 17 GB Gram _GRAM_BYTE_LIMIT), by the int8 form and by the scatter
    form, each timed; the two equal, and 512 target columns bitwise equal
    to a float64 product of A with those columns, normalized and ranked
    with ties to the lowest id;
30. the phase-7 GANMF model (user mode) evaluated with a diversity object
    (its ItemKNN cosine W) and by EvaluatorNegativeItemSample (100 sampled
    negatives a user): the dense route, every metric within 1e-5 of a CPU
    copy's;
31. one CAAE epoch at the reference's ML-1M best params with
    d_scatter="dedup", twice (bitwise equal) and against "direct" (every
    tensor within 1% of the distance it moved), timed. Phases 27-31 read
    each path's counts: K2 and the keyed draw above 0 on the csr paths with
    K1 at 0, no kernel on phases 29-30, K2 once a G step on phase 31;
32. the host engine: its native library built with g++ under build/, and its
    parser equal to the Python path on a generated ratings file, both timed;
33. GANMF on a mesh (ganmf_tpu_torch.parallel) of one rank over NCCL on the
    card: at its ML-1M best params on the ML-1M-shaped split, in user and
    then item mode, one epoch and the evaluation with the mesh plan, held
    against the one-card path from the same state and permutation
    (parameters within phase 8's Adam bound, losses within rtol 1e-4, every
    metric within 1e-5), K1 launched by the mesh evaluation; then K1 on an
    item shard at phase 34's shape ([1512, 250] x [1853, 250], k=50, its ids
    offset by 1853) against its plain version, timed beside its bound;
34. the same fit and evaluation (user mode) on a (data 2, model 2) mesh of
    4 ranks that share the card over gloo, started as subprocesses of this
    script (``--mesh-rank``), each within its time limit: each rank ranks
    its 1853-item shard through K1; the gathered parameters, losses and
    metrics held against phase 33's one-card path. gloo stages its
    collectives through the host, so the seconds printed are no multi-card
    measurement;
35. DisGANMF (the tuned LastFM params: K=95, d_nodes=996; I=17,632, so on a
    2-way model axis D's [17633, 996] first kernel is replicated), CFGAN (its
    published LastFM params, dense and then csr storage) and CAAE (the
    reference's ML-1M best params, d_scatter="dedup") on a mesh of one rank
    over NCCL on the card: one epoch and the evaluation each with the mesh
    plan, held against the one-card path from the same state (Adam
    parameters within phase 8's bound, CAAE's tensors within 1% of the
    distance they moved, every metric within 1e-5), CFGAN's K2 masks
    (dense and csr) bitwise the one-card path's; K2 launched by the CFGAN and
    CAAE fits, the keyed draw by the csr fit and K1 by DisGANMF's evaluation;
    then K2 at a data rank's shapes on phase 36's mesh, bitwise its plain
    version, timed;
36. the same fits and evaluations on a (data 2, model 2) mesh of 4 ranks
    that share the card over gloo (``--gan-mesh-rank``): the gathered
    parameters held against phase 35's one-card fit with the same bounds,
    the mesh evaluation's metrics within 1e-5 of a one-card evaluation of
    the same parameters (their gap to phase 35's fit is printed: a ranking
    metric moves with rounding-level parameter differences at near ties),
    the launches of each kernel above 0 where phase 35 needs them; gloo
    stages its collectives through the host, so the seconds printed are no
    multi-card measurement;
37. a world of one rank over NCCL on the card (comm.initialize with
    world_size 1, make_mesh()): IALS at the committed LastFM params (K=130)
    on the LastFM-shaped split, dense and then csr with the flat route
    forced, MF-SGD BPR at the JAX fit's defaults on the ML-1M-shaped split
    (its epoch cut to MESH_MF_SGD_SAMPLES draws, a quarter of the default)
    and SLIM-BPR at phase 19's params, one epoch each with the plan, held
    against the one-card fit from the same state and draws (IALS dense
    within rtol 2e-4 / atol 2e-6, flat csr bitwise, MF-SGD within 1e-5,
    SLIM-BPR's W within 1e-5); IALS's and MF-SGD's evaluations on the plan
    launch K1 and their metrics are within 1e-5 of the one-card evaluation;
    then ``ops.distchol.ease_r_topk_sharded`` on the plan at ML-1M's 3706
    items (l2_norm 1e3, topK 100) against the one-card EASE-R W (rtol 1e-4
    plus 1e-5 of max|B|), both timed;
38. the same fits on a (data 2, model 2) mesh of 4 ranks that share the card
    over gloo (``--baseline-mesh-rank``), held against phase 37's one-card
    fits (IALS dense: each row within 1e-4 of its norm, the Gram being
    summed over two item shards; the others with phase 37's bounds), K1
    above 0 on the IALS and MF-SGD evaluations, then EASE-R through
    ``fit(mesh_plan)`` (the distributed Cholesky over model 2) against phase
    37's one-card W and ItemKNN cosine on the LastFM-shaped split through the
    sharded similarity build against a one-card build (the same entries,
    values within 1e-6 of the largest); gloo stages its collectives through
    the host, so the seconds printed are no multi-card measurement;
39. the ML-20M stand-in (ganmf_tpu_torch.data.synthetic: 138,493 users x
    26,744 items, ~19M ratings, written from its seed under build/chip_smoke),
    parsed by the host engine (the Python parser fails the phase), reindexed
    and split into the implicit five-way split and the explicit one, each
    wall printed; then the stages of ganmf_tpu_torch/cli/scale20m.py at
    their settings on the full user base and catalog, the iterative fits cut
    to one epoch: TopPop, PureSVD (K=128, the resident bf16 route;
    evaluation and serve_all), ItemKNN cosine (topK 300; JAX's resident
    bf16 Gram timed alone with its share of the bf16 peak, then beside the
    streamed float32 Gram in turns, G bitwise equal; evaluated through W's
    bf16 planes and, the same model, through the float32 product; its
    MAP@20 within 1e-4 of SCALE20M.json's), IALS csr (K=96, flat
    CSR for the items; a fit of one epoch and one timed _run_epoch), GANMF
    csr (K=128, E=128, batch 512), IALS linear and FunkSVD csr on the
    explicit split (RMSE finite), and one CFGAN csr epoch at its published
    LastFM params (K2 and the keyed draw once a G minibatch), each stage's
    route, walls, eval users/s and peak device memory printed; PureSVD's and
    ItemKNN's MAP@20 above TopPop's, every evaluation over all of
    usersToEvaluate, K1 launched, its wide pair not; SCALE20M.json's TopPop
    MAP@20 printed beside the port's; K1 at the evaluation block (B=3648,
    K=128, k=50) and serve_all's (B=2048, k=20) on PureSVD's factors and
    seen rows against its plain version, and K2 at [1024, 26744] on the
    stand-in's rows, bitwise, each timed beside its bound;
40. JAX's bf16 similarity routes: on the LastFM-shaped split, the Gram of
    0/1 data on the dense, resident, streamed, column-blocked scatter and
    one-rank NCCL sharded routes (reached by lowering the limits) bitwise
    the float32 product's, every product a bf16 one with a float32 output,
    and the dense Gram's bf16 and float32 products timed in turns; then on a
    4,000 x 24,000 binary split (past _SIM_SPLIT_MIN_ITEMS) ItemKNN and
    UserKNN cosine: a block of 512 users through W's bf16 planes against the
    CPU's plain version and against the card's float32 product (values and
    ids by K1's rules), both products and both rankings timed, and the whole
    evaluation through each;
41. the graft entry points (ganmf_tpu_torch/graft.py): entry()'s losses on
    the card, eagerly and under torch.compile, each within rtol 1e-5 of the
    CPU's, then dryrun_multichip(8) as 8 gloo ranks sharing the card, its
    wall; no kernel of the repo launched in phases 40-41;
42. training past the card's memory (ganmf_tpu_torch/cli/beyond_hbm.py, the
    counterpart of scripts/beyond_hbm_demo.py): on the JAX script's
    synthetic URM at 262,144 x 131,072 with 100 draws a user (about 26.2M
    interactions; 128 GiB as a dense float32 URM, past the card's 80 GB),
    one csr epoch each of GANMF, CFGAN and IALS through fit at the script's
    settings: each fit's walls, storage and peak device memory, which must
    stay under 16 GiB (a bool [U, I] mask alone would take 32), its tensors
    finite; K2 and the keyed draw launched once a CFGAN G minibatch (2048
    each, K2 on its streamed-row route) and by no other fit; then the keyed
    draw and K2 on CFGAN's first G minibatch, [128, 131072], each bitwise its
    plain version and timed beside its bound, with the rows' tied keys and
    K2's tie cuts counted (DisGANMF and MF-BPR: scripts/torch_beyond_hbm.py);
43. serving latency (ganmf_tpu_torch/cli/serving_latency.py, the counterpart
    of scripts/serving_latency.py): p50 and p99 of recommend(cutoff=20) at
    b=1 (200 calls) and b=32 (100 calls) for PureSVD (K=50) and GANMF (K=64,
    emb_dim 128, 2 epochs) on the ML-1M- and LastFM-shaped splits, every
    timed list equal to an untimed call's, K1's fused kernel launched on
    every timed call and its wide pair never; then K1 fused at each model's
    B=1 and B=32 shapes against its plain version, timed beside the library
    composition and its bound (ItemKNN: scripts/torch_serving_latency.py);
44. print one JSON line with every kernel's launches (by path), error, times
    and bound (K1's two forms as entries of their own, and the keyed draw,
    which replaces no TPU kernel), then the card line, then the result line.

Imports nothing of JAX. It needs the repository checkout: alone it fails.
"""

import gc
import json
import os
import re
import shutil
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
BF16_FLOPS = 989e12  # dense bf16 products on the tensor cores
# CFGAN's published best params, user mode on LastFM (scripts/parity_check.py:46-54)
CFGAN_PARAMS = dict(
    g_nodes=1024, g_layers=1, g_hidden_act="tanh",
    d_nodes=4, d_layers=5, d_hidden_act="linear",
    scheme="ZR", zr_ratio=0.4515475140394092, zr_coefficient=0.05049684341469494,
    d_batch_size=128, g_batch_size=1024,
    d_lr=1e-4, g_lr=0.00018640602403973558, d_reg=1e-4, g_reg=1e-4, d_steps=1, g_steps=1,
)
CFGAN_EPOCHS = 3
CFGAN_DENSE_PEAKS = {}  # phase 9's fits' peak device memory, by mode
# GANMF's published best params on ML-1M (bench.py:42-46); g_reg stays 0
GANMF_PARAMS = dict(
    num_factors=NUM_FACTORS, emb_dim=EMB_DIM, batch_size=64, m=10,
    d_lr=1e-4, g_lr=0.0001653241474168571, d_reg=1e-4, recon_coefficient=0.01,
)
GANMF_EPOCHS = 3
# the repo's tuned DisGANMF params, user mode on LastFM
# (runs/tuning/DisGANMF_user_LastFM/best_params.pkl, its epochs cut to 3)
DISGANMF_PARAMS = dict(
    num_factors=95, d_layers=1, d_nodes=996, d_hidden_act="relu", batch_size=64,
    d_lr=0.00379028764686026, g_lr=0.0005006548473852376, d_reg=2.5412502795903484e-05,
    recon_coefficient=0.2507022478602805,
)
DISGANMF_EPOCHS = 3
# DisGANMF's epoch, card against CPU, is held over its first minibatches: at
# these params a one-ulp change of D's first kernel moves half the elements
# of a whole epoch's parameters past 1% of lr, but stays under 2e-6 over 8
# minibatches of each phase (a CPU measurement on a LastFM-shaped split with
# 8000 items)
DISGANMF_HELD_BATCHES = 8
# PureSVD's ML-1M best params (experiments/PureSVDRecommender__1M/best_params.pkl)
PURESVD_PARAMS = dict(num_factors=41)
SVD_COLD_USERS = [3, 2048, 4100, 6039]  # training rows emptied: K1's cold mask
# each float32 fit lies within 3.5e-5 of the largest score of the float64 fit
# on this split (a CPU measurement), so two fits lie within 2e-4 of it
SVD_SCORE_RTOL = 2e-4
# the reference's CAAE best params on ML-1M (scripts/caae_dphase_roofline.py:54-55);
# the rest at fit's defaults
CAAE_PARAMS = dict(d_steps=10, g_layers=5, g_units=100, num_factors=43, d_bsize=9216, lr=1e-3, beta=0.1)
CAAE_EPOCHS = 3
CAAE_S = 0.3  # fit's default share of the non-interactions in Nu
# one CAAE epoch, card against CPU: every tensor within this share of the
# distance the epoch moved it (atomics reorder the D phase's duplicate-row
# sums; a draw at the edge of a bucket or of K2's k-th key may flip)
CAAE_MOVE_SHARE = 1e-2
LOSS_RTOL = 1e-4  # the epoch's mean losses, card against CPU
# the evaluation on the card and on the CPU from the same score block: only
# the order of float32 metric sums differs
SAME_SCORES_TOL = 1e-6
# generator output, card against CPU, same parameters: float32 sums in
# another order; atol covers outputs near zero (about 1e-5 of their scale)
GEN_RTOL, GEN_ATOL = 1e-5, 1e-6
# IALS at the committed LastFM params (K=130, 80 epochs), read by run_best
# from BP_DIR/IALSRecommender__LastFM/best_params.pkl
BP_DIR = "experiments"
IALS_K = 130  # its num_factors
IALS_ES_EPOCHS, IALS_CSR_EPOCHS = 10, 2  # cuts from 80 for the early-stopping and csr fits
IALS_BENCH_PARAMS = dict(num_factors=50, alpha=5.0)  # bench.py's ML-1M IALS row
# IALS storages on the card against each other: the JAX package's csr-vs-dense
# tolerance (tests/test_parallel.py:284-289); the forms run the same products
IALS_RTOL, IALS_ATOL = 2e-4, 2e-6
# IALS, card against CPU: each factor row within this share of its norm. CG
# stops at a residual of 1e-5 of ||b||, so two summation orders leave a
# solution up to about cond(A) x 1e-5 apart, and near-zero entries miss an
# elementwise atol (the port against JAX at this configuration on the CPU:
# rows within 6.9e-6, 267 of 302000 entries past rtol 2e-4 / atol 2e-6)
IALS_ROW_GAP = 1e-4
# the tuner: ALS with epochs Categorical([10]) in place of [300], 3 fresh
# evaluations and a resume to 5 (the GP proposes the last 2); GANMF with
# epochs Categorical([3]), 2 evaluations
TUNER_ALS_EPOCHS, TUNER_ALS_EVALS = 10, (3, 5)
TUNER_GANMF_EPOCHS, TUNER_GANMF_EVALS = 3, 2
SCRATCH = "build/chip_smoke"  # splits, logs and results of the new phases (gitignored)
# the similarity family (phases 17-21): float32 products and tiled_topk, no
# kernel of the repo. ItemKNN-CF at the JAX package's defaults (topK=50,
# shrink=100) in three families; on 0/1 data the Gram is exact, and W from
# the same Gram is held within SIM_RTOL (exp, log, pow and the ranking's
# near ties are another library's on the CPU)
ITEMKNN_TOPK, ITEMKNN_SHRINK = 50, 100
ITEMKNN_SIMILARITIES = ("cosine", "asymmetric", "euclidean")
SIM_RTOL = 1e-6
# users whose similarity-route ranking is held card against CPU (the CPU's
# product for them is 2 x 256 x 17632^2 = 0.16 TFLOP)
SIM_RANK_USERS = 256
# P3alpha's run_best: the card's metrics against a CPU run of the same
# run_best; the walk's float32 sums meet many exact ties on a sparse
# synthetic split, which the two summation orders may break either way, so
# the gap is printed and held only to this sanity bound
P3_METRIC_BOUND = 1e-3
# P3alpha's similarity-route ranking, card against CPU from the same W:
# real-valued W, float32 sums of a profile's entries in another order
P3_RANK_RTOL = 1e-5
# the tuner on the similarity family: SLIM-BPR's epochs Categorical([1500])
# cut to [10] (early stopping validates every 5), 2 trials each
SIM_TUNER_SLIM_EPOCHS, SIM_TUNER_EVALS = 10, 2
# one SLIM-BPR epoch, card against CPU from the same state and triples: only
# index_add_'s atomic order of duplicate rows differs, a few ulps of W's
# entries (7.451e-9 measured on an H100); an update with a flipped sign
# moves an entry by about lr (0.054)
SLIM_EPOCH_ATOL = 1e-5


# the MF-SGD family (phase 22) at the JAX fit's defaults (ganmf_tpu/models/mf_sgd.py:173-190:
# K=10, batch 256, adagrad, lr 1e-3, max(n_users, nnz // 4) samples an epoch), epochs cut from 300
MF_SGD_PARAMS = dict(num_factors=10, batch_size=256, learning_rate=1e-3, sgd_mode="adagrad")
MF_SGD_EPOCHS, MF_SGD_CSR_EPOCHS = 5, 2
# one MF-SGD epoch, card against CPU from the same state and draws: only
# index_add_'s atomic order of a chunk's duplicate rows differs; an update
# with a flipped sign moves an entry by about 2 x lr (AdaGrad's first steps
# are about lr each), 100 times this gate
MF_EPOCH_ATOL = 1e-5
# IRGAN (phase 23) at the JAX fit's defaults (ganmf_tpu/models/irgan.py:203-221),
# epochs cut from 100 + 300; its first chunks of each epoch kind held card
# against CPU, every table within this share of the distance it moved, or
# within IRGAN_ULPS ulps of its largest entry where it moved less (a table
# the kind does not train). At the default G_lr of 1e-4 the G pass moves Gu
# by 3.5e-8 in 8 chunks, about the ulp floor, so the adversarial chunks are
# held at IRGAN_HELD_G_LR, where G's tables move hundreds of times further;
# every table that moved must have moved IRGAN_MOVE_OVER_GATE times its gate
# or more, so that the gate can see a wrong update
IRGAN_PRETRAIN_EPOCHS, IRGAN_EPOCHS = 2, 3
IRGAN_HELD_CHUNKS, IRGAN_HELD_G_LR = 8, 0.05
IRGAN_MOVE_SHARE, IRGAN_ULPS, IRGAN_MOVE_OVER_GATE = 1e-2, 8, 10
# NMF (phase 24) at the JAX fit's defaults (ganmf_tpu/models/extras.py:53);
# NMF_HELD_ITERS updates card against CPU from one init, W and H within
# NMF_RTOL of their largest entry (float32 products in another order)
NMF_PARAMS = dict(num_factors=100, n_iter=200)
NMF_HELD_ITERS, NMF_RTOL = 5, 1e-4
# EASE-R (phase 24) at the JAX fit's l2_norm; no topK is published, so the
# pruned fit keeps the reference's similarity_matrix_topk default of 100. The
# card's pruned W against the CPU's within EASE_W_TOL of max|B| (two Cholesky
# orders differ by about cond(G) x eps of it)
EASE_L2, EASE_TOPK, EASE_W_TOL = 1e3, 100, 1e-4
# the studies (phase 25): GANMF's epochs cut from its best params' 300
STUDY_GANMF_EPOCHS = 1
# CFGAN's csr storage (phases 26-28): the minibatch shapes of its keyed draws
# and K2 (its G batch in each mode on the LastFM-shaped split, a G batch at
# ML-20M's width, and the D batch in user mode, where the ZP and PM schemes
# draw a PM mask: the published ZR scheme draws none there), the fits' epochs
# at LastFM's shape, and ML-20M's shape (SCALE20M.json) with ~20M entries
CSR_SHAPES = ((1024, 17632, "G batch, user mode"), (1024, 1884, "G batch, item mode"),
              (1024, 26744, "G batch at ML-20M's width"),
              (128, 17632, "D batch, user mode: the ZP and PM schemes' PM mask, off the published path"))
CFGAN_CSR_EPOCHS = 2
ML20M_SHAPE, ML20M_NNZ = (138493, 26744), 20_000_000
# the column-blocked similarity (phase 29): 65,536 items as the JAX package's
# 64k build (scripts/simbuild_65k.py); 25,000 rows, so that the dense float32
# A (6.55 GB) passes _DENSE_A_BYTE_LIMIT as JAX's rule requires before the
# Gram's 17 GB sends it to the column-blocked build (20,000 rows stay dense)
COLBLOCK_SHAPE, COLBLOCK_DENSITY = (25000, 65536), 0.005
# the evaluator extras (phase 30): sampled negatives a user, the usual 100
EVAL_NEGATIVES = 100
# CAAE dedup (phase 31): the D steps of the epoch run twice for determinism
DEDUP_REPEAT_D_STEPS = 2
HOST_PARSE_LINES = 200_000  # the host engine's parser (phase 32)
# the mesh phases (33-34): GANMF's fits on a mesh at its ML-1M best params,
# one epoch each; phase 34's mesh of 4 ranks that share the one card over
# gloo, each rank with its own time limit
MESH_EPOCHS = 1
MESH_GLOO = dict(n_data=2, n_model=2)
MESH_RANK_TIMEOUT = 300
MESH_SHARD_ROWS = 1512  # a data rank's part of the 3024-row evaluation block
GAN_MESH_RANK_TIMEOUT = 600  # phase 36's ranks: four fits and evaluations each


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _counter(name: str) -> int:
    """A counter of the port (ganmf_tpu_torch/utils/profiling.py): 0 before
    its first count."""
    from ganmf_tpu_torch.utils import profiling

    return profiling.counters().get(name, 0)


def _reset_counters() -> None:
    from ganmf_tpu_torch.utils import profiling

    profiling.reset_counters()


def _k3_launches(what: str, by_path: dict) -> int:
    """K3's launches on a path whose counts were set to 0 just before it,
    kept in ``by_path`` where there are any: one a block of each of the
    path's evaluations on the card."""
    k3, blocks = _counter("k3.launches"), _counter("eval.blocks.cuda")
    if k3 != blocks:
        fail(f"the {what} path launched K3 {k3} times in {blocks} evaluation blocks on the card")
    if k3:
        by_path[what] = k3
    return k3


def ml1m_split():
    """The ML-1M-shaped synthetic split of bench.py: 6040 x 3706, density
    0.0446, 80/20 train/test, numpy seed 0."""
    from ganmf_tpu_torch.data.synthetic import ml1m_shaped_split

    return ml1m_shaped_split()


def lastfm_split():
    """A LastFM-shaped synthetic split (BASELINE.md:11): 1884 x 17632,
    density 0.00279, 80/20 train/test, numpy seed 0."""
    from ganmf_tpu_torch.data.synthetic import lastfm_shaped_split

    return lastfm_shaped_split()


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
    # DisGANMF's evaluation block (LastFM, K=95) and PureSVD's (ML-1M, K=41)
    Ud, Vd = factors(1884, 17632, DISGANMF_PARAMS["num_factors"])
    Md = seen(1884, 17632, 0.00279 * 0.8)
    errs.append(compare_k1("DisGANMF evaluation block", Ud, Vd, Md, 50))
    Up, Vp = factors(3024, 3706, PURESVD_PARAMS["num_factors"])
    errs.append(compare_k1("PureSVD evaluation block", Up, Vp, M, 50))
    # IALS's evaluation block at the committed LastFM params (K=130)
    Ua, Va = factors(1884, 17632, IALS_K)
    errs.append(compare_k1("IALS evaluation block", Ua, Va, Md, 50))
    # the factor models of phases 22-25, with their biases folded in as the
    # models fold them: BPR (K=10); FunkSVD and AsySVD ([U | bU | 1] and
    # [V | 1 | bV + g], K=12); IRGAN on the LastFM-shaped split ([Gu | 1] and
    # [Gv | Gb], K=11); NMF (K=100, nonnegative); K below one 16-wide slice
    # or between its multiples, as the latent-factor study's K=30 and K=150
    K = MF_SGD_PARAMS["num_factors"]
    Ub, Vb = factors(3024, 3706, K)
    Uf, Vf = factors(3024, 3706, K + 2)
    Uf[:, K + 1] = 1.0
    Vf[:, K] = 1.0
    Ug, Vg = factors(1884, 17632, K + 1)
    Ug[:, K] = 1.0
    Un, Vn = (x.abs() for x in factors(3024, 3706, NMF_PARAMS["num_factors"]))
    errs.append(compare_k1("BPR evaluation block", Ub, Vb, M, 50))
    errs.append(compare_k1("FunkSVD/AsySVD evaluation block, biases folded", Uf, Vf, M, 50))
    errs.append(compare_k1("IRGAN evaluation block, bias folded", Ug, Vg, Md, 50))
    errs.append(compare_k1("NMF evaluation block", Un, Vn, M, 50))
    for k_study in (30, 150):
        Uk, Vk = factors(3024, 3706, k_study)
        errs.append(compare_k1(f"latent-factor study, K={k_study} MAP@5", Uk, Vk, M, 5))

    fused = {}
    for name, (*operands, k) in {
        "evaluation block, B=3024 K=250 I=3706 k=50": (U, V, M, 50),
        "serve_all block, B=2048 K=250 I=3706 k=20": (Us, V, Ms, 20),
        "item-mode evaluation, B=3706 K=250 I=6040 k=50": (Ui, Vi, Mi, 50),
        "recommend, B=5 K=250 I=3706 k=20": (U[:5].contiguous(), V, M[:5].contiguous(), 20),
        "recommend, B=1 K=250 I=3706 k=20": (U[:1].contiguous(), V, M[:1].contiguous(), 20),
        "DisGANMF evaluation, B=1884 K=95 I=17632 k=50": (Ud, Vd, Md, 50),
        "PureSVD evaluation, B=3024 K=41 I=3706 k=50": (Up, Vp, M, 50),
        f"IALS evaluation, B=1884 K={IALS_K} I=17632 k=50": (Ua, Va, Md, 50),
        f"BPR evaluation, B=3024 K={K} I=3706 k=50": (Ub, Vb, M, 50),
        f"FunkSVD/AsySVD evaluation, B=3024 K={K + 2} I=3706 k=50": (Uf, Vf, M, 50),
        f"IRGAN evaluation, B=1884 K={K + 1} I=17632 k=50": (Ug, Vg, Md, 50),
        f"NMF evaluation, B=3024 K={NMF_PARAMS['num_factors']} I=3706 k=50": (Un, Vn, M, 50),
    }.items():
        t = time_k1(*operands, k)
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
    wide_errs.append(compare_k1("wide: DisGANMF's default cutoff", Ud[:5].contiguous(), Vd,
                                Md[:5].contiguous(), 17631))
    wide_errs.append(compare_k1("wide: PureSVD's default cutoff", Up[:5].contiguous(), Vp,
                                M[:5].contiguous(), 3705))
    wide_errs.append(compare_k1("wide: IALS's default cutoff", Ua[:5].contiguous(), Va,
                                Md[:5].contiguous(), 17631))
    for what, (Uw_, Vw_, Mw_) in {"BPR": (Ub, Vb, M), "FunkSVD/AsySVD": (Uf, Vf, M),
                                  "IRGAN": (Ug, Vg, Md), "NMF": (Un, Vn, M)}.items():
        wide_errs.append(compare_k1(f"wide: {what}'s default cutoff", Uw_[:5].contiguous(), Vw_,
                                    Mw_[:5].contiguous(), Vw_.shape[0] - 1))
    UL, VL = factors(64, 17632, NUM_FACTORS)
    wide = {}
    for name, (*operands, k) in {
        "recommend, B=5 K=250 I=3706 k=3705": (Uw, V, Mw, 3705),
        "recommend, B=1 K=250 I=3706 k=3705": (U[:1].contiguous(), V, M[:1].contiguous(), 3705),
        "evaluation above cutoff 64, B=3024 K=250 I=3706 k=100": (U, V, M, 100),
        "LastFM items, B=64 K=250 I=17632 k=100": (UL, VL, Ml, 100),
        "DisGANMF recommend, B=5 K=95 I=17632 k=17631": (Ud[:5].contiguous(), Vd, Md[:5].contiguous(), 17631),
        "PureSVD recommend, B=5 K=41 I=3706 k=3705": (Up[:5].contiguous(), Vp, M[:5].contiguous(), 3705),
        f"IALS recommend, B=5 K={IALS_K} I=17632 k=17631": (Ua[:5].contiguous(), Va, Md[:5].contiguous(), 17631),
        f"BPR recommend, B=5 K={K} I=3706 k=3705": (Ub[:5].contiguous(), Vb, M[:5].contiguous(), 3705),
        f"IRGAN recommend, B=5 K={K + 1} I=17632 k=17631": (Ug[:5].contiguous(), Vg, Md[:5].contiguous(), 17631),
    }.items():
        t = wide[name] = time_k1(*operands, k)
        print(f"  K1 wide pair at {name}: {t['ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
              f"library {t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})  [{card}]")
    return max(errs), fused, max(wide_errs), wide


def phase_slice(dev, card, train, test):
    import copy

    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import GANMF, init_params

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
        before = _counter("k1.wide_launches")
        recs = model.recommend(users)  # the default cutoff, n_items - 1
        if _counter("k1.wide_launches") != before + 1:
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
        before = _counter("k1.launches")
        results, text = ev.evaluateRecommender(model)
        torch.cuda.synchronize()
        if _counter("k1.launches") <= before:
            fail(f"{mode}: the evaluation did not launch K1")
        t0 = time.perf_counter()
        results, text = ev.evaluateRecommender(model)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        n_eval = len(ev.usersToEvaluate)
        print(text, end="")

        presults, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(plain)
        worst = worst_metric_diff(f"GANMF {mode}", results, presults, METRIC_TOL)
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

    models = {}
    for mode in ("user", "item"):
        print(f"[7] GANMF training, {mode} mode: {GANMF_PARAMS} on {train.shape[0]} x "
              f"{train.shape[1]}, {GANMF_EPOCHS} epochs, early stopping every epoch")
        model = timed(GANMF)(train, mode=mode, seed=SEED, is_experiment=True, device=dev)
        ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
        fused_before = _counter("k1.launches") - _counter("k1.wide_launches")
        returned = model.fit(**GANMF_PARAMS, epochs=GANMF_EPOCHS, validation_evaluator=ev, freq=1)
        torch.cuda.synchronize()
        fused = _counter("k1.launches") - _counter("k1.wide_launches") - fused_before
        if len(model.epoch_log) != GANMF_EPOCHS:
            fail(f"{mode}: {len(model.epoch_log)} epochs ran, not {GANMF_EPOCHS} (fit returned {returned})")
        if fused < GANMF_EPOCHS:
            fail(f"{mode}: the early-stopping evaluations launched K1's fused kernel {fused} times")
        secs = [t for t, _ in model.epoch_log]
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

        before = _counter("k1.wide_launches")
        recs = model.recommend(np.arange(5))  # the default cutoff, n_items - 1
        if _counter("k1.wide_launches") != before + 1:
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
        worst_m = worst_metric_diff(f"trained GANMF {mode}", results, presults, METRIC_TOL)
        print(f"  trained model: every metric at every cutoff within {worst_m:.3e} of its CPU copy "
              f"(MAP@5 {results[5]['MAP']:.6f}, NDCG@10 {results[10]['NDCG']:.6f})")


def select_case(name, R, I, gen, ratio=CFGAN_PARAMS["zr_ratio"], density=0.00279):
    """CFGAN-style selection input: uniform keys (or CAAE's negated Gumbel
    keys), +inf at the interactions, k = int(n_zeros * ratio) in float32; the
    first row takes k = 0 and the last k = I."""
    import torch

    keys = torch.rand(R, I, generator=gen)
    if name == "gumbel":  # CAAE's G phase: -(log p + Gumbel noise)
        p = torch.softmax(torch.randn(R, I, generator=gen), dim=1)
        keys = -(torch.log(p.clamp(min=1e-30)) - torch.log(-torch.log(keys.clamp(min=1e-20) + 1e-20)))
    elif name == "ties":
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
        ("CAAE G-phase keys, +inf on seen items", 32, 3706, "gumbel", 0.0446),
    ]
    worst = 0.0
    for name, R, I, kind, density in cases:
        ratio = CAAE_S if kind == "gumbel" else CFGAN_PARAMS["zr_ratio"]
        keys, k = (t.to(dev) for t in select_case(kind, R, I, g, ratio=ratio, density=density))
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
    for R, I, kind, ratio, density in ((2048, 17632, "uniform", CFGAN_PARAMS["zr_ratio"], 0.00279),
                                       (1884, 17632, "uniform", CFGAN_PARAMS["zr_ratio"], 0.00279),
                                       (17632, 1884, "uniform", CFGAN_PARAMS["zr_ratio"], 0.00279),
                                       (32, 3706, "gumbel", CAAE_S, 0.0446)):
        keys, k = (t.to(dev) for t in select_case(kind, R, I, g, ratio=ratio, density=density))
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

    models = {}
    for mode in ("user", "item"):
        print(f"[9] CFGAN {mode} mode: g_nodes={CFGAN_PARAMS['g_nodes']} d_nodes={CFGAN_PARAMS['d_nodes']} "
              f"d_layers={CFGAN_PARAMS['d_layers']} on {train.shape[0]} x {train.shape[1]}, "
              f"{CFGAN_EPOCHS} epochs")
        # the fit's peak memory above what was allocated before (phase 27
        # sets the csr storage's beside it)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        model = timed(CFGAN)(train, mode=mode, seed=SEED, is_experiment=True, device=dev)
        ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
        returned = model.fit(**CFGAN_PARAMS, epochs=CFGAN_EPOCHS, validation_evaluator=ev,
                             freq=1, allow_worse=5)
        torch.cuda.synchronize()
        CFGAN_DENSE_PEAKS[mode] = torch.cuda.max_memory_allocated(dev) - base
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


def timed(model_class):
    """A subclass of ``model_class`` whose fit logs each epoch's seconds
    (synchronized) and K2 launches in ``epoch_log``."""
    import torch

    class Timed(model_class):
        def _run_training_loop(self, *args, epoch_fn, **kwargs):
            self.epoch_log = []

            def run(epoch):
                torch.cuda.synchronize()
                before, t0 = _counter("k2.launches"), time.perf_counter()
                epoch_fn(epoch)
                torch.cuda.synchronize()
                self.epoch_log.append((time.perf_counter() - t0, _counter("k2.launches") - before))

            return super()._run_training_loop(*args, epoch_fn=run, **kwargs)

    return Timed


def check_trained(name, params, init):
    """Every trained tensor finite and moved from its initial value."""
    import torch

    for i, (t, t0) in enumerate(zip(params.parameters(), init.parameters())):
        if not bool(torch.isfinite(t).all()):
            fail(f"{name}: parameter {i} is not finite after training")
        if not bool((t != t0).any()):
            fail(f"{name}: parameter {i} did not move in training")


def worst_metric_diff(name, results, presults, tol, nan_ok=()):
    """The largest difference between two evaluations; fails past ``tol``
    or on a metric that is not finite (those of ``nan_ok`` may be NaN in
    both)."""
    worst = 0.0
    for c in CUTOFFS:
        for metric, value in results[c].items():
            ref = presults[c][metric]
            if metric in nan_ok and np.isnan(value) and np.isnan(ref):
                continue
            if not (np.isfinite(value) and np.isfinite(ref)):
                fail(f"{name}: {metric}@{c} is not finite ({value}, CPU {ref})")
            worst = max(worst, abs(value - ref))
    if worst > tol:
        fail(f"{name}: a metric differs from the CPU's by {worst:.3e} > {tol}")
    return worst


def serve_checks(name, model, ev, train, card, cold=()):
    """Evaluate, recommend (cutoff 20 and the default), recommend_fused and
    serve_all on a trained model; cold users get empty lists and -inf
    scores. A factor model must launch K1's wide pair at the default
    cutoff. Every metric must be finite, but RMSE, which is NaN when an
    evaluated user has no finite score (a cold user), as in the JAX
    evaluator. Returns the evaluation."""
    import torch

    t0 = time.perf_counter()
    results, text = ev.evaluateRecommender(model)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    for c in CUTOFFS:
        if not all(np.isfinite(v) for m, v in results[c].items() if not (cold and m == "RMSE")):
            fail(f"{name}: a metric at cutoff {c} is not finite")
    print(text, end="")
    n_eval = len(ev.usersToEvaluate)
    print(f"  eval: {n_eval} users x {len(CUTOFFS)} cutoffs in {eval_s:.4f} s = {n_eval / eval_s:.1f} "
          f"users/s  [{card}]")

    users = np.arange(5)
    recs = model.recommend(users, cutoff=20)
    if model.recommend_fused(users, cutoff=20) != recs:
        fail(f"{name}: recommend_fused's lists differ from recommend's")
    before = _counter("k1.wide_launches")
    full = model.recommend(users)  # the default cutoff, n_items - 1
    if model._ranks_with_k1() and _counter("k1.wide_launches") != before + 1:
        fail(f"{name}: recommend at the default cutoff did not launch K1's wide pair")
    seen = np.ediff1d(train.indptr)
    for u, (short, lst) in enumerate(zip(recs, full)):
        want = 0 if u in cold else train.shape[1] - seen[u]
        if len(lst) != want or len(set(lst)) != len(lst) or len(short) != min(20, want):
            fail(f"{name}: recommend gave {len(short)} / {len(lst)} items for user {u}, not {want}")
    t0 = time.perf_counter()
    idx, vals = model.serve_all(cutoff=20)
    serve_s = time.perf_counter() - t0
    warm = np.setdiff1d(np.arange(train.shape[0]), cold)
    if idx.shape != (train.shape[0], 20) or not np.isfinite(vals[warm]).all():
        fail(f"{name}: serve_all returned {idx.shape} or non-finite scores for warm users")
    if len(cold) and not np.isneginf(vals[list(cold)]).all():
        fail(f"{name}: serve_all scored a cold user")
    print(f"  recommend(users 0-4): cutoff 20 and recommend_fused equal, default cutoff "
          f"{[len(r) for r in full]} items; serve_all(cutoff=20): {idx.shape[0]} users in {serve_s:.4f} s")
    return results


def phase_disganmf(dev, card, train, test):
    """DisGANMF trained on the card in both modes through fit() with early
    stopping, then evaluated and served. Returns the models."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import DisGANMF
    from ganmf_tpu_torch.models import disganmf as pdg

    p = DISGANMF_PARAMS
    models = {}
    for mode in ("user", "item"):
        print(f"[11] DisGANMF training, {mode} mode: {p} on {train.shape[0]} x {train.shape[1]}, "
              f"{DISGANMF_EPOCHS} epochs, early stopping every epoch")
        model = timed(DisGANMF)(train, mode=mode, seed=SEED, is_experiment=True, device=dev)
        ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
        fused_before = _counter("k1.launches") - _counter("k1.wide_launches")
        returned = model.fit(**p, epochs=DISGANMF_EPOCHS, validation_evaluator=ev, freq=1)
        torch.cuda.synchronize()
        fused = _counter("k1.launches") - _counter("k1.wide_launches") - fused_before
        if len(model.epoch_log) != DISGANMF_EPOCHS:
            fail(f"DisGANMF {mode}: {len(model.epoch_log)} epochs ran (fit returned {returned})")
        if fused < DISGANMF_EPOCHS:
            fail(f"DisGANMF {mode}: the early-stopping evaluations launched K1's fused kernel {fused} times")
        secs = [t for t, _ in model.epoch_log]
        print(f"  fit returned {returned}; epoch seconds {[round(t, 4) for t in secs]}; median of epochs "
              f"2-3: {float(np.median(secs[1:])):.4f} s/epoch; K1 fused launches in the early-stopping "
              f"evaluations: {fused}  [{card}]")
        n_rows, n_cols = model._train_matrix().shape
        check_trained(f"DisGANMF {mode}", model.params, pdg.init_params(
            n_rows, n_cols, p["num_factors"], p["d_layers"], p["d_nodes"], torch.Generator().manual_seed(SEED), dev))
        serve_checks(f"DisGANMF {mode}", model, ev, train, card)
        models[mode] = (model, ev)
    return models


def phase_disganmf_plain(dev, card, train, test, models):
    """The first DISGANMF_HELD_BATCHES minibatches of each phase of one
    DisGANMF epoch on the card against the CPU from the same state and
    permutation, and the trained models' evaluations against their CPU
    copies."""
    import copy

    import torch

    from ganmf_tpu_torch.data.device import dense_from_sparse
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import DisGANMF
    from ganmf_tpu_torch.models import disganmf as pdg
    from ganmf_tpu_torch.models import ganmf as pgm
    from ganmf_tpu_torch.models.gan_base import make_batches, padded_weights, shuffled_padded_perm

    cpu = torch.device("cpu")
    p = DISGANMF_PARAMS
    bs = p["batch_size"]
    for mode in ("user", "item"):
        print(f"[11] DisGANMF {mode} mode against the plain path on the CPU")
        model, ev = models[mode]
        mat = model._train_matrix()
        n_rows, n_cols = mat.shape
        n_batches, padded = make_batches(n_rows, bs)
        n = min(DISGANMF_HELD_BATCHES, n_batches)
        perm = torch.from_numpy(shuffled_padded_perm(np.random.RandomState(SEED), n_rows, padded))
        w = torch.from_numpy(padded_weights(n_rows, padded))
        runs = []
        for d in (dev, cpu):
            params = pdg.init_params(n_rows, n_cols, p["num_factors"], p["d_layers"], p["d_nodes"],
                                     torch.Generator().manual_seed(SEED), d)
            d_opt = torch.optim.Adam(params.d_params(), lr=p["d_lr"], betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
            item_opt = torch.optim.Adam([params.item_emb], lr=p["g_lr"], betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
            t0 = time.perf_counter()
            dl, gl = pdg.disganmf_epoch(
                params, d_opt, item_opt, pgm.user_adam_state(params.user_emb), dense_from_sparse(mat, d),
                perm.to(d, torch.int64), w.to(d), g_lr=p["g_lr"], recon_coefficient=p["recon_coefficient"],
                d_reg=p["d_reg"], g_reg=0.0, n_batches=n, batch_size=bs, d_steps=1, g_steps=1,
                d_hidden_act=p["d_hidden_act"], lazy_user_adam=mode == "user")
            losses = (float(dl), float(gl))  # waits for the epoch
            runs.append(([t.detach().cpu() for t in params.parameters()], losses, time.perf_counter() - t0))
        (card_p, card_losses, card_s), (cpu_p, cpu_losses, cpu_s) = runs
        if not np.isfinite(card_losses + cpu_losses).all():
            fail(f"DisGANMF {mode}: a loss is not finite: card {card_losses}, CPU {cpu_losses}")
        worst = adam_bound_check(f"DisGANMF {mode}", card_p, cpu_p,
                                 [(n, p["g_lr"])] * 2 + [(n, p["d_lr"])] * (len(card_p) - 2))
        if not np.allclose(card_losses, cpu_losses, rtol=LOSS_RTOL, atol=0):
            fail(f"DisGANMF {mode}: the epoch's mean losses {card_losses} differ from the CPU's {cpu_losses}")
        print(f"  the epoch's first {n} minibatches of each phase from the same state and permutation: "
              f"largest parameter difference {worst:.3e} (bounds G {2.2 * p['g_lr'] * n:.3e}, D "
              f"{2.2 * p['d_lr'] * n:.3e}); losses card {card_losses} CPU {cpu_losses}; card {card_s:.4f} s "
              f"(first call), CPU {cpu_s:.4f} s")
        plain = DisGANMF(train, mode=mode, seed=SEED, is_experiment=True, device=cpu)
        plain.params = copy.deepcopy(model.params).to(cpu)
        results, _ = ev.evaluateRecommender(model)
        presults, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(plain)
        worst_m = worst_metric_diff(f"DisGANMF {mode}", results, presults, METRIC_TOL)
        print(f"  trained model: every metric at every cutoff within {worst_m:.3e} of its CPU copy "
              f"(MAP@5 {results[5]['MAP']:.6f}, NDCG@10 {results[10]['NDCG']:.6f})")


def ml1m_cold_split():
    """The ML-1M-shaped split with the training rows of SVD_COLD_USERS
    emptied (their test rows kept)."""
    import scipy.sparse as sps

    train, test = ml1m_split()
    train = train.tolil()
    train[SVD_COLD_USERS, :] = 0
    train = sps.csr_matrix(train)
    train.eliminate_zeros()
    return train, test


def phase_puresvd(dev, card, train, test):
    """PureSVD fitted on the card, evaluated and served through K1."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import PureSVDRecommender

    print(f"[12] PureSVD: {PURESVD_PARAMS} on {train.shape[0]} x {train.shape[1]} with cold users "
          f"{SVD_COLD_USERS}")
    model = PureSVDRecommender(train, device=dev)
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(**PURESVD_PARAMS)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    U, V, cold = model._factors_device()
    if not (bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all())):
        fail("PureSVD: the factors are not finite")
    if sorted(torch.nonzero(cold).flatten().tolist()) != SVD_COLD_USERS:
        fail("PureSVD: the cold users are not the ones emptied")
    print(f"  fit: {secs[0]:.4f} s (first call), {secs[1]:.4f} s (second); U {tuple(U.shape)}, "
          f"V {tuple(V.shape)}  [{card}]")
    ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
    serve_checks("PureSVD", model, ev, train, card, cold=SVD_COLD_USERS)
    return model, ev


def phase_puresvd_plain(dev, card, train, test, model, ev):
    """PureSVD's fit on the card against the CPU's from the same Omega, and
    the card's factors evaluated on the card and on the CPU."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import PureSVDRecommender

    cpu = torch.device("cpu")
    print("[12] PureSVD against the plain path on the CPU")
    plain = PureSVDRecommender(train, device=cpu)
    t0 = time.perf_counter()
    plain.fit(**PURESVD_PARAMS)
    cpu_s = time.perf_counter() - t0
    users = np.setdiff1d(np.arange(train.shape[0]), SVD_COLD_USERS)
    got = model.score_device(torch.from_numpy(users).to(dev)).cpu()
    want = plain.score_device(torch.from_numpy(users))
    diff, scale = float((got - want).abs().max()), float(want.abs().max())
    if not diff <= SVD_SCORE_RTOL * scale:
        fail(f"PureSVD: the card's scores differ from the CPU fit's by {diff:.3e} (scale {scale:.3e})")
    print(f"  fit from the same Omega: scores of the {len(users)} warm users within {diff:.3e} of the CPU "
          f"fit's (scale {scale:.3e}, bound {SVD_SCORE_RTOL * scale:.3e}); CPU fit {cpu_s:.4f} s")
    copy = PureSVDRecommender(train, device=cpu)
    copy.USER_factors, copy.ITEM_factors = model.USER_factors, model.ITEM_factors
    results, _ = ev.evaluateRecommender(model)
    presults, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(copy)
    worst = worst_metric_diff("PureSVD", results, presults, METRIC_TOL, nan_ok=("RMSE",))
    print(f"  the card's factors: every metric at every cutoff within {worst:.3e} on the card and on the "
          f"CPU (MAP@5 {results[5]['MAP']:.6f}, NDCG@10 {results[10]['NDCG']:.6f})")


def phase_caae(dev, card, train, test):
    """CAAE trained on the card through fit() with early stopping, then
    evaluated and served."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import CAAE
    from ganmf_tpu_torch.models import caae as pca

    print(f"[13] CAAE training: {CAAE_PARAMS} on {train.shape[0]} x {train.shape[1]}, {CAAE_EPOCHS} epochs, "
          f"early stopping every epoch")
    model = timed(CAAE)(train, seed=SEED, is_experiment=True, device=dev)
    ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
    returned = model.fit(**CAAE_PARAMS, epochs=CAAE_EPOCHS, validation_evaluator=ev, freq=1)
    torch.cuda.synchronize()
    if len(model.epoch_log) != CAAE_EPOCHS:
        fail(f"CAAE: {len(model.epoch_log)} epochs ran, not {CAAE_EPOCHS} (fit returned {returned})")
    for e, (_, n) in enumerate(model.epoch_log, 1):
        if n < 1:
            fail(f"CAAE: epoch {e} did not launch K2")
    secs = [t for t, _ in model.epoch_log]
    print(f"  fit returned {returned}; epoch seconds {[round(t, 4) for t in secs]}, K2 launches per epoch "
          f"{[n for _, n in model.epoch_log]}; median of epochs 2-3: {float(np.median(secs[1:])):.4f} "
          f"s/epoch  [{card}]")
    g_dims = [train.shape[1]] + [CAAE_PARAMS["g_units"]] * CAAE_PARAMS["g_layers"] + [train.shape[1]]
    check_trained("CAAE", model.params, pca.init_params(
        *train.shape, CAAE_PARAMS["num_factors"], g_dims, torch.Generator().manual_seed(SEED), dev))
    serve_checks("CAAE", model, ev, train, card)
    return model, ev


def phase_caae_plain(dev, card, train, test, model, ev):
    """One CAAE epoch on the card against the CPU from the same state and
    draws, and the evaluation on the card's scores on both."""
    import torch

    from ganmf_tpu_torch.data.device import dense_from_sparse
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import CAAE
    from ganmf_tpu_torch.models import caae as pca

    cpu = torch.device("cpu")
    p = CAAE_PARAMS
    print("[13] CAAE against the plain path on the CPU")
    n_users, n_items = train.shape
    coo = train.tocoo()
    n_chunks = int(np.ceil(coo.nnz / p["d_bsize"]))
    pad = n_chunks * p["d_bsize"] - coo.nnz
    inter = [torch.from_numpy(np.concatenate([a, np.zeros(pad, a.dtype)]).astype(np.int64)) for a in (coo.row, coo.col)]
    weight = torch.from_numpy(np.concatenate([np.ones(coo.nnz, np.float32), np.zeros(pad, np.float32)]))
    n_samples = max(1, 2 * int(np.median(np.ediff1d(train.indptr))))
    n_steps = p["d_steps"] * n_chunks
    draws = pca.draw_epoch(torch.Generator().manual_seed(SEED + 2), cpu, len(weight), n_users, n_items,
                           n_steps * p["d_bsize"], 1, 1, 32, n_samples)
    g_dims = [n_items] + [p["g_units"]] * p["g_layers"] + [n_items]
    runs = []
    for d in (dev, cpu):
        params = pca.init_params(n_users, n_items, p["num_factors"], g_dims, torch.Generator().manual_seed(SEED), d)
        dd = pca.CAAEDraws(*(t.to(d) for t in draws))
        urm = dense_from_sparse(train, d)
        users, items, w = (t.to(d) for t in (*inter, weight))
        with torch.no_grad():  # the D-phase negatives from this device's tables
            tables = [pca.bucketed_cdf_tables(torch.softmax(pca._autoencode(net, urm), dim=1))
                      for net in (params.G, params.Gpr)]
            rows = users.index_select(0, dd.perm).reshape(n_chunks, -1).repeat(p["d_steps"], 1).reshape(-1)
            negs = torch.cat(pca.d_phase_negatives(*tables, rows, dd.d_uniforms, n_items)).cpu()
        if d.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = pca.caae_epoch(params, urm, users, items, w, dd, lr=p["lr"], beta=p["beta"], lmbda=0.5, S=CAAE_S,
                                d_bsize=p["d_bsize"], n_d_chunks=n_chunks, d_steps=p["d_steps"], g_steps=1,
                                gpr_steps=1, m_batch=32, n_samples=n_samples)
        losses = [float(x) for x in losses]  # waits for the epoch
        runs.append((negs, [t.detach().cpu() for t in params.parameters()], losses, time.perf_counter() - t0))
    (card_neg, card_p, card_l, card_s), (cpu_neg, cpu_p, cpu_l, cpu_s) = runs
    flips = int((card_neg != cpu_neg).sum())
    if flips > 1e-3 * card_neg.numel():
        fail(f"CAAE: {flips} of {card_neg.numel()} D-phase negatives differ between the card and the CPU")
    if not np.isfinite(card_l + cpu_l).all():
        fail(f"CAAE: a loss is not finite: card {card_l}, CPU {cpu_l}")
    init = pca.init_params(n_users, n_items, p["num_factors"], g_dims, torch.Generator().manual_seed(SEED), cpu)
    worst_share = 0.0
    for i, (a, b, t0) in enumerate(zip(card_p, cpu_p, init.parameters())):
        moved = float((b - t0.detach()).abs().max())
        diff = float((a - b).abs().max())
        if not (moved > 0 and diff <= CAAE_MOVE_SHARE * moved):
            fail(f"CAAE: parameter {i} differs by {diff:.3e} from the CPU's, which moved {moved:.3e}")
        worst_share = max(worst_share, diff / moved)
    print(f"  one epoch ({2 * n_steps} D updates, 1 G and 1 G' step) from the same state and draws: "
          f"{flips} of {card_neg.numel()} D-phase negatives differ; every tensor within {worst_share:.3e} of "
          f"the distance it moved (bound {CAAE_MOVE_SHARE}); losses (D, G, G') card {card_l} CPU {cpu_l}; "
          f"card {card_s:.4f} s, CPU {cpu_s:.4f} s")

    plain = CAAE(train, seed=SEED, is_experiment=True, device=cpu)
    plain.params = pca.params_from_jax([t.detach().cpu().numpy() for t in model.params.parameters()], cpu)
    card_scores = model.score_device(torch.arange(n_users, device=dev)).cpu()
    plain_scores = plain.score_device(torch.arange(n_users))
    if not torch.allclose(card_scores, plain_scores, rtol=GEN_RTOL, atol=GEN_ATOL):
        fail(f"CAAE: the card's scores differ from the CPU's beyond rtol {GEN_RTOL}")
    plain._score_cache = card_scores  # the card's scores: no BLAS rounding in what follows
    results, _ = ev.evaluateRecommender(model)
    presults, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(plain)
    worst = worst_metric_diff("CAAE", results, presults, SAME_SCORES_TOL)
    idx, _ = model.serve_all(cutoff=20)
    pidx, _ = plain.serve_all(cutoff=20)
    if not np.array_equal(idx, pidx):
        fail("CAAE: serve_all ids differ from the CPU's on the same scores")
    print(f"  scores within rtol {GEN_RTOL} of the CPU's; on the card's scores every metric within "
          f"{worst:.3e} of the CPU path, serve_all ids equal")


def phase_toppop(dev, card, train, test):
    """TopPop on the card: fit, evaluate, recommend, recommend_fused and
    serve_all by the dense route, held against the CPU (ids equal, metrics
    within SAME_SCORES_TOL: the scores are equal)."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import TopPop

    cpu = torch.device("cpu")
    print(f"[14] TopPop on {train.shape[0]} x {train.shape[1]}")
    model, plain = TopPop(train, device=dev), TopPop(train, device=cpu)
    model.fit()
    plain.fit()
    results = serve_checks("TopPop", model, EvaluatorHoldout(test, CUTOFFS, device=dev), train, card)
    presults, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(plain)
    worst = worst_metric_diff("TopPop", results, presults, SAME_SCORES_TOL)
    users = np.arange(5)
    for cutoff in (20, None):
        if model.recommend(users, cutoff=cutoff) != plain.recommend(users, cutoff=cutoff):
            fail(f"TopPop: recommend(cutoff={cutoff}) differs from the CPU's")
    idx, vals = model.serve_all(cutoff=20)
    pidx, pvals = plain.serve_all(cutoff=20)
    if not (np.array_equal(idx, pidx) and np.array_equal(vals, pvals)):
        fail("TopPop: serve_all differs from the CPU's")
    print(f"  recommend and serve_all ids equal to the CPU's; every metric within {worst:.3e}")


def timed_ials():
    """A subclass of IALSRecommender that logs each epoch's seconds
    (synchronized) in ``epoch_log`` and keeps its fitted instances."""
    import torch

    from ganmf_tpu_torch.models import IALSRecommender

    class TimedIALS(IALSRecommender):
        instances = []

        def fit(self, *args, **kwargs):
            self.epoch_log = []
            TimedIALS.instances.append(self)
            return super().fit(*args, **kwargs)

        def _run_epoch(self, num_epoch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._run_epoch(num_epoch)
            torch.cuda.synchronize()
            self.epoch_log.append(time.perf_counter() - t0)

    return TimedIALS


def cg_summary(model):
    """CG iterations per chunk (the first and last epoch's) and host reads."""
    its = [[it for it, _ in epoch] for epoch in model.cg_log]
    reads = sum(r for epoch in model.cg_log for _, r in epoch)
    return (f"CG iterations per chunk (user step's chunks, then the item step's): epoch 1 {its[0]}, "
            f"epoch {len(its)} {its[-1]}, mean {float(np.mean(sum(its, []))):.2f}; {reads} host reads of the "
            f"exit test in {len(its)} epochs")


def ials_best_params():
    import pickle

    with open(os.path.join(BP_DIR, "IALSRecommender__LastFM", "best_params.pkl"), "rb") as fh:
        return pickle.load(fh)


def phase_ials_run_best(dev, card, split_dir, scratch):
    """run_best("LastFM", "ALS") with the committed best params (K=130, 80
    epochs) on a LastFM-shaped five-way split: training on the card, the test
    evaluation through K1."""
    from ganmf_tpu_torch.cli import experiment, run_best
    from ganmf_tpu_torch.data.splits import make_experiment_splits, save_experiment_splits

    train, test = lastfm_split()
    save_experiment_splits(make_experiment_splits(train + test, seed=SEED), "LastFM", split_dir)
    os.environ["GANMF_TPU_SPLIT_DIR"] = split_dir
    print(f"[15] IALS run_best on a LastFM-shaped five-way split: {ials_best_params()}")
    TimedIALS = timed_ials()
    saved = experiment.DICT_REC_CLASSES["ALS"]
    experiment.DICT_REC_CLASSES["ALS"] = TimedIALS
    try:
        t0 = time.perf_counter()
        results = run_best.run("LastFM", "ALS", bp_dir=BP_DIR, out_root=os.path.join(scratch, "test_results"),
                               force=True, device=dev)
        wall = time.perf_counter() - t0
    finally:
        experiment.DICT_REC_CLASSES["ALS"] = saved
    (model,) = TimedIALS.instances
    secs = model.epoch_log
    if len(secs) != ials_best_params()["epochs"]:
        fail(f"IALS run_best: {len(secs)} epochs ran")
    for c in CUTOFFS:
        if not all(np.isfinite(results[c][m]) for m in ("PRECISION", "RECALL", "MAP", "NDCG")):
            fail(f"IALS run_best: a ranking metric at cutoff {c} is not finite")
    print(f"  {len(secs)} epochs: median {float(np.median(secs)):.4f} s/epoch (first {secs[0]:.4f} s, min "
          f"{min(secs):.4f}, max {max(secs):.4f}); run_best wall {wall:.2f} s  [{card}]")
    print(f"  {cg_summary(model)}")
    print(f"  test: MAP@5 {results[5]['MAP']:.6f}, NDCG@10 {results[10]['NDCG']:.6f}, "
          f"RECALL@50 {results[50]['RECALL']:.6f}")


def phase_ials_train(dev, card, train, test):
    """IALS with early stopping at the committed params, epochs cut to
    IALS_ES_EPOCHS and a validation every 5: the validations launch K1's
    fused kernel, then evaluate, recommend and serve_all (the default cutoff
    through the wide pair)."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout

    params = dict(ials_best_params(), epochs=IALS_ES_EPOCHS)
    print(f"[15] IALS with early stopping: {params}, a validation every 5 epochs, on {train.shape[0]} x "
          f"{train.shape[1]}")
    model = timed_ials()(train, device=dev)
    ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
    fused_before = _counter("k1.launches") - _counter("k1.wide_launches")
    model.fit(**params, validation_every_n=5, stop_on_validation=True, validation_metric="MAP",
              lower_validations_allowed=5, evaluator_object=ev)
    torch.cuda.synchronize()
    fused = _counter("k1.launches") - _counter("k1.wide_launches") - fused_before
    if fused < IALS_ES_EPOCHS // 5:
        fail(f"IALS: the early-stopping validations launched K1's fused kernel {fused} times")
    secs = model.epoch_log
    print(f"  epochs_best {model.epochs_best}; median {float(np.median(secs)):.4f} s/epoch over {len(secs)} "
          f"epochs; K1 fused launches in the validations: {fused}  [{card}]")
    print(f"  {cg_summary(model)}")
    serve_checks("IALS", model, ev, train, card)


def phase_ials_csr(dev, card, train):
    """IALS with csr storage, padded and flat, against the dense form on the
    card (IALS_RTOL / IALS_ATOL), IALS_CSR_EPOCHS epochs each."""
    from ganmf_tpu_torch.models import ials

    params = dict(ials_best_params(), epochs=IALS_CSR_EPOCHS)
    print(f"[15] IALS csr storage against dense on the card, {IALS_CSR_EPOCHS} epochs")
    fits = {}
    for form in ("dense", "padded", "flat"):
        model = timed_ials()(train, device=dev)
        limit = ials._PAD_PLANE_BYTE_LIMIT
        if form == "flat":
            ials._PAD_PLANE_BYTE_LIMIT = 1
        try:
            model.fit(**params, urm_storage="dense" if form == "dense" else "csr")
        finally:
            ials._PAD_PLANE_BYTE_LIMIT = limit
        if model._store_users[0] != form or model._store_items[0] != form:
            fail(f"IALS: urm_storage gave {model._store_users[0]} / {model._store_items[0]}, not {form}")
        fits[form] = model
    U, V = fits["dense"]._U_dev.cpu().numpy(), fits["dense"]._V_dev.cpu().numpy()
    for form in ("padded", "flat"):
        m = fits[form]
        Uf, Vf = m._U_dev.cpu().numpy(), m._V_dev.cpu().numpy()
        if not (np.allclose(Uf, U, rtol=IALS_RTOL, atol=IALS_ATOL) and np.allclose(Vf, V, rtol=IALS_RTOL, atol=IALS_ATOL)):
            fail(f"IALS {form}: the factors differ from the dense form's beyond rtol {IALS_RTOL} / atol {IALS_ATOL}")
        print(f"  {form}: factors within {max(np.abs(Uf - U).max(), np.abs(Vf - V).max()):.3e} of the dense "
              f"form's; {float(np.median(m.epoch_log)):.4f} s/epoch (dense {float(np.median(fits['dense'].epoch_log)):.4f})"
              f"  [{card}]")


def row_gap(got, want):
    """The largest distance between two factor rows, relative to the row's norm."""
    return float((np.linalg.norm(got - want, axis=1) / np.maximum(np.linalg.norm(want, axis=1), 1e-30)).max())


def phase_ials_plain(dev, card, train, test):
    """One dense IALS epoch at bench.py's ML-1M configuration from the same
    initial factors on the card and on the CPU (rows within IALS_ROW_GAP),
    and the card's factors evaluated on the card and on the CPU (1e-5)."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import IALSRecommender

    cpu = torch.device("cpu")
    print(f"[15] IALS against the plain path on the CPU: one epoch at {IALS_BENCH_PARAMS} on {train.shape[0]} x "
          f"{train.shape[1]}")
    runs = []
    for d in (dev, cpu):
        model = timed_ials()(train, device=d)
        model.fit(epochs=1, **IALS_BENCH_PARAMS)
        runs.append(model)
    card_m, cpu_m = runs
    for name, a, b in (("USER", card_m._U_dev, cpu_m._U_dev), ("ITEM", card_m._V_dev, cpu_m._V_dev)):
        a, b = a.cpu().numpy(), b.numpy()
        gap = row_gap(a, b)
        if not gap <= IALS_ROW_GAP:
            fail(f"IALS: the card's {name} factors differ from the CPU's by {gap:.3e} of a row's norm")
        outside = int((np.abs(a - b) > 2e-4 * np.abs(b) + 2e-6).sum())
        print(f"  {name} factors: rows within {gap:.3e} of their norm (bound {IALS_ROW_GAP}); max abs diff "
              f"{np.abs(a - b).max():.3e}; {outside} of {a.size} entries past rtol 2e-4 / atol 2e-6")
    print(f"  one epoch: card {card_m.epoch_log[0]:.4f} s (first call), CPU {cpu_m.epoch_log[0]:.4f} s; "
          f"card {cg_summary(card_m)}")
    copy = IALSRecommender(train, device=cpu)
    copy.USER_factors, copy.ITEM_factors = card_m.USER_factors, card_m.ITEM_factors
    results, _ = EvaluatorHoldout(test, CUTOFFS, device=dev).evaluateRecommender(card_m)
    presults, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(copy)
    worst = worst_metric_diff("IALS", results, presults, METRIC_TOL)
    print(f"  the card's factors: every metric at every cutoff within {worst:.3e} on the card and on the CPU "
          f"(MAP@5 {results[5]['MAP']:.6f})")


def phase_tuner(dev, card, split_dir, scratch):
    """RecSysExp on an ML-1M-shaped five-way split: ALS with 3 fresh
    evaluations and a resume to 5 (the GP proposes the last 2), GANMF with 2;
    the artifacts, run_best on the tuned ALS params, and every committed
    checkpoint read by the port's load."""
    import glob
    import pickle

    from ganmf_tpu_torch.cli import run_best
    from ganmf_tpu_torch.cli.experiment import RecSysExp
    from ganmf_tpu_torch.cli.spaces import DICT_DIMENSIONS
    from ganmf_tpu_torch.data.splits import make_experiment_splits, save_experiment_splits
    from ganmf_tpu_torch.models import GANMF, IALSRecommender
    from ganmf_tpu_torch.tune import Categorical
    from ganmf_tpu_torch.tune.gp import load

    train, test = ml1m_split()
    save_experiment_splits(make_experiment_splits(train + test, seed=SEED), "1M", split_dir)
    os.environ["GANMF_TPU_SPLIT_DIR"] = split_dir
    logs_root = os.path.join(scratch, "experiments")

    def dims_of(algo, epochs):
        """The space with ``epochs`` set to [epochs], in its place or appended."""
        dims = [Categorical([epochs], name="epochs") if d.name == "epochs" else d for d in DICT_DIMENSIONS[algo]]
        return dims if any(d.name == "epochs" for d in dims) else dims + [Categorical([epochs], name="epochs")]

    runs = [(IALSRecommender, "", TUNER_ALS_EPOCHS, evals) for evals in TUNER_ALS_EVALS]
    runs.append((GANMF, "user", TUNER_GANMF_EPOCHS, TUNER_GANMF_EVALS))
    for cls, mode, epochs, evals in runs:
        dims = dims_of("ALS" if cls is IALSRecommender else "GANMF", epochs)
        print(f"[16] tuner: {cls.RECOMMENDER_NAME} {mode or '-'}, {evals} evaluations, epochs [{epochs}]")
        exp = RecSysExp(cls, "1M", fit_param_names=[d.name for d in dims], train_mode=mode, logs_root=logs_root,
                        device=dev)
        checkpoint = os.path.join(exp.logsdir, "checkpoint.pkl")
        done = len(load(checkpoint).func_vals) if os.path.exists(checkpoint) else 0
        t0 = time.perf_counter()
        exp.tune(dims, evals=evals)
        wall = time.perf_counter() - t0
        names = sorted(os.listdir(exp.logsdir))
        if names != ["best_params.pkl", "best_params.txt", "checkpoint.pkl", "results.txt"]:
            fail(f"tuner {cls.RECOMMENDER_NAME}: the experiment wrote {names}")
        result = load(checkpoint)
        if len(result.func_vals) != evals:
            fail(f"tuner {cls.RECOMMENDER_NAME}: {len(result.func_vals)} trials, not {evals}")
        with open(os.path.join(exp.logsdir, "best_params.pkl"), "rb") as fh:
            best = pickle.load(fh)
        print(f"  {evals - done} trials in {wall:.2f} s, {wall / (evals - done):.2f} s a trial  [{card}]; best "
              f"{result.fun:.6f}; new points {result.x_iters[done:]}; best_params {best}")
    print("[16] run_best on the tuned ALS params")
    results = run_best.run("1M", "ALS", bp_dir=logs_root, out_root=os.path.join(scratch, "tuned_results"),
                           force=True, device=dev)
    if not np.isfinite(results[5]["MAP"]):
        fail("run_best on the tuned ALS params gave a MAP@5 that is not finite")
    print("[16] the committed checkpoints through the port's load")
    paths = sorted(glob.glob(os.path.join("experiments", "*", "checkpoint.pkl")))
    if not paths:
        fail("no committed experiments/*/checkpoint.pkl")
    for path in paths:
        r = load(path)
        print(f"  {path}: {len(r.func_vals)} trials, best {r.fun:.6f} at {r.x}")


def similarity_best_params(name):
    import pickle

    with open(os.path.join(BP_DIR, name, "best_params.pkl"), "rb") as fh:
        return pickle.load(fh)


def run_best_seconds(out_dir):
    """(training, testing) seconds of run_best's last test_results.txt entry."""
    with open(os.path.join(out_dir, "test_results.txt")) as fh:
        text = fh.read()
    train_s = float(re.findall(r"Training time: ([0-9.]+) s", text)[-1])
    test_s = float(re.findall(r"Testing time: ([0-9.]+) s", text)[-1])
    return train_s, test_s


def ranked_agree(name, vals, ids, pvals, pids, W_full, rtol):
    """Per-column top-k (values, ids) of the card against the CPU's: values
    within rtol, ids equal except where the two rows' similarities in the
    card's unpruned W lie within rtol of each other (a near tie). Returns
    (largest value gap relative to its value, near-tie slots)."""
    import torch

    pv = pvals.to(vals.device)
    gap = float(((vals - pv).abs() / pv.abs().clamp_min(1e-30)).max())
    if not bool(((vals - pv).abs() <= rtol * pv.abs()).all()):
        fail(f"{name}: W's values differ from the CPU's beyond rtol {rtol} ({gap:.3e})")
    pi = pids.to(ids.device)
    diff = ids != pi
    n_diff = int(diff.sum())
    if n_diff:
        cols = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)[diff]
        sa, sb = W_full[ids[diff], cols], W_full[pi[diff], cols]
        if not bool(((sa - sb).abs() <= rtol * sb.abs()).all()):
            fail(f"{name}: W's ids differ from the CPU's beyond a near tie")
    return gap, n_diff


def sim_ranking_agree(name, model, users, rtol):
    """The similarity route's ranking (masked_topk_matmul: one float32
    product, the seen mask from the profile rows, tiled_topk) of
    SIM_RANK_USERS users spread over ``users``, on the card against the CPU
    from the same W and profile rows: values within rtol, ids equal but at
    near ties in the card's scores. Returns (largest relative value gap,
    near-tie slots)."""
    import torch

    from ganmf_tpu_torch.ops.simscore import masked_topk_matmul

    pick = np.asarray(users)[np.linspace(0, len(users) - 1, SIM_RANK_USERS).astype(np.int64)]
    uids = torch.from_numpy(pick).to(model.device)
    rows, W = model._fused_serving_operands(uids)
    pairs = torch.zeros((len(pick), 1), dtype=torch.int64, device=model.device)
    k = max(CUTOFFS)
    vals, ids, _, _ = masked_topk_matmul(rows, W, None, pairs, k, mask_from_rows=True)
    pvals, pids, _, _ = masked_topk_matmul(rows.cpu(), W.cpu(), None, pairs.cpu(), k, mask_from_rows=True)
    scores = (rows @ W).masked_fill(rows != 0, float("-inf"))
    return ranked_agree(name, vals, ids, pvals, pids, scores.T, rtol)


def phase_itemknn(dev, card, train, test):
    """ItemKNN-CF on the LastFM-shaped split in three families: the Gram on
    the card bitwise equal to the CPU's, on the dense route and with
    _DENSE_A_BYTE_LIMIT lowered on the streamed route; W from it within
    SIM_RTOL of the CPU's with ids equal but at near ties; the similarity
    route's ranking held against the CPU's; the fit and the evaluation
    timed."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import ItemKNNCFRecommender
    from ganmf_tpu_torch.ops import similarity as psim
    from ganmf_tpu_torch.ops.topk import scatter_col_topk_dense

    cpu = torch.device("cpu")
    n_rows, n = train.shape
    print(f"[17] ItemKNN-CF on {n_rows} x {n}: topK {ITEMKNN_TOPK}, shrink {ITEMKNN_SHRINK}, "
          f"{', '.join(ITEMKNN_SIMILARITIES)}")
    ones, pones = torch.ones(n_rows, device=dev), torch.ones(n_rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    G, ss2, route = psim.build_gram(train, ones, False, dev)
    torch.cuda.synchronize()
    gram_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Gp, ss2p, _ = psim.build_gram(train, pones, False, cpu)
    cpu_gram_s = time.perf_counter() - t0
    if route != "dense" or not torch.equal(G.cpu(), Gp) or not torch.equal(ss2.cpu(), ss2p):
        fail(f"ItemKNN: the {route} Gram on the card is not the CPU's bitwise")
    print(f"  Gram (dense route, float32, TF32 off): {1e3 * gram_s:.3f} ms on the card, bitwise equal to the "
          f"CPU's ({cpu_gram_s:.2f} s); largest co-rating count {int(G.max())}  [{card}]")
    saved = psim._DENSE_A_BYTE_LIMIT
    psim._DENSE_A_BYTE_LIMIT = 1
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Gs, _, got = psim.build_gram(train, ones, False, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        psim._DENSE_A_BYTE_LIMIT = saved
    if got != "streamed" or not torch.equal(Gs, G):
        fail(f"ItemKNN: the streamed Gram ({got}) differs from the dense route's")
    print(f"  Gram by the streamed route (_DENSE_A_BYTE_LIMIT lowered, chunks of {psim._STREAM_CHUNK} rows): "
          f"{1e3 * wall:.3f} ms, equal to the dense route's")
    del Gs
    del Gp

    ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
    for similarity in ITEMKNN_SIMILARITIES:
        w_kw = dict(shrink=float(ITEMKNN_SHRINK), normalize=True, asymmetric_alpha=0.5, tversky_alpha=1.0,
                    tversky_beta=1.0, normalize_avg_row=False, distance_mode="lin", use_row_weights=False)
        model = ItemKNNCFRecommender(train, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(topK=ITEMKNN_TOPK, shrink=ITEMKNN_SHRINK, similarity=similarity)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        vals, ids = psim._similarity_topk_from_gram(G, ss2, ones, n_rows, mode=similarity, topk=ITEMKNN_TOPK,
                                                    **w_kw)
        if not torch.equal(model._device_w, scatter_col_topk_dense(vals, ids)):
            fail(f"ItemKNN {similarity}: the fit's W is not the build's from the same Gram")
        t0 = time.perf_counter()
        pvals, pids = psim._similarity_topk_from_gram(G.cpu(), ss2p, pones, n_rows, mode=similarity,
                                                      topk=ITEMKNN_TOPK, **w_kw)
        cpu_s = time.perf_counter() - t0
        W_full = psim._w_block(G, ss2, ss2, 0, n_rows, ones, similarity, **w_kw)
        gap, ties = ranked_agree(f"ItemKNN {similarity}", vals, ids, pvals, pids, W_full, SIM_RTOL)
        del W_full
        if not ev._can_fuse_sim(model):
            fail(f"ItemKNN {similarity}: the evaluator would not take the similarity route")
        t0 = time.perf_counter()
        results, _ = ev.evaluateRecommender(model)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        if not all(np.isfinite(results[c][m]) for c in CUTOFFS for m in ("PRECISION", "RECALL", "MAP", "NDCG")):
            fail(f"ItemKNN {similarity}: a ranking metric is not finite")
        n_eval = len(ev.usersToEvaluate)
        rgap, rties = sim_ranking_agree(f"ItemKNN {similarity} ranking", model, ev.usersToEvaluate, SIM_RTOL)
        print(f"  {similarity}: fit {fit_s:.4f} s; W within {gap:.3e} (relative) of the CPU's from the same Gram "
              f"({cpu_s:.2f} s on the CPU), {ties} near-tie id slots of {ids.numel()}; eval {n_eval} users in "
              f"{eval_s:.4f} s = {n_eval / eval_s:.1f} users/s by the similarity route; MAP@5 "
              f"{results[5]['MAP']:.6f}  [{card}]")
        print(f"    ranking of {SIM_RANK_USERS} users (top {max(CUTOFFS)}, masked_topk_matmul) within {rgap:.3e} "
              f"(relative) of the CPU's from the same W and rows, {rties} near-tie id slots")
        del model
    del G


def csr_topk_agree(name, got, want, rtol):
    """Two per-column top-K matrices (scipy): the same count a column, the
    entries both keep within rtol, and an entry kept by one only within rtol
    of the other's smallest kept value in its column (a near tie). Returns
    (largest relative gap, entries kept by one only)."""
    g, w = got.tocsc(), want.tocsc()
    g.sort_indices()
    w.sort_indices()
    if not np.array_equal(np.diff(g.indptr), np.diff(w.indptr)):
        fail(f"{name}: W keeps another count of entries in some column than the CPU's")
    n = g.shape[0]
    keys = [np.repeat(np.arange(m.shape[1], dtype=np.int64), np.diff(m.indptr)) * n + m.indices for m in (g, w)]
    common, gi, wi = np.intersect1d(keys[0], keys[1], assume_unique=True, return_indices=True)
    gap = float(np.max(np.abs(g.data[gi] - w.data[wi]) / np.abs(w.data[wi]))) if len(common) else 0.0
    if gap > rtol:
        fail(f"{name}: W differs from the CPU's by {gap:.3e} > rtol {rtol}")
    only = 0
    for a, b, ka, kb in ((g, w, keys[0], keys[1]), (w, g, keys[1], keys[0])):
        lone = ~np.isin(ka, kb, assume_unique=True)
        only += int(lone.sum())
        nonempty = np.diff(b.indptr) > 0
        edge = np.zeros(b.shape[1], np.float32)
        edge[nonempty] = np.minimum.reduceat(b.data, b.indptr[:-1][nonempty])
        cols = ka[lone] // n
        if not np.all(np.abs(a.data[lone] - edge[cols]) <= rtol * np.abs(edge[cols])):
            fail(f"{name}: W keeps an entry the CPU's does not, beyond a near tie")
    return gap, only


def phase_p3alpha_run_best(dev, card, scratch):
    """run_best("LastFM", "P3Alpha") at the committed params on the
    LastFM-shaped five-way split, on the card and on the CPU: W within
    rtol 1e-5 but at near ties, the metrics' gap printed."""
    import torch

    from ganmf_tpu_torch.cli import experiment, run_best
    from ganmf_tpu_torch.models import P3alphaRecommender

    class Kept(P3alphaRecommender):
        instances = []

        def fit(self, *args, **kwargs):
            Kept.instances.append(self)
            return super().fit(*args, **kwargs)

    params = similarity_best_params("P3alphaRecommender__LastFM")
    print(f"[18] P3alpha run_best on the LastFM-shaped five-way split: {params}")
    out = {}
    saved = experiment.DICT_REC_CLASSES["P3Alpha"]
    for label, device in (("card", dev), ("cpu", torch.device("cpu"))):
        root = os.path.join(scratch, f"p3alpha_{label}")
        experiment.DICT_REC_CLASSES["P3Alpha"] = Kept
        t0 = time.perf_counter()
        try:
            out[label] = run_best.run("LastFM", "P3Alpha", bp_dir=BP_DIR, out_root=root, force=True, device=device)
        finally:
            experiment.DICT_REC_CLASSES["P3Alpha"] = saved
        wall = time.perf_counter() - t0
        train_s, test_s = run_best_seconds(os.path.join(root, "P3alphaRecommender__LastFM"))
        print(f"  {label}: training {train_s:.3f} s, testing {test_s:.3f} s, run_best wall {wall:.2f} s"
              + (f"  [{card}]" if label == "card" else ""))
    results, presults = out["card"], out["cpu"]
    worst = 0.0
    for c in CUTOFFS:
        for metric, value in results[c].items():
            ref = presults[c][metric]
            if np.isnan(value) and np.isnan(ref):
                continue
            if not (np.isfinite(value) and np.isfinite(ref)):
                fail(f"P3alpha run_best: {metric}@{c} is not finite ({value}, CPU {ref})")
            worst = max(worst, abs(value - ref))
    if worst > P3_METRIC_BOUND:
        fail(f"P3alpha run_best: the card's metrics differ from the CPU run's by {worst:.3e}")
    card_m, cpu_m = Kept.instances
    gap, only = csr_topk_agree("P3alpha", card_m.W_sparse, cpu_m.W_sparse, 1e-5)
    print(f"  W ({card_m.W_sparse.nnz} entries) within {gap:.3e} (relative) of the CPU run's, {only} entries kept "
          f"by one only, each a near tie at its column's edge")
    users = np.flatnonzero(np.ediff1d(card_m.URM_train.indptr) > 0)
    rgap, rties = sim_ranking_agree("P3alpha ranking", card_m, users, P3_RANK_RTOL)
    print(f"  ranking of {SIM_RANK_USERS} users (top {max(CUTOFFS)}) on the card's W within {rgap:.3e} (relative) "
          f"of the CPU's from the same W and rows, {rties} near-tie id slots")
    print(f"  largest metric gap to the CPU run {worst:.3e}; test MAP@5 {results[5]['MAP']:.6f}, NDCG@10 "
          f"{results[10]['NDCG']:.6f}, RECALL@50 {results[50]['RECALL']:.6f}")


def phase_slim(dev, card, train, scratch):
    """SLIM-BPR at the committed LastFM params: one epoch on the card against
    the CPU from the same state and triples (W within SLIM_EPOCH_ATOL), then
    run_best's full 85 epochs, with the epochs and the prunes timed."""
    import statistics

    import torch

    from ganmf_tpu_torch.cli import experiment, run_best
    from ganmf_tpu_torch.models import SLIM_BPR
    from ganmf_tpu_torch.models import slim_bpr as ps

    cpu = torch.device("cpu")
    params = similarity_best_params("SLIM_BPR_Recommender__LastFM")
    lr = params["learning_rate"]
    print(f"[19] SLIM-BPR at the committed LastFM params: {params}")
    mask = train.copy()
    mask.data = (mask.data >= 1).astype(np.float32)
    mask.eliminate_zeros()
    tables, ptables = ps.build_tables(mask, dev), ps.build_tables(mask, cpu)
    chunk = 64
    n_chunks = -(-train.shape[0] // chunk)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    triples = [t.view(n_chunks, chunk) for t in ps.draw_triples(tables, n_chunks * chunk, gen)]
    hyper = dict(learning_rate=lr, li_reg=params["lambda_i"], lj_reg=params["lambda_j"], gamma=0.995, beta_1=0.9,
                 beta_2=0.999, sgd_mode=params["sgd_mode"], symmetric=params["symmetric"])
    state = ps.init_state(train.shape[1], 0.9, 0.999, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ps.bpr_epoch(state, tables.urm, triples, **hyper)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    want = ps.bpr_epoch(ps.OptState(*(t.cpu() for t in state)), ptables.urm, [t.cpu() for t in triples], **hyper)
    gap = float((got.W.cpu() - want.W).abs().max())
    moved = int((want.W != 0).sum())
    same = int((got.W.cpu() == want.W).sum())
    if gap > SLIM_EPOCH_ATOL or moved == 0:
        fail(f"SLIM-BPR: one epoch on the card differs from the CPU's by {gap:.3e} > {SLIM_EPOCH_ATOL} ({moved} "
             f"entries moved)")
    print(f"  one epoch ({n_chunks} chunks of {chunk}) on the card in {epoch_s:.4f} s; W within {gap:.3e} of the "
          f"CPU's (gate {SLIM_EPOCH_ATOL}; lr {lr:.3e}), {moved} entries moved, {same} of {want.W.numel()} bitwise equal; "
          f"cache within {float((got.cache.cpu() - want.cache).abs().max()):.3e}  [{card}]")
    del got, want, state, tables, ptables

    class TimedSLIM(SLIM_BPR):
        instances = []

        def fit(self, *args, **kwargs):
            self.epoch_log = []
            TimedSLIM.instances.append(self)
            return super().fit(*args, **kwargs)

        def _run_epoch(self, num_epoch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._run_epoch(num_epoch)
            torch.cuda.synchronize()
            self.epoch_log.append(time.perf_counter() - t0)

    prunes = []
    prune = ps.prune_topk_device

    def timed_prune(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prune(*args, **kwargs)
        torch.cuda.synchronize()
        prunes.append(time.perf_counter() - t0)
        return out

    saved = experiment.DICT_REC_CLASSES["SLIMBPR"]
    experiment.DICT_REC_CLASSES["SLIMBPR"], ps.prune_topk_device = TimedSLIM, timed_prune
    root = os.path.join(scratch, "slim")
    try:
        t0 = time.perf_counter()
        results = run_best.run("LastFM", "SLIMBPR", bp_dir=BP_DIR, out_root=root, force=True, device=dev)
        wall = time.perf_counter() - t0
    finally:
        experiment.DICT_REC_CLASSES["SLIMBPR"], ps.prune_topk_device = saved, prune
    (model,) = TimedSLIM.instances
    secs = model.epoch_log
    if len(secs) != params["epochs"]:
        fail(f"SLIM-BPR run_best: {len(secs)} epochs ran")
    for c in CUTOFFS:
        if not all(np.isfinite(results[c][m]) for m in ("PRECISION", "RECALL", "MAP", "NDCG")):
            fail(f"SLIM-BPR run_best: a ranking metric at cutoff {c} is not finite")
    train_s, test_s = run_best_seconds(os.path.join(root, "SLIM_BPR_Recommender__LastFM"))
    print(f"  run_best: {len(secs)} epochs, median {statistics.median(secs):.4f} s/epoch (min {min(secs):.4f}, "
          f"max {max(secs):.4f}); prunes (topK {params['topK']}) {', '.join(f'{p:.4f}' for p in prunes)} s; "
          f"training {train_s:.3f} s, testing {test_s:.3f} s, wall {wall:.2f} s  [{card}]")
    print(f"  test: MAP@5 {results[5]['MAP']:.6f}, NDCG@10 {results[10]['NDCG']:.6f}, "
          f"RECALL@50 {results[50]['RECALL']:.6f}; W_sparse nnz {model.W_sparse.nnz}")


def phase_sim_tuner(dev, card, split_dir, scratch):
    """RecSysExp on the ML-1M-shaped five-way split: SLIM-BPR (early
    stopping) and ItemKNN with the cosine similarity, 2 trials each."""
    from ganmf_tpu_torch.cli.experiment import RecSysExp
    from ganmf_tpu_torch.cli.spaces import DICT_DIMENSIONS, similarity_extra_dimensions
    from ganmf_tpu_torch.models import SLIM_BPR, ItemKNNCFRecommender
    from ganmf_tpu_torch.tune import Categorical
    from ganmf_tpu_torch.tune.gp import load

    os.environ["GANMF_TPU_SPLIT_DIR"] = split_dir
    logs_root = os.path.join(scratch, "sim_experiments")
    slim_dims = [Categorical([SIM_TUNER_SLIM_EPOCHS], name="epochs") if d.name == "epochs" else d
                 for d in DICT_DIMENSIONS["SLIMBPR"]]
    knn_dims = (list(DICT_DIMENSIONS["ItemKNN"]) + [Categorical(["cosine"], name="similarity")]
                + similarity_extra_dimensions("cosine"))
    for cls, dims, sim in ((SLIM_BPR, slim_dims, ""), (ItemKNNCFRecommender, knn_dims, "cosine")):
        print(f"[20] tuner: {cls.RECOMMENDER_NAME} {sim or '-'}, {SIM_TUNER_EVALS} evaluations")
        exp = RecSysExp(cls, "1M", fit_param_names=[d.name for d in dims], similarity_mode=sim, logs_root=logs_root,
                        device=dev)
        t0 = time.perf_counter()
        exp.tune(dims, evals=SIM_TUNER_EVALS)
        wall = time.perf_counter() - t0
        names = sorted(os.listdir(exp.logsdir))
        if names != ["best_params.pkl", "best_params.txt", "checkpoint.pkl", "results.txt"]:
            fail(f"tuner {cls.RECOMMENDER_NAME}: the experiment wrote {names}")
        result = load(os.path.join(exp.logsdir, "checkpoint.pkl"))
        if len(result.func_vals) != SIM_TUNER_EVALS:
            fail(f"tuner {cls.RECOMMENDER_NAME}: {len(result.func_vals)} trials")
        best = exp.load_best_params()
        if cls is SLIM_BPR and "epochs" not in best:
            fail("tuner SLIM-BPR: early stopping's epochs are not in best_params.pkl")
        print(f"  {SIM_TUNER_EVALS} trials in {wall:.2f} s, {wall / SIM_TUNER_EVALS:.2f} s a trial  [{card}]; "
              f"best {result.fun:.6f}; best_params {best}")


def phase_puresvd_itemknn(dev, card, train, test):
    """PureSVD with the "itemKNN" cold-user estimate on the ML-1M-shaped split
    with cold users: evaluated by the dense route (no K1 launch), its
    metrics held against a CPU copy with the same factors. The estimate
    scores no user (the cold and warm masks come from one URM, as in the JAX
    package), so the scores are the factor product's; this is checked."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import PureSVDRecommender

    print(f"[21] PureSVD ({PURESVD_PARAMS}) with the itemKNN cold-user estimate (topK 100) on "
          f"{train.shape[0]} x {train.shape[1]}, users {SVD_COLD_USERS} cold")
    model = PureSVDRecommender(train, device=dev)
    model.fit(**PURESVD_PARAMS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.set_URM_train(train, estimate_model_for_cold_users="itemKNN", topK=100)
    torch.cuda.synchronize()
    est_s = time.perf_counter() - t0
    plain = PureSVDRecommender(train, device=torch.device("cpu"))
    plain.USER_factors, plain.ITEM_factors = model.USER_factors, model.ITEM_factors
    plain.set_URM_train(train, estimate_model_for_cold_users="itemKNN", topK=100)
    if model._ranks_with_k1():
        fail("PureSVD with the itemKNN estimate would rank through K1")
    takers = int((model._cold_user_mask & model._warm_user_KNN_mask).sum())
    if takers:
        fail(f"PureSVD's itemKNN estimate would score {takers} users; the JAX package's scores none")
    ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
    t0 = time.perf_counter()
    results, _ = ev.evaluateRecommender(model)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    presults, _ = EvaluatorHoldout(test, CUTOFFS, device=torch.device("cpu")).evaluateRecommender(plain)
    worst = worst_metric_diff("PureSVD itemKNN", results, presults, METRIC_TOL, nan_ok=("RMSE",))
    n_eval = len(ev.usersToEvaluate)
    print(f"  estimate (item factors' W, top 100 a column) built in {est_s:.4f} s; it scores 0 users (the cold "
          f"and warm masks come from one URM); eval {n_eval} users in {eval_s:.4f} s = {n_eval / eval_s:.1f} "
          f"users/s by the dense route; every metric within {worst:.3e} of the CPU copy's  [{card}]")


def timed_epochs(model_class):
    """A subclass of ``model_class`` (an IncrementalTrainingEarlyStopping
    model) whose ``_run_epoch`` logs its synchronized seconds in
    ``epoch_log``."""
    import torch

    class Timed(model_class):
        epoch_log = None

        def _run_epoch(self, num_epoch):
            if self.epoch_log is None:
                self.epoch_log = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._run_epoch(num_epoch)
            torch.cuda.synchronize()
            self.epoch_log.append(time.perf_counter() - t0)

    return Timed


def secs(log):
    return f"{', '.join(f'{s:.4f}' for s in log)} s"


def validated_fit(model, test, dev, **params):
    """fit() with a validation on the test split every epoch (MAP@5, no
    stop), which ranks a factor model through K1's fused kernel; returns the
    fit's wall and the fused launches of its validations."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout

    before = _counter("k1.launches") - _counter("k1.wide_launches")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(evaluator_object=EvaluatorHoldout(test, [5], device=dev), validation_every_n=1,
              validation_metric="MAP", **params)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, _counter("k1.launches") - _counter("k1.wide_launches") - before


def state_gap(name, got, want, atol):
    """The largest difference between two states (NamedTuples of tensors) and
    the share of entries that are bitwise equal; fails past ``atol``."""
    gap, same, total = 0.0, 0, 0
    for field, a, b in zip(want._fields, got, want):
        d = float((a.cpu() - b).abs().max())
        gap = max(gap, d)
        same += int((a.cpu() == b).sum())
        total += b.numel()
        if d > atol:
            fail(f"{name}: {field} differs from the CPU's by {d:.3e} > {atol}")
    return gap, same / total


def phase_mf_sgd(dev, card, train, test):
    """BPR, FunkSVD and AsySVD at the JAX fit's defaults on the ML-1M-shaped
    split, MF_SGD_EPOCHS epochs with a validation through K1 every epoch,
    then evaluated and served; csr storage against dense; one epoch on the
    card against the CPU from the same draws; an epoch under the sync
    debugger."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import MatrixFactorization_AsySVD, MatrixFactorization_BPR, MatrixFactorization_FunkSVD
    from ganmf_tpu_torch.models import mf_sgd as pm

    cpu = torch.device("cpu")
    ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
    for cls in (MatrixFactorization_BPR, MatrixFactorization_FunkSVD, MatrixFactorization_AsySVD):
        print(f"[22] {cls.RECOMMENDER_NAME} on {train.shape[0]} x {train.shape[1]}: {MF_SGD_PARAMS}, "
              f"{MF_SGD_EPOCHS} epochs, a validation (MAP@5) every epoch")
        model = timed_epochs(cls)(train, device=dev)
        wall, fused = validated_fit(model, test, dev, epochs=MF_SGD_EPOCHS, **MF_SGD_PARAMS)
        if fused < MF_SGD_EPOCHS:
            fail(f"{cls.RECOMMENDER_NAME}: {MF_SGD_EPOCHS} validations launched K1's fused kernel {fused} times")
        U, V = model.USER_factors, model.ITEM_factors
        if not (np.isfinite(U).all() and np.isfinite(V).all()) or model.use_bias != (cls is not MatrixFactorization_BPR):
            fail(f"{cls.RECOMMENDER_NAME}: the factors are not finite, or use_bias is {model.use_bias}")
        print(f"  {model._n_chunks} chunks of {model._chunk} an epoch; epochs {secs(model.epoch_log)}; fit with "
              f"validations {wall:.3f} s; best epoch {model.epochs_best}; use_bias {model.use_bias}  [{card}]")
        serve_checks(cls.RECOMMENDER_NAME, model, ev, train, card)

    # csr storage: the same draws from the same generator state, and a fit
    # within the epoch gate of the dense one (atomics reorder duplicate rows)
    tables, ctables = pm.build_tables(train, dev, "dense"), pm.build_tables(train, dev, "csr")
    a = pm.draw_samples(tables, (64, 256), True, torch.Generator(device=dev).manual_seed(SEED))
    b = pm.draw_samples(ctables, (64, 256), True, torch.Generator(device=dev).manual_seed(SEED))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("MF-SGD: the csr storage's draws differ from the dense storage's")
    fits = []
    for storage in ("dense", "csr"):
        model = MatrixFactorization_BPR(train, device=dev)
        model.fit(epochs=MF_SGD_CSR_EPOCHS, urm_storage=storage, **MF_SGD_PARAMS)
        fits.append(model._state)
    gap, same = state_gap("MF-SGD csr against dense", fits[1], on_cpu(fits[0]), MF_EPOCH_ATOL)
    print(f"[22] BPR with urm_storage='csr': draws bitwise the dense storage's; {MF_SGD_CSR_EPOCHS} epochs within "
          f"{gap:.3e} of the dense fit (gate {MF_EPOCH_ATOL}), {same:.4f} of the entries bitwise equal")

    # one epoch on the card against the CPU, from the same state and draws
    lr = MF_SGD_PARAMS["learning_rate"]
    for cls in (MatrixFactorization_BPR, MatrixFactorization_AsySVD):
        model = cls(train, device=dev)
        model.fit(epochs=1, **MF_SGD_PARAMS)
        state = model._state
        draws = pm.draw_samples(model._tables, (model._n_chunks, model._chunk), cls is MatrixFactorization_BPR,
                                torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pm.mf_epoch(state, zip(*draws), **model._hyper)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        want = pm.mf_epoch(on_cpu(state), zip(*(d.cpu() for d in draws)), **model._hyper)
        gap, same = state_gap(f"{cls.RECOMMENDER_NAME} epoch", got, want, MF_EPOCH_ATOL)
        moved = float((want.U - state.U.cpu()).abs().max())
        print(f"[22] one {cls.RECOMMENDER_NAME} epoch on the card ({model._n_chunks} chunks) in {epoch_s:.4f} s: "
              f"within {gap:.3e} of the CPU's from the same state and draws (gate {MF_EPOCH_ATOL}; lr {lr}; the "
              f"epoch moved U by up to {moved:.3e}), {same:.4f} of the entries bitwise equal  [{card}]")

        # the draws and the epoch read nothing back to the host
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model._run_epoch(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    print("[22] the draws and an epoch of BPR and AsySVD ran under set_sync_debug_mode('error')")


def on_cpu(state):
    """A state's tensors on the CPU, as the same NamedTuple."""
    return type(state)(*(t.cpu() for t in state))


def phase_irgan(dev, card, train, test):
    """IRGAN at the JAX fit's defaults on the LastFM-shaped split
    (IRGAN_PRETRAIN_EPOCHS pretraining epochs, IRGAN_EPOCHS adversarial ones
    with a validation through K1 every epoch), evaluated and served; then
    the first IRGAN_HELD_CHUNKS chunks of each epoch kind on the card against
    the CPU from the same noise, the adversarial ones at G_lr
    IRGAN_HELD_G_LR."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import IRGAN_Recommender
    from ganmf_tpu_torch.models import irgan as pi

    print(f"[23] IRGAN on {train.shape[0]} x {train.shape[1]} at the JAX fit's defaults (K=10, batch 256, DNS_K=5, "
          f"g_samples=16): {IRGAN_PRETRAIN_EPOCHS} pretraining and {IRGAN_EPOCHS} adversarial epochs")
    pre_log, pretrain = [], pi.dns_pretrain_epoch

    def timed_pretrain(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pretrain(*args, **kwargs)
        torch.cuda.synchronize()
        pre_log.append(time.perf_counter() - t0)
        return out

    pi.dns_pretrain_epoch = timed_pretrain
    try:
        model = timed_epochs(IRGAN_Recommender)(train, device=dev)
        wall, fused = validated_fit(model, test, dev, epochs=IRGAN_EPOCHS, pre_train_epochs=IRGAN_PRETRAIN_EPOCHS)
    finally:
        pi.dns_pretrain_epoch = pretrain
    if fused < IRGAN_EPOCHS:
        fail(f"IRGAN: {IRGAN_EPOCHS} validations launched K1's fused kernel {fused} times")
    for t in model._state:
        if not bool(torch.isfinite(t).all()):
            fail("IRGAN: a trained table is not finite")
    print(f"  {model._n_chunks} chunks of {model._chunk} an epoch; pretraining epochs {secs(pre_log)}, adversarial "
          f"epochs {secs(model.epoch_log)}; fit with validations {wall:.3f} s; best epoch {model.epochs_best}  [{card}]")
    serve_checks("IRGAN", model, EvaluatorHoldout(test, CUTOFFS, device=dev), train, card)

    # the first chunks of each epoch kind, card against CPU from the same noise
    start = IRGAN_Recommender(train, device=dev)
    start.fit(epochs=0, pre_train_epochs=0)
    C, n, I = start._chunk, IRGAN_HELD_CHUNKS, train.shape[1]
    u, i, pad = start._u_arr[: n * C], start._i_arr[: n * C], start._pad
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hp = start._hp
    kinds = {
        "pretraining": (lambda st, dv, nz: pi.dns_pretrain_epoch(
            st, *dv, nz[0], lr=hp["DNS_lr"], reg=hp["gen_reg"], temperature=hp["temperature"], n_items=I, chunk=C),
            [[pi.gumbel((hp["DNS_K"], C, I), gen) for _ in range(n)]]),
        "adversarial": (lambda st, dv, nz: pi.adversarial_epoch(
            st, *dv, [nz[0]], [nz[1]], d_lr=hp["D_lr"], g_lr=IRGAN_HELD_G_LR, d_reg=hp["disc_reg"], g_reg=hp["gen_reg"],
            temperature=hp["temperature"], n_items=I, chunk=C),
            [[pi.gumbel((C, I), gen) for _ in range(n)], [pi.gumbel((hp["g_samples"], C, I), gen) for _ in range(n)]]),
    }
    state0 = start._state
    for kind, (run, noise) in kinds.items():
        js, update = [], pi.pairwise_update

        def recorded(Uf, Vf, b, u_, i_, j_, lr, reg):
            js.append(j_.clone())
            return update(Uf, Vf, b, u_, i_, j_, lr, reg)

        pi.pairwise_update = recorded
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run(state0, (u, i, pad), noise)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            n_card = len(js)
            want = run(on_cpu(state0), (u.cpu(), i.cpu(), pad.cpu()), [[g.cpu() for g in s] for s in noise])
        finally:
            pi.pairwise_update = update
        flips = sum(int((a.cpu() != b).sum()) for a, b in zip(js[:n_card], js[n_card:]))
        draws = sum(a.numel() for a in js[:n_card])
        gaps = []
        for field, a, b, s in zip(want._fields, got, want, state0):
            moved = float((b - s.cpu()).abs().max())
            gap = float((a.cpu() - b).abs().max())
            tol = max(IRGAN_MOVE_SHARE * moved, IRGAN_ULPS * float(np.spacing(np.float32(b.abs().max()))))
            if gap > tol:
                fail(f"IRGAN {kind}: {field} differs from the CPU's by {gap:.3e} > {tol:.3e} (it moved {moved:.3e})")
            if 0 < moved < IRGAN_MOVE_OVER_GATE * tol:
                fail(f"IRGAN {kind}: {field} moved {moved:.3e}, less than {IRGAN_MOVE_OVER_GATE} times its gate "
                     f"{tol:.3e}: the gate could not see a wrong update")
            gaps.append(f"{field} {gap:.3e} (gate {tol:.3e}, moved {moved:.3e})")
        lr = f"G_lr {IRGAN_HELD_G_LR}" if kind == "adversarial" else f"DNS_lr {hp['DNS_lr']}"
        print(f"[23] IRGAN's first {n} {kind} chunks ({lr}) on the card in {card_s:.4f} s, against the CPU from the "
              f"same noise (gate: {IRGAN_MOVE_SHARE} of the distance moved, at least {IRGAN_ULPS} ulps): "
              f"{'; '.join(gaps)}; flipped negative draws {flips} of {draws}  [{card}]")
        del noise


def list_metrics(lists, test, cutoff):
    """PRECISION, RECALL, MAP and NDCG at ``cutoff`` of ranked lists against
    a 0/1 test matrix, in float64, averaged over the users with a test
    interaction, by the evaluator's definitions (eval/metrics.py)."""
    test = test.tocsr()
    out = {"PRECISION": [], "RECALL": [], "MAP": [], "NDCG": []}
    for u in np.flatnonzero(np.ediff1d(test.indptr) >= 1):
        pos = set(test.indices[test.indptr[u] : test.indptr[u + 1]].tolist())
        ranked = list(lists[u])[:cutoff]
        rel = np.array([item in pos for item in ranked], dtype=np.float64)
        n = len(ranked)
        hits = rel.sum()
        den = min(len(pos), n)
        disc = 1.0 / np.log(np.arange(n) + 2.0)
        out["PRECISION"].append(hits / n if n else 0.0)
        out["RECALL"].append(hits / len(pos))
        out["MAP"].append(float((rel * np.cumsum(rel) / (np.arange(n) + 1.0)).sum()) / max(den, 1) if n else 0.0)
        dcg = float((rel * disc).sum())
        out["NDCG"].append(dcg / float(disc[:den].sum()) if dcg else 0.0)
    return {m: float(np.mean(v)) for m, v in out.items()}


def phase_nmf(dev, card, train, test):
    """NMF at the JAX fit's defaults on the ML-1M-shaped split, evaluated and
    served through K1; NMF_HELD_ITERS iterations on the card against the CPU
    from one init; a PredefinedList from its serve_all, whose lists and
    metrics must be the model's."""
    import scipy.sparse as sps
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import NMFRecommender, PredefinedListRecommender
    from ganmf_tpu_torch.models import extras as px

    print(f"[24] NMF on {train.shape[0]} x {train.shape[1]}: {NMF_PARAMS}")
    model = NMFRecommender(train, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(**NMF_PARAMS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    U, V = model.USER_factors, model.ITEM_factors
    if not (np.isfinite(U).all() and np.isfinite(V).all() and (U >= 0).all() and (V >= 0).all()):
        fail("NMF: the factors are not finite and nonnegative")
    print(f"  fit ({NMF_PARAMS['n_iter']} multiplicative updates, float32, TF32 off) {fit_s:.4f} s  [{card}]")
    ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
    results = serve_checks("NMF", model, ev, train, card)

    A = model.device_urm().dense
    W0, H0 = px.nmf_init(A, NMF_PARAMS["num_factors"], torch.Generator(device=dev).manual_seed(SEED))
    W, H = px.nmf_multiplicative(A, W0, H0, NMF_HELD_ITERS)
    Wp, Hp = px.nmf_multiplicative(A.cpu(), W0.cpu(), H0.cpu(), NMF_HELD_ITERS)
    gaps = [float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in ((W, Wp), (H, Hp))]
    if max(gaps) > NMF_RTOL:
        fail(f"NMF: {NMF_HELD_ITERS} iterations on the card differ from the CPU's by {max(gaps):.3e} of the "
             f"largest factor > {NMF_RTOL}")
    print(f"[24] {NMF_HELD_ITERS} NMF iterations on the card from one init: W and H within {gaps[0]:.3e} and "
          f"{gaps[1]:.3e} of their largest entry of the CPU's (gate {NMF_RTOL})")

    k = max(CUTOFFS)
    ids, vals = model.serve_all(cutoff=k)
    keep = np.isfinite(vals)
    rec = sps.csr_matrix((ids[keep], np.nonzero(keep)[1], np.r_[0, np.cumsum(keep.sum(1))]), shape=train.shape)
    lists_model = PredefinedListRecommender(rec, device=dev)
    users = np.arange(train.shape[0])
    lists = lists_model.recommend(users, cutoff=k)
    if lists != model.recommend(users, cutoff=k):
        fail("PredefinedList: the lists differ from the model's recommend")
    worst = 0.0
    for c in CUTOFFS:
        got = list_metrics(lists, test, c)
        for metric, value in got.items():
            worst = max(worst, abs(value - results[c][metric]))
    if worst > METRIC_TOL:
        fail(f"PredefinedList: a metric of its lists differs from the model's evaluation by {worst:.3e}")
    try:
        lists_model.serve_all(cutoff=5)
        fail("PredefinedList: serve_all did not raise")
    except NotImplementedError:
        pass
    print(f"[24] PredefinedList from NMF's serve_all (top {k}): lists equal to recommend's for {len(users)} users; "
          f"PRECISION, RECALL, MAP and NDCG at {CUTOFFS} within {worst:.3e} of NMF's evaluation; serve_all raises")


def phase_ease_dense(dev, card, train, test):
    """EASE-R without topK on the LastFM-shaped split: the dense [I, I] W,
    timed; the evaluation by the similarity route."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import EASE_R_Recommender

    n = train.shape[1]
    print(f"[24] EASE-R on {train.shape[0]} x {n}, l2_norm {EASE_L2}, no topK: W {4 * n * n / 1e9:.2f} GB, "
          f"~{(2 * train.shape[0] * n * n + 7 / 3 * n ** 3) / 1e12:.1f} TFLOP float32")
    model = EASE_R_Recommender(train, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(l2_norm=EASE_L2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    W = model._device_w
    if not bool(torch.isfinite(W).all()) or bool(torch.diagonal(W).any()):
        fail("EASE-R: W is not finite or its diagonal is not zero")
    ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
    if not ev._can_fuse_sim(model):
        fail("EASE-R: the evaluator would not take the similarity route")
    t0 = time.perf_counter()
    results, _ = ev.evaluateRecommender(model)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if not all(np.isfinite(results[c][m]) for c in CUTOFFS for m in ("PRECISION", "RECALL", "MAP", "NDCG")):
        fail("EASE-R: a ranking metric is not finite")
    n_eval = len(ev.usersToEvaluate)
    print(f"  fit (Gram, Cholesky, a solve against the identity) {fit_s:.4f} s; max|B| {float(W.abs().max()):.4e}; "
          f"eval {n_eval} users in {eval_s:.4f} s = {n_eval / eval_s:.1f} users/s by the similarity route; MAP@5 "
          f"{results[5]['MAP']:.6f}  [{card}]")


def phase_ease_topk(dev, card, train, test):
    """EASE-R with topK at the ML-1M shape, card against CPU: the pruned W
    within EASE_W_TOL of max|B|, an entry kept by one only within it of the
    other's column edge; 256 users' top 50 from each W, ids equal but at
    near ties."""
    import torch

    from ganmf_tpu_torch.models import EASE_R_Recommender
    from ganmf_tpu_torch.ops.topk import topk_lowest_index

    print(f"[24] EASE-R on {train.shape[0]} x {train.shape[1]}, l2_norm {EASE_L2}, topK {EASE_TOPK}")
    models = []
    for d in (dev, torch.device("cpu")):
        m = EASE_R_Recommender(train, device=d)
        if d.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.fit(topK=EASE_TOPK, l2_norm=EASE_L2)
        if d.type == "cuda":
            torch.cuda.synchronize()
        models.append((m, time.perf_counter() - t0))
    (card_m, card_s), (cpu_m, cpu_s) = models
    g, w = card_m._device_w.cpu().numpy(), cpu_m._device_w.numpy()
    tol = EASE_W_TOL * float(np.abs(w).max())
    if not np.array_equal((g != 0).sum(0), (w != 0).sum(0)):
        fail("EASE-R: the pruned W keeps another count of entries in some column than the CPU's")
    both = (g != 0) & (w != 0)
    gap = float(np.abs(g[both] - w[both]).max())
    if gap > tol:
        fail(f"EASE-R: the pruned W differs from the CPU's by {gap:.3e} > {tol:.3e}")
    only = 0
    for a, b in ((g, w), (w, g)):
        lone = (a != 0) & (b == 0)
        only += int(lone.sum())
        edge = np.where(b != 0, b, np.inf).min(0)
        r, c = np.nonzero(lone)
        if not np.all(np.abs(a[r, c] - edge[c]) <= tol):
            fail("EASE-R: the pruned W keeps an entry the CPU's does not, beyond a near tie")
    users = np.linspace(0, train.shape[0] - 1, SIM_RANK_USERS).astype(np.int64)
    rows = card_m.device_profile_rows(torch.from_numpy(users).to(dev))
    seen = rows != 0
    s = (rows @ card_m._device_w).masked_fill(seen, float("-inf"))
    ps = (rows.cpu() @ cpu_m._device_w).masked_fill(seen.cpu(), float("-inf"))
    _, ids = topk_lowest_index(s, max(CUTOFFS))
    _, pids = topk_lowest_index(ps, max(CUTOFFS))
    score_tol = 2 * tol * float(rows.sum(1).max())  # W's gap summed over a profile, on both sides
    diff = ids.cpu() != pids
    sc = s.cpu()
    ties = int(diff.sum())
    if ties and not bool(((sc.gather(1, ids.cpu())[diff] - sc.gather(1, pids)[diff]).abs() <= score_tol).all()):
        fail("EASE-R: the ranking from the card's W differs from the CPU's beyond a near tie")
    print(f"  fit {card_s:.4f} s on the card ({cpu_s:.2f} s on the CPU); pruned W within {gap:.3e} of the CPU's "
          f"(gate {EASE_W_TOL} of max|B| = {tol:.3e}), {only} entries kept by one only; {SIM_RANK_USERS} users' top "
          f"{max(CUTOFFS)}: {ties} near-tie id slots of {ids.numel()}  [{card}]")


def phase_studies(dev, card, split_dir, scratch):
    """The paper's studies on phase 16's ML-1M-shaped five-way split:
    describe, the feature-matching sweep and its cosine study at GANMF's
    ML-1M best params, the latent-factor and qualitative studies, with
    GANMF's epochs cut to STUDY_GANMF_EPOCHS; per_profile_length_map's bins
    averaged to the evaluator's MAP@20 on a PureSVD model."""
    import contextlib
    import io
    import json
    import pickle

    import torch

    from ganmf_tpu_torch.cli import ablation, describe, mf_learned
    from ganmf_tpu_torch.cli.experiment import load_urms
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import PureSVDRecommender

    os.environ["GANMF_TPU_SPLIT_DIR"] = split_dir
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        describe.main(["1M"])
    stats = [json.loads(b) for b in out.getvalue().replace("}\n{", "}\x00{").split("\x00")]
    if [s["name"] for s in stats] != [f"1M/{n}" for n in ("train", "test", "validation", "train_small", "early_stop")]:
        fail("describe: it did not describe the five splits")
    print(f"[25] describe 1M: {[(s['name'], s['n_users'], s['n_items'], s['interactions']) for s in stats]}")

    bp = os.path.join(scratch, "study_params")
    os.makedirs(os.path.join(bp, "GANMF_user_1M"))
    with open(os.path.join(bp, "GANMF_user_1M", "best_params.pkl"), "wb") as fh:
        pickle.dump(dict(GANMF_PARAMS), fh)
    walls = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return res

    fm_dir = os.path.join(scratch, "feature_matching")
    alphas, maps, ndcgs = run("feature matching", lambda: ablation.feature_matching_coefficient(
        "1M", "user", base_params=dict(GANMF_PARAMS), out_dir=fm_dir, epochs=STUDY_GANMF_EPOCHS, device=dev))
    cos = run("feature-matching cosine", lambda: ablation.feature_matching_cos_sim(
        "1M", "user", base_params=dict(GANMF_PARAMS), out_dir=fm_dir, epochs=STUDY_GANMF_EPOCHS, device=dev))
    if len(maps) != 11 or not all(np.isfinite(maps + ndcgs)) or len(os.listdir(fm_dir)) < 13:
        fail("feature matching: the sweep did not write its 11 results")
    print(f"[25] feature matching (11 alphas, {STUDY_GANMF_EPOCHS} epochs each): MAP@5 "
          f"{[round(float(m), 5) for m in maps]}; cosine {cos}")
    series = run("latent factors", lambda: mf_learned.latent_factors_study(
        "1M", out_dir=os.path.join(scratch, "latent_factors"), epochs=STUDY_GANMF_EPOCHS, bp_dir=bp, device=dev))
    if sorted(series) != ["ALS", "GANMF", "PureSVD"] or not all(np.isfinite(v).all() for v in series.values()):
        fail("latent factors: a series is missing or not finite")
    print(f"[25] latent factors (K {mf_learned.K_GRID}): MAP@5 "
          f"{({k: [round(float(x), 5) for x in v] for k, v in series.items()})}")
    qual = run("qualitative", lambda: mf_learned.mf_qualitative_study(
        "1M", out_dir=os.path.join(scratch, "qualitative_study"), epochs=STUDY_GANMF_EPOCHS, bp_dir=bp, device=dev))
    print(f"[25] MAP@20 by profile-length decile: {({k: [round(b['MAP'], 4) for b in v] for k, v in qual.items()})}")

    splits = load_urms("1M")
    svd = PureSVDRecommender(splits.train, device=dev)
    svd.fit(num_factors=50)
    bins = mf_learned.per_profile_length_map(svd, splits)
    n = sum(b["n_users"] for b in bins)
    got = sum(b["MAP"] * b["n_users"] for b in bins) / n
    want, _ = EvaluatorHoldout(splits.test, [20], device=dev).evaluateRecommender(svd)
    if abs(got - want[20]["MAP"]) > METRIC_TOL:
        fail(f"per_profile_length_map: its bins average to {got:.6f}, the evaluator's MAP@20 is {want[20]['MAP']:.6f}")
    print(f"[25] per_profile_length_map (PureSVD K=50): bins average to MAP@20 {got:.6f}, the evaluator's "
          f"{want[20]['MAP']:.6f}; walls {({k: round(v, 2) for k, v in walls.items()})} s  [{card}]")


# ---- phases 26-32: CFGAN csr storage, the column-blocked build, the evaluator extras,
# ---- CAAE dedup and the host engine


def keyed_case(R, I, gen, density=0.00279):
    """A csr minibatch's keys as CFGAN draws them: R distinct row ids of a
    larger matrix, and an interaction mask at the split's density."""
    import torch

    rows = torch.randperm(max(R, 4 * R), generator=gen)[:R]
    inter = torch.rand(R, I, generator=gen) < density
    return rows, inter


def phase_keyed(dev, card):
    """The keyed per-row draw (the keyed_uniforms kernel) and K2 at the csr
    storage's minibatch shapes, each against its plain version (bitwise) and
    timed. Returns (keyed times, K2 times) by shape."""
    import torch

    from ganmf_tpu_torch.ops import _build, keyed
    from ganmf_tpu_torch.ops.select import smallest_k_mask_cuda
    from ganmf_tpu_torch.ops.topk import smallest_k_mask_reference

    print("[26] the keyed per-row draw and K2 at CFGAN's csr minibatch shapes, against their plain "
          "versions (bitwise)")
    g = torch.Generator().manual_seed(SEED + 26)
    keyed_times, k2_times, worst = {}, {}, 0.0
    for R, I, what in CSR_SHAPES:
        rows, inter = (t.to(dev) for t in keyed_case(R, I, g))
        u = keyed.keyed_uniforms_cuda(SEED, 3, 0, rows, I)
        want = keyed.keyed_uniforms_reference(SEED, 3, 0, rows, I)
        torch.cuda.synchronize()
        worst = max(worst, float((u - want).abs().max()))
        if not torch.equal(u, want):
            fail(f"keyed draw [{R}, {I}]: {int((u != want).sum())} values differ from the plain version")
        if not (float(u.min()) >= 0.0 and float(u.max()) < 1.0):
            fail(f"keyed draw [{R}, {I}]: a value outside [0, 1)")
        lib, stream, out = _build.load_library(), _build.stream_handle(dev), torch.empty_like(u)
        k0, k1 = keyed.key_halves(SEED)

        def launch():
            _build.check(lib, lib.ganmf_keyed_uniforms(rows.data_ptr(), R, I, k0, k1, 3, 0, out.data_ptr(), stream),
                         "chip_smoke: keyed draw launch")

        t = {"ms": cuda_ms(lambda: keyed.keyed_uniforms_cuda(SEED, 3, 0, rows, I)), "launch_ms": cuda_ms(launch),
             "plain_ms": cuda_ms(lambda: keyed.keyed_uniforms_reference(SEED, 3, 0, rows, I), reps=5),
             "library_ms": None}
        # the output written once, the row ids read once; ~15 integer
        # operations a key, far under the card's integer rate at that byte rate
        t["bound_ms"], t["bound_by"] = bound(0, 4 * R * I + 8 * R)
        keyed_times[f"[{R}, {I}]"] = t
        print(f"  keyed draw [{R}, {I}] ({what}): bitwise equal, mean {float(u.mean()):.5f}; "
              f"{t['ms']:.4f} ms through the wrapper, {t['launch_ms']:.4f} ms the launch alone, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{100 * t['bound_ms'] / t['launch_ms']:.1f}% of it  [{card}]")

        keys = u.masked_fill(inter, float("inf"))
        k = ((~inter).sum(1).to(torch.float32) * torch.tensor(CFGAN_PARAMS["zr_ratio"], device=dev)).to(torch.int32)
        got = smallest_k_mask_cuda(keys, k)
        if not torch.equal(got, smallest_k_mask_reference(keys, k)):
            fail(f"K2 at the csr shape [{R}, {I}] differs from the plain version")
        t = k2_times[f"csr [{R}, {I}]"] = time_k2(keys, k)
        print(f"  K2 [{R}, {I}] on those keys: bitwise equal; {t['ms']:.4f} ms through the wrapper, "
              f"{t['launch_ms']:.4f} ms the launch alone; plain {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    return worst, keyed_times, k2_times


#: ML-20M's evaluation block for K3: users, items, list places, cutoffs and
#: the longest test row of the block (its power-of-two crop)
K3_BLOCK = dict(B=3648, I=26744, K=50, cutoffs=(5, 10, 20, 50), max_test=2048)


def k3_block(dev, B, I, K, cutoffs, max_test, seed=SEED + 44):
    """evaluate_pairs' arguments for one evaluation block on ``dev``, and its
    dense test rows: a ranked list of K places a user (a few short, one
    empty), test rows of Zipf lengths up to ``max_test`` with ratings 1-5, a
    few rows not counted (two with a NaN RMSE)."""
    import scipy.sparse as sps
    import torch

    from ganmf_tpu_torch.eval.metrics import item_novelty_terms, normalized_popularity, pairs_from_sparse

    rng = np.random.RandomState(seed)
    lens = np.minimum(rng.zipf(1.6, size=B) + 4, max_test)
    lens[:4] = max_test
    rows = np.repeat(np.arange(B), lens)
    cols = np.concatenate([rng.choice(I, size=n, replace=False) for n in lens])
    test = sps.csr_matrix((rng.randint(1, 6, len(rows)).astype(np.float32), (rows, cols)), shape=(B, I))
    vals = -np.sort(-rng.randn(B, K).astype(np.float32), axis=1)
    vals[5, 12:] = -np.inf
    vals[6, :] = -np.inf
    idx = rng.randint(0, I, size=(B, K)).astype(np.int64)
    idx[:, :3] = cols[np.minimum(test.indptr[:-1, None] + np.arange(3), test.indptr[1:, None] - 1)]
    valid = np.ones(B, bool)
    valid[[0, 9, B - 1]] = False
    rmse = rng.rand(B).astype(np.float32)
    rmse[[9, B - 1]] = np.nan
    train = sps.csr_matrix((rng.rand(2000, I) < 0.005).astype(np.float32))
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    args = (put(vals), put(idx), pairs_from_sparse(test, dev), torch.arange(B, device=dev),
            put(np.diff(test.indptr).astype(np.int64)), put(valid),
            put(item_novelty_terms(train, I).astype(np.float32)),
            put(normalized_popularity(train).astype(np.float32)), put(rmse), tuple(cutoffs))
    return args, test


def k3_bound(args):
    """(ms, what bounds it) of K3 on ``args``: every input byte read once
    (the lists, each user's test pairs and row bounds, the per-user inputs,
    the novelty and popularity of each listed place), the counters, the
    per-user AP and the sums written once; no operation counts against the
    float32 rate at these bytes."""
    import torch

    top_vals, top_idx, pairs, uids = args[:4]
    B, K = top_vals.shape
    nc, I = len(args[9]), args[6].shape[0]
    n = int((pairs.indptr[uids + 1] - pairs.indptr[uids]).sum())
    listed = int(torch.isfinite(top_vals).sum())
    nbytes = 12 * B * K + 12 * n + B * (16 + 8 + 1 + 4) + 8 * listed + 4 * nc * (I + B + 13)
    return bound(0, nbytes)


def phase_metrics(dev, card):
    """K3 at ML-20M's evaluation block against its plain version (counters
    equal; sums and each user's AP within float32 summation order), two runs
    bitwise equal, and timed beside its bound, its plain version and the
    dense computation it replaced. Returns (worst relative error, times)."""
    import torch

    from ganmf_tpu_torch.data.device import padded_csr_from_sparse, padded_rows_dense
    from ganmf_tpu_torch.eval.metrics import evaluate_batch_from_topk, evaluate_pairs_cuda, evaluate_pairs_reference

    print("[44] K3 (an evaluation block's metrics) at ML-20M's block shape against its plain version")
    args, test = k3_block(dev, **K3_BLOCK)
    got = evaluate_pairs_cuda(*args)
    again = evaluate_pairs_cuda(*args)
    want = evaluate_pairs_reference(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("K3: two runs on the same inputs differ")
    if not torch.equal(got.counters, want.counters):
        fail("K3: the counters differ from the plain version's")
    worst = worst_rel = 0.0
    for name in ("scalars", "user_ap"):
        g, w = getattr(got, name), getattr(want, name)
        worst = max(worst, float((g - w).abs().max()))
        worst_rel = max(worst_rel, float(((g - w).abs() / w.abs().clamp(min=1e-6)).max()))
        if not torch.allclose(g, w, rtol=METRIC_TOL, atol=1e-6):
            fail(f"K3: {name} differ from the plain version's beyond rtol {METRIC_TOL}")
    uids = args[3]
    rows = padded_rows_dense(padded_csr_from_sparse(test, dev), uids, K3_BLOCK["I"], max_len=K3_BLOCK["max_test"])
    # the yardstick: the dense computation the evaluator made before K3, with
    # its top-k over the dense block of test ratings
    dense_args = args[:2] + (rows,) + args[4:] + (K3_BLOCK["K"],)
    t = {"ms": cuda_ms(lambda: evaluate_pairs_cuda(*args)),
         "plain_ms": cuda_ms(lambda: evaluate_pairs_reference(*args), reps=5),
         "library_ms": cuda_ms(lambda: evaluate_batch_from_topk(*dense_args))}
    densify_ms = cuda_ms(lambda: padded_rows_dense(padded_csr_from_sparse(test, dev), uids, K3_BLOCK["I"],
                                                   max_len=K3_BLOCK["max_test"]))
    t["bound_ms"], t["bound_by"] = k3_bound(args)
    B, K = args[0].shape
    print(f"  K3 B={B} K={K} I={K3_BLOCK['I']} cutoffs={K3_BLOCK['cutoffs']} "
          f"test pairs {int(args[2].indptr[-1])}: counters equal, worst error {worst:.3e} ({worst_rel:.3e} "
          f"relative), two runs "
          f"bitwise equal; {t['ms']:.4f} ms through the wrapper (both kernels and the counters' zeroing), "
          f"plain {t['plain_ms']:.4f} ms, the dense computation {t['library_ms']:.4f} ms (its dense test "
          f"block {densify_ms:.4f} ms more), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
          f"{100 * t['bound_ms'] / t['ms']:.1f}% of it  [{card}]")
    t["densify_ms"] = densify_ms
    from ganmf_tpu_torch.utils import profiling

    profiling.reset_counters()  # these launches are no path's
    return worst, {f"B={B} K={K} I={K3_BLOCK['I']} cutoffs={len(K3_BLOCK['cutoffs'])}": t}


def expected_csr_draws(p, n_rows):
    """(K2 launches an epoch, d minibatches, g minibatches) of a csr epoch:
    one launch a D minibatch for the PM mask and one a G minibatch for each
    of the ZR and PM masks the scheme draws."""
    d_n = -(-n_rows // p["d_batch_size"])
    g_n = -(-n_rows // p["g_batch_size"])
    pm, zr = p["scheme"] in ("ZP", "PM"), p["scheme"] in ("ZP", "ZR")
    return p["d_steps"] * d_n * pm + p["g_steps"] * g_n * (pm + zr), d_n, g_n


def cfgan_csr_copy(model, mode, train, cpu):
    """A CPU copy of a csr-trained CFGAN: its parameters and its csr storage."""
    from ganmf_tpu_torch.data.device import padded_csr_from_sparse
    from ganmf_tpu_torch.models import CFGAN
    from ganmf_tpu_torch.models import cfgan as pcf

    plain = CFGAN(train, mode=mode, seed=SEED, is_experiment=True, device=cpu)
    plain.config = dict(model.config)
    plain.params = pcf.params_from_jax([t.detach().cpu().numpy() for t in model.params.parameters()],
                                       CFGAN_PARAMS["g_layers"], cpu)
    plain._stream_seen = True
    plain._train_padded = padded_csr_from_sparse(plain._train_matrix(), cpu)
    return plain


def phase_cfgan_csr(dev, card, train, test):
    """CFGAN with urm_storage="csr" at its published LastFM width on the
    LastFM-shaped split, both modes: fits with early stopping (K2 and the
    keyed draw once a minibatch for each mask drawn), peak memory against
    the dense storage's, one epoch and one minibatch's masks card against
    CPU, the trained model's metrics against a CPU copy."""
    import torch

    from ganmf_tpu_torch.data.device import padded_csr_from_sparse
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import CFGAN
    from ganmf_tpu_torch.models import cfgan as pcf
    from ganmf_tpu_torch.ops import keyed

    cpu = torch.device("cpu")
    p = CFGAN_PARAMS
    for mode in ("user", "item"):
        mat = train.T.tocsr() if mode == "item" else train
        n_rows, n_cols = mat.shape
        per_epoch, d_n, g_n = expected_csr_draws(p, n_rows)
        print(f"[27] CFGAN csr storage, {mode} mode: {n_rows} x {n_cols}, g_nodes={p['g_nodes']}, "
              f"{CFGAN_CSR_EPOCHS} epochs with early stopping; {d_n} D and {g_n} G minibatches an epoch")
        # the fit's peak memory, as phase 9 read the dense storage's; the
        # previous mode's model is dropped before the base is read
        model = ev = None
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        model = timed(CFGAN)(train, mode=mode, seed=SEED, is_experiment=True, device=dev)
        ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
        drawn, epochs = _counter("keyed.launches"), CFGAN_CSR_EPOCHS
        model.fit(**p, epochs=epochs, urm_storage="csr", validation_evaluator=ev, freq=1, allow_worse=5)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        print(f"  peak device memory of the fit (validations included) above what was allocated before: "
              f"csr {peak / 2**20:.1f} MiB, dense {CFGAN_DENSE_PEAKS[mode] / 2**20:.1f} MiB (phase 9's "
              f"{CFGAN_EPOCHS}-epoch fit)  [{card}]")
        k2 = [n for _, n in model.epoch_log]
        if k2 != [per_epoch] * epochs or _counter("keyed.launches") - drawn != per_epoch * epochs:
            fail(f"csr {mode}: K2 launches per epoch {k2} and keyed draws {_counter("keyed.launches") - drawn}, "
                 f"expected {per_epoch} an epoch")
        print(f"  csr epochs: {[round(t, 4) for t, _ in model.epoch_log]} s; K2 and the keyed draw launched "
              f"{per_epoch} times an epoch (expected {per_epoch})  [{card}]")
        for t in model.params.parameters():
            if not bool(torch.isfinite(t).all()):
                fail(f"csr {mode}: a parameter is not finite after training")
        results, _ = ev.evaluateRecommender(model)
        presults, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(
            cfgan_csr_copy(model, mode, train, cpu))
        worst_m = worst_metric_diff(f"CFGAN csr {mode}", results, presults, METRIC_TOL)
        print(f"  trained csr model (streamed scoring{', cached penultimate activations' if mode == 'item' else ''}):"
              f" every metric within {worst_m:.3e} of its CPU copy (MAP@5 {results[5]['MAP']:.6f})")

        # one csr epoch and one minibatch's masks, card against CPU
        w = torch.from_numpy(padded_weights_for(n_rows, p))
        kw = dict(d_reg=p["d_reg"], g_reg=p["g_reg"], zr_ratio=p["zr_ratio"], zp_ratio=0.0,
                  zr_coefficient=p["zr_coefficient"], scheme=p["scheme"], d_hidden_act=p["d_hidden_act"],
                  g_hidden_act=p["g_hidden_act"], d_n_batches=d_n, d_batch=p["d_batch_size"], g_n_batches=g_n,
                  g_batch=p["g_batch_size"], d_steps=p["d_steps"], g_steps=p["g_steps"])
        g_dims = [n_cols] + [p["g_nodes"]] * p["g_layers"] + [n_cols]
        d_dims = [2 * n_cols] + [p["d_nodes"]] * p["d_layers"] + [1]
        runs, kept = [], []

        def row_uniforms(stream, rows):
            return keyed.keyed_uniforms(SEED, 1, stream, rows, n_cols)

        def card_draws(stream, rows):  # the card epoch's draws, kept for the CPU's
            u = row_uniforms(stream, rows)
            kept.append((stream, rows.cpu(), u.cpu()))
            return u

        def replay(stream, rows):
            want_stream, want_rows, u = kept.pop(0)
            if stream != want_stream or not torch.equal(rows, want_rows):
                fail(f"csr {mode}: the CPU epoch drew other rows than the card's")
            return u

        for d, epoch_draws in ((dev, card_draws), (cpu, replay)):
            pc = padded_csr_from_sparse(mat, d)
            # the masks from each device's own draw: the kernel on the card,
            # its plain version on the CPU
            masks = pcf.csr_batch_inputs(pc, n_rows, n_cols, (g_n - 1) * p["g_batch_size"], p["g_batch_size"],
                                         row_uniforms, zr_ratio=p["zr_ratio"], zp_ratio=0.0, scheme=p["scheme"],
                                         with_zr=True)
            params = pcf.init_params(g_dims, d_dims, torch.Generator().manual_seed(SEED), d)
            d_opt = torch.optim.Adam(params.D.parameters(), lr=p["d_lr"], betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
            g_opt = torch.optim.Adam(params.G.parameters(), lr=p["g_lr"], betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
            pcf.cfgan_epoch(params, d_opt, g_opt, pc, epoch_draws, w.to(d), w.to(d), **kw)
            runs.append(([m.cpu() for m in masks], [t.detach().cpu() for t in params.parameters()]))
        if kept:
            fail(f"csr {mode}: the CPU epoch drew {len(kept)} fewer times than the card's")
        for a, b in zip(runs[0][0], runs[1][0]):
            if not torch.equal(a, b):
                fail(f"csr {mode}: the last G minibatch's masks differ between the card and the CPU")
        n_g = 2 * (p["g_layers"] + 1)
        card_p, cpu_p = runs[0][1], runs[1][1]
        worst_g = adam_bound_check(f"csr {mode}", card_p[:n_g], cpu_p[:n_g], [(g_n, p["g_lr"])] * n_g)
        worst_d = adam_bound_check(f"csr {mode}", card_p[n_g:], cpu_p[n_g:], [(d_n, p["d_lr"])] * (len(card_p) - n_g))
        print(f"  one csr epoch from the same state and draws, card against CPU: the last G minibatch's masks "
              f"bitwise equal ({int(runs[0][0][2].sum())} ZR negatives, rows past {n_rows} zero); largest parameter "
              f"difference G {worst_g:.3e} (bound {2.2 * p['g_lr'] * g_n:.3e}), D {worst_d:.3e} "
              f"(bound {2.2 * p['d_lr'] * d_n:.3e})")


def padded_weights_for(n_rows, p):
    from ganmf_tpu_torch.models.gan_base import make_batches, padded_weights

    return padded_weights(n_rows, max(make_batches(n_rows, p["d_batch_size"])[1],
                                      make_batches(n_rows, p["g_batch_size"])[1]))


def ml20m_shaped_urm(dev, n_rows=ML20M_SHAPE[0]):
    """A 0/1 matrix of ML-20M's shape (SCALE20M.json) with about
    ML20M_NNZ entries, its cells drawn on the card from SEED (duplicates
    merged), as a host CSR."""
    import scipy.sparse as sps
    import torch

    n_cols = ML20M_SHAPE[1]
    g = torch.Generator(device=dev).manual_seed(SEED)
    cells = torch.randint(0, n_rows * n_cols, (int(ML20M_NNZ * n_rows / ML20M_SHAPE[0]),), generator=g, device=dev)
    cells = torch.unique(cells).cpu().numpy()
    rows, cols = cells // n_cols, cells % n_cols
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    return sps.csr_matrix((np.ones(len(cells), np.float32), cols.astype(np.int32), indptr), shape=(n_rows, n_cols))


def phase_cfgan_20m(dev, card):
    """One CFGAN csr epoch at the published width on a matrix of ML-20M's
    shape: the dense storage's planes (at least six [U, I] float32 planes,
    89 GB) pass the card's 80 GB; the csr storage holds O(nnz)."""
    import torch

    from ganmf_tpu_torch.models import CFGAN

    total = torch.cuda.get_device_properties(dev).total_memory
    t0 = time.perf_counter()
    train = ml20m_shaped_urm(dev)
    n_rows, n_cols = train.shape
    print(f"[28] CFGAN csr storage at ML-20M's shape: {n_rows} x {n_cols}, {train.nnz} entries (made on the "
          f"card from the seed in {time.perf_counter() - t0:.2f} s); the dense storage's six [U, I] float32 "
          f"planes would take {6 * 4 * n_rows * n_cols / 1e9:.1f} GB of the card's {total / 1e9:.1f} GB")
    per_epoch, d_n, g_n = expected_csr_draws(CFGAN_PARAMS, n_rows)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    model = timed(CFGAN)(train, seed=SEED, is_experiment=True, device=dev)
    drawn, t0 = _counter("keyed.launches"), time.perf_counter()
    model.fit(**CFGAN_PARAMS, epochs=1, urm_storage="csr")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    (epoch_s, k2), = model.epoch_log
    if k2 != per_epoch or _counter("keyed.launches") - drawn != per_epoch:
        fail(f"ML-20M csr: K2 launched {k2} times and the keyed draw {_counter("keyed.launches") - drawn}, expected {per_epoch}")
    if peak >= total:
        fail(f"ML-20M csr: peak device memory {peak / 1e9:.2f} GB is not under the card's {total / 1e9:.2f} GB")
    for t in model.params.parameters():
        if not bool(torch.isfinite(t).all()):
            fail("ML-20M csr: a parameter is not finite after the epoch")
    scores = model.score_device(torch.arange(8, device=dev))
    if scores.shape != (8, n_cols) or not bool(torch.isfinite(scores).all()):
        fail("ML-20M csr: the streamed scores are not finite")
    print(f"  one epoch ({d_n} D and {g_n} G minibatches; K2 and the keyed draw {per_epoch} times each): "
          f"{epoch_s:.4f} s, fit {fit_s:.2f} s; peak device memory {peak / 2**30:.2f} GiB, under the card's "
          f"{total / 2**30:.2f} GiB  [{card}]")


def phase_colblock(dev, card):
    """The column-blocked similarity build of a 0/1 matrix whose [I, I] Gram
    (17 GB) passes _GRAM_BYTE_LIMIT, by its int8 and its scatter form; 512
    target columns (256 across the first slab boundary, 256 in the shifted
    last slab) held bitwise against a float64 product of A with those
    columns, normalized and ranked with ties to the lowest id."""
    import scipy.sparse as sps
    import torch

    from ganmf_tpu_torch.ops import similarity as psim

    n_rows, n_cols = COLBLOCK_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED)
    A = torch.rand((n_rows, n_cols), generator=g, device=dev) < COLBLOCK_DENSITY
    rows, cols = (t.cpu().numpy() for t in A.nonzero(as_tuple=True))
    X = sps.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(n_rows, n_cols))
    width, int8 = psim.colblock_plan(-(-n_rows // psim._STREAM_CHUNK) * psim._STREAM_CHUNK, n_cols, True, dev)
    gram_gb = 4 * n_cols * n_cols / 1e9
    print(f"[29] column-blocked similarity: {n_rows} x {n_cols} 0/1, {X.nnz} entries; the dense A "
          f"({4 * n_rows * n_cols / 1e9:.2f} GB float32) passes _DENSE_A_BYTE_LIMIT and the Gram "
          f"({gram_gb:.1f} GB) _GRAM_BYTE_LIMIT; slabs of {width} columns, int8 form {int8}; cosine at "
          f"topK={ITEMKNN_TOPK}, shrink={ITEMKNN_SHRINK}")
    if not (4 * n_rows * n_cols > psim._DENSE_A_BYTE_LIMIT and 4 * n_cols * n_cols > psim._GRAM_BYTE_LIMIT):
        fail("the column-blocked phase's matrix does not take the column-blocked route")
    kw = dict(topK=ITEMKNN_TOPK, shrink=ITEMKNN_SHRINK)
    out, walls = {}, {}
    for form in ("int8", "scatter"):
        limit = psim._INT8_A_BYTE_LIMIT
        if form == "scatter":
            psim._INT8_A_BYTE_LIMIT = 0
        calls = []
        orig = {name: getattr(psim, name) for name in ("_slab_gram_int8", "_slab_gram_scatter")}
        for name, fn in orig.items():
            setattr(psim, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[form] = psim.compute_similarity(X, "cosine", device=dev, **kw)
            torch.cuda.synchronize()
            walls[form] = time.perf_counter() - t0
        finally:
            psim._INT8_A_BYTE_LIMIT = limit
            for name, fn in orig.items():
                setattr(psim, name, fn)
        if set(calls) != {f"_slab_gram_{form}"}:
            fail(f"column-blocked {form}: the slabs went through {sorted(set(calls))}")
        print(f"  {form} form: {len(calls)} slabs, {walls[form]:.3f} s (host preprocessing included), "
              f"{out[form].nnz} entries kept  [{card}]")
    if (out["int8"] != out["scatter"]).nnz:
        fail("the column-blocked build's int8 and scatter forms differ")

    ss2 = torch.from_numpy(np.asarray(X.sum(axis=0), np.float32).ravel()).to(dev)
    got = out["int8"].tocsc()
    for lo in (width - 128, n_cols - 256):
        sel = torch.arange(lo, lo + 256, device=dev)
        G64 = torch.zeros((n_cols, 256), dtype=torch.float64, device=dev)
        for r in range(0, n_rows, 4096):
            block = A[r : r + 4096].double()
            G64 += block.T @ block.index_select(1, sel)
        W = psim._w_block(G64.float(), ss2, ss2[lo : lo + 256], lo, n_rows, torch.ones(n_rows, device=dev),
                          "cosine", shrink=float(ITEMKNN_SHRINK), normalize=True, asymmetric_alpha=0.5,
                          tversky_alpha=1.0, tversky_beta=1.0, normalize_avg_row=False, distance_mode="lin",
                          use_row_weights=False)
        vals, ids = (t.cpu().numpy() for t in psim.tiled_topk(W.T, ITEMKNN_TOPK))
        keep = np.isfinite(vals) & (vals != 0)  # as the build's CSR assembly drops them
        indptr = np.zeros(257, np.int64)
        np.cumsum(keep.sum(1), out=indptr[1:])
        want = sps.csc_matrix((vals[keep], ids[keep], indptr), shape=(n_cols, 256))
        diff = (got[:, lo : lo + 256] != want).nnz
        if diff:
            fail(f"column-blocked: columns {lo}-{lo + 255} differ from the float64 product in {diff} entries")
    print(f"  512 target columns ({width - 128}-{width + 127} across the first slab boundary, "
          f"{n_cols - 256}-{n_cols - 1} in the shifted last slab) bitwise equal to the float64 product, "
          f"normalized and ranked with ties to the lowest id")


def phase_eval_extras(dev, card, train, test, model):
    """Diversity and negative-sample evaluation of the trained GANMF model
    (phase 7, user mode) on the card: the dense route, K1 not launched;
    every metric against a CPU copy."""
    import copy

    import scipy.sparse as sps
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout, EvaluatorNegativeItemSample
    from ganmf_tpu_torch.models import GANMF
    from ganmf_tpu_torch.ops import similarity as psim

    cpu = torch.device("cpu")
    div = psim.compute_similarity(train, "cosine", topK=ITEMKNN_TOPK, shrink=ITEMKNN_SHRINK, device=dev)
    rng = np.random.RandomState(SEED)
    keys = rng.rand(*train.shape)
    keys[(train + test).toarray() != 0] = np.inf  # negatives: neither trained nor tested
    neg_cols = np.argpartition(keys, EVAL_NEGATIVES, axis=1)[:, :EVAL_NEGATIVES]
    neg = sps.csr_matrix((np.ones(neg_cols.size, np.float32),
                          (np.repeat(np.arange(train.shape[0]), EVAL_NEGATIVES), neg_cols.ravel())),
                         shape=train.shape)
    plain = GANMF(train, seed=SEED, is_experiment=True, device=cpu)
    plain.params = copy.deepcopy(model.params).to(cpu)
    print(f"[30] evaluator extras on the trained GANMF (user mode): the diversity object (ItemKNN cosine "
          f"W, topK {ITEMKNN_TOPK}) and {EVAL_NEGATIVES} sampled negatives a user")
    for name, make in (("diversity", lambda d: EvaluatorHoldout(test, CUTOFFS, diversity_object=div, device=d)),
                       ("negative-sample", lambda d: EvaluatorNegativeItemSample(test, neg, CUTOFFS, device=d))):
        ev = make(dev)
        t0 = time.perf_counter()
        results, _ = ev.evaluateRecommender(model)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        presults, _ = make(cpu).evaluateRecommender(plain)
        worst = worst_metric_diff(f"{name} evaluation", results, presults, METRIC_TOL)
        extra = (f"DIVERSITY_SIMILARITY@10 {results[10]['DIVERSITY_SIMILARITY']:.6f}" if name == "diversity"
                 else f"MAP@5 {results[5]['MAP']:.6f}")
        print(f"  {name}: {len(ev.usersToEvaluate)} users in {secs:.4f} s; every metric within {worst:.3e} "
              f"of the CPU copy's; {extra}  [{card}]")


def phase_caae_dedup(dev, card, train):
    """One CAAE epoch with d_scatter="dedup" at the reference's ML-1M best
    params on the card against "direct" from the same state and draws
    (within CAAE_MOVE_SHARE of the distance each tensor moved), and an epoch
    whose D phase is cut to DEDUP_REPEAT_D_STEPS run twice, bitwise equal.
    Returns the number of epochs run (K2 launches once in each)."""
    import torch

    from ganmf_tpu_torch.data.device import dense_from_sparse
    from ganmf_tpu_torch.models import caae as pca

    p = CAAE_PARAMS
    n_users, n_items = train.shape
    coo = train.tocoo()
    n_chunks = int(np.ceil(coo.nnz / p["d_bsize"]))
    pad = n_chunks * p["d_bsize"] - coo.nnz
    inter = [torch.from_numpy(np.concatenate([a, np.zeros(pad, a.dtype)]).astype(np.int64)).to(dev)
             for a in (coo.row, coo.col)]
    weight = torch.from_numpy(np.concatenate([np.ones(coo.nnz, np.float32), np.zeros(pad, np.float32)])).to(dev)
    n_samples = max(1, 2 * int(np.median(np.ediff1d(train.indptr))))
    g_dims = [n_items] + [p["g_units"]] * p["g_layers"] + [n_items]
    urm = dense_from_sparse(train, dev)

    def epoch(form, d_steps):
        draws = pca.draw_epoch(torch.Generator().manual_seed(SEED + 3), torch.device("cpu"), len(weight), n_users,
                               n_items, d_steps * n_chunks * p["d_bsize"], 1, 1, 32, n_samples)
        draws = pca.CAAEDraws(*(t.to(dev) for t in draws))
        params = pca.init_params(n_users, n_items, p["num_factors"], g_dims, torch.Generator().manual_seed(SEED), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = pca.caae_epoch(params, urm, *inter, weight, draws, lr=p["lr"], beta=p["beta"], lmbda=0.5,
                                S=CAAE_S, d_bsize=p["d_bsize"], n_d_chunks=n_chunks, d_steps=d_steps,
                                g_steps=1, gpr_steps=1, m_batch=32, n_samples=n_samples, d_scatter=form)
        losses = [float(x) for x in losses]  # waits for the epoch
        secs = time.perf_counter() - t0
        if not np.isfinite(losses).all():
            fail(f"CAAE {form}: a loss is not finite: {losses}")
        return [t.detach().cpu() for t in params.parameters()], secs

    print(f"[31] CAAE d_scatter=\"dedup\": {2 * p['d_steps'] * n_chunks} D updates of {3 * p['d_bsize']} rows, "
          f"each sorted once an epoch, run sums by one cumulative sum, unique-index scatters")
    (dedup, dedup_s), (direct, direct_s) = epoch("dedup", p["d_steps"]), epoch("direct", p["d_steps"])
    init = pca.init_params(n_users, n_items, p["num_factors"], g_dims, torch.Generator().manual_seed(SEED),
                           torch.device("cpu"))
    worst = 0.0
    for i, (a, b, t0) in enumerate(zip(dedup, direct, init.parameters())):
        moved = float((b - t0.detach()).abs().max())
        diff = float((a - b).abs().max())
        if not (moved > 0 and diff <= CAAE_MOVE_SHARE * moved):
            fail(f"CAAE dedup: parameter {i} differs from direct by {diff:.3e}, which moved {moved:.3e}")
        worst = max(worst, diff / moved)
    (once, once_s), (again, again_s) = (epoch("dedup", DEDUP_REPEAT_D_STEPS) for _ in range(2))
    for i, (a, b) in enumerate(zip(once, again)):
        if not torch.equal(a, b):
            fail(f"CAAE dedup: two card runs differ in parameter {i}")
    print(f"  dedup against direct: every tensor within {worst:.3e} of the distance it moved (bound "
          f"{CAAE_MOVE_SHARE}); epoch {dedup_s:.4f} s dedup, {direct_s:.4f} s direct; two dedup epochs at "
          f"d_steps={DEDUP_REPEAT_D_STEPS} ({2 * DEDUP_REPEAT_D_STEPS * n_chunks} D updates) bitwise equal, "
          f"{once_s:.4f} / {again_s:.4f} s  [{card}]")
    return 4


def phase_host(scratch):
    """The host engine: its native library built with g++ under build/, and
    its parser against the Python path on a generated ratings file."""
    from ganmf_tpu_torch.data import reader
    from ganmf_tpu_torch.ops import host

    t0 = time.perf_counter()
    lib = host.get_lib()
    if lib is None:
        fail(f"the host engine's native library did not build: {host.build_error}")
    print(f"[32] host engine: {host.library_path().name} built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(version {lib.cf_host_version()})")
    rng = np.random.RandomState(SEED)
    n = HOST_PARSE_LINES
    path = os.path.join(scratch, "ratings.dat")
    cols = [rng.randint(1, 138494, n), rng.randint(1, 131263, n), rng.randint(1, 11, n) / 2,
            rng.randint(789652009, 1427784002, n)]
    with open(path, "w") as fh:
        fh.write("\n".join(f"{u}::{i}::{r}::{t}" for u, i, r, t in zip(*cols)) + "\n")
    t0 = time.perf_counter()
    native = host.parse_interactions_file(path, delimiter="::")
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = reader.parse_interactions_python(path, delimiter="::")
    python_s = time.perf_counter() - t0
    for a, b in zip(native, python):
        if not np.array_equal(a, b):
            fail("the native parser differs from the Python path")
    print(f"  parse_interactions_file on {n} lines: equal to the Python path; native {native_s:.3f} s, "
          f"Python {python_s:.3f} s")


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_fit(train, test, mode, dev, plan):
    """GANMF at its ML-1M best params for MESH_EPOCHS epochs with ``plan``
    (None: one card, no mesh), then evaluated by an evaluator on the same
    plan: (model, results, losses, fit seconds, evaluation seconds, K1
    launches in the evaluation, evaluator)."""
    import torch

    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import GANMF

    model = GANMF(train, mode=mode, seed=SEED, is_experiment=True, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(**GANMF_PARAMS, epochs=MESH_EPOCHS, mesh_plan=plan)
    losses = [(float(d), float(g)) for d, g in zip(model.train_d_loss, model.train_g_loss)]  # waits
    fit_s = time.perf_counter() - t0
    ev = EvaluatorHoldout(test, CUTOFFS, mesh_plan=plan, device=dev)
    before = _counter("k1.launches")
    t0 = time.perf_counter()
    results, _ = ev.evaluateRecommender(model)  # reads its sums to the host
    return model, results, losses, fit_s, time.perf_counter() - t0, _counter("k1.launches") - before, ev


def hold_mesh(name, params, losses, results, ref):
    """A mesh fit's full parameters, losses and metrics against the one-card
    fit ``ref`` from the same state and permutations: the Adam bound of
    phase 8, the losses within LOSS_RTOL, every metric within METRIC_TOL.
    Returns (largest parameter difference, largest metric difference)."""
    import torch

    ref_params, ref_losses, ref_results, n_rows = ref
    p = GANMF_PARAMS
    steps = -(-n_rows // p["batch_size"]) * MESH_EPOCHS
    worst = adam_bound_check(name, [torch.as_tensor(t).cpu() for t in params], ref_params,
                             [(steps, p["g_lr"])] * 2 + [(steps, p["d_lr"])] * 4)
    if not np.allclose(losses, ref_losses, rtol=LOSS_RTOL, atol=0):
        fail(f"{name}: the mean losses {losses} differ from the one-card fit's {ref_losses}")
    return worst, worst_metric_diff(name, results, ref_results, METRIC_TOL)


def phase_mesh_nccl(dev, card, train, test):
    """Phase 33: a world of one rank over NCCL on the card, GANMF's fit and
    evaluation with the mesh plan against the one-card path, both modes; then
    K1 on an item shard at phase 34's shape. Returns (the one-card user-mode
    reference, K1 launches on the mesh path, the shard's K1 error, its
    times)."""
    import torch
    import torch.distributed as dist

    from ganmf_tpu_torch.ops.scorer import masked_topk_scores
    from ganmf_tpu_torch.parallel import comm, make_mesh

    comm.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0, local_rank=dev.index, device=dev)
    refs, launches = {}, 0
    try:
        plan = make_mesh(device=dev)
        print(f"[33] GANMF on a mesh of one rank over {dist.get_backend()}: {GANMF_PARAMS}, {MESH_EPOCHS} "
              f"epoch(s) and the evaluation, each mode against the one-card path from the same state")
        if dist.get_backend() != "nccl" or plan.device != dev:
            fail(f"the one-rank mesh runs on {dist.get_backend()} on {plan.device}, not NCCL on {dev}")
        for mode in ("user", "item"):
            single, s_res, s_losses, s_fit, s_eval, _, _ = mesh_fit(train, test, mode, dev, None)
            ref = ([t.detach().cpu() for t in single.params.parameters()], s_losses, s_res,
                   single._train_matrix().shape[0])
            _reset_counters()
            t0 = time.perf_counter()
            model, res, losses, fit_s, eval_s, k1, _ = mesh_fit(train, test, mode, dev, plan)
            wall = time.perf_counter() - t0
            launches += _counter("k1.launches")
            if k1 == 0:
                fail(f"the one-rank mesh evaluation, {mode} mode, launched K1 {k1} times")
            full = [t.detach() for t in model._full_params().parameters()]
            worst, worst_m = hold_mesh(f"one-rank mesh {mode}", full, losses, res, ref)
            print(f"  {mode} mode: {fit_s / MESH_EPOCHS:.4f} s/epoch on the mesh ({s_fit / MESH_EPOCHS:.4f} "
                  f"one card); evaluation {eval_s:.4f} s ({s_eval:.4f}), K1 launches {k1}; losses {losses}; "
                  f"largest parameter difference {worst:.3e}, metrics within {worst_m:.3e}; phase wall "
                  f"{wall:.2f} s  [{card}]")
            if mode == "user":
                refs = ref, single
        ref, single = refs
        # K1 on the second item shard of phase 34's mesh: a data rank's rows
        U = single.params.user_emb.detach()[:MESH_SHARD_ROWS].contiguous()
        V = single.params.item_emb.detach()
        I_m = V.shape[0] // MESH_GLOO["n_model"]
        Vm = V[I_m:].contiguous()
        uids = torch.arange(MESH_SHARD_ROWS, device=dev)
        M = single.device_seen_rows(uids)[:, I_m:].contiguous()
        shard_err = compare_k1(f"mesh item shard (phase 34's shape, offset {I_m})", U, Vm, M, 50)
        _, ids = masked_topk_scores(U, Vm, M, 50)
        _, ids_at = masked_topk_scores(U, Vm, M, 50, id_offset=I_m)
        if not torch.equal(ids_at, ids + I_m):
            fail("K1 with id_offset did not return the shard's ids plus the offset")
        shard_t = time_k1(U, Vm, M, 50)
        print(f"  K1 on the item shard [{MESH_SHARD_ROWS}, {NUM_FACTORS}] x [{I_m}, {NUM_FACTORS}], k=50: "
              f"{shard_t['ms']:.4f} ms (plain {shard_t['plain_ms']:.4f}, library {shard_t['library_ms']:.4f}, "
              f"bound {shard_t['bound_ms']:.4f} by {shard_t['bound_by']}); global ids = shard ids + {I_m}  [{card}]")
    finally:
        comm.shutdown()
    return ref, launches, shard_err, shard_t


def mesh_worker(rank, world, port, out_dir):
    """A rank of phase 34: joins the gloo group on the one card, fits and
    evaluates GANMF on MESH_GLOO and writes its results (rank 0 also the
    gathered parameters) to out_dir."""
    import torch

    from ganmf_tpu_torch.ops import _build
    from ganmf_tpu_torch.parallel import comm, make_mesh

    comm.initialize(f"tcp://127.0.0.1:{port}", world, rank, local_rank=0, backend="gloo")
    try:
        plan = make_mesh(**MESH_GLOO)
        _build.load_library()  # built by the parent
        train, test = ml1m_split()
        _reset_counters()
        model, res, losses, fit_s, eval_s, k1, ev = mesh_fit(train, test, "user", plan.device, plan)
        launches = _counter("k1.launches")
        full = [t.detach().cpu().numpy() for t in model._full_params().parameters()]
        out = dict(losses=np.asarray(losses), fit_s=fit_s, eval_s=eval_s, k1=k1, launches=launches,
                   split=np.asarray(ev._item_split() or (0, 0)), keys=np.asarray(list(res[CUTOFFS[0]])),
                   values=np.asarray([list(res[c].values()) for c in CUTOFFS]),
                   local_rows=model.params.user_emb.shape[0])
        if rank == 0:
            out.update({f"p{i}": t for i, t in enumerate(full)})
    finally:
        comm.shutdown()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    return 0


def phase_mesh_gloo(dev, card, ref):
    """Phase 34: four ranks that share the one card over gloo, mesh
    MESH_GLOO, GANMF's fit and evaluation against the one-card path. gloo
    stages every collective through the host: the wall is no multi-card
    figure. Returns (K1 launches summed over the ranks, seconds per epoch)."""
    world = MESH_GLOO["n_data"] * MESH_GLOO["n_model"]
    out_dir = os.path.abspath(os.path.join(SCRATCH, "mesh"))
    os.makedirs(out_dir, exist_ok=True)
    print(f"[34] GANMF on a mesh {MESH_GLOO} of {world} ranks sharing the card over gloo, {MESH_EPOCHS} epoch(s) "
          f"and the evaluation, against the one-card path (gloo stages its collectives through the host: "
          f"this is no multi-card measurement)")
    port = free_port()
    t0 = time.perf_counter()
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r), str(world),
                               str(port), out_dir], stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.perf_counter() + MESH_RANK_TIMEOUT
    try:
        for proc in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for r, (proc, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode != 0:
            fail(f"rank {r} of the gloo mesh exited {proc.returncode}:\n{text[-3000:]}")
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]
    keys = [str(k) for k in ranks[0]["keys"]]
    results = {c: dict(zip(keys, ranks[0]["values"][ci])) for ci, c in enumerate(CUTOFFS)}
    worst, worst_m = hold_mesh("gloo mesh", [ranks[0][f"p{i}"] for i in range(6)],
                               [tuple(x) for x in ranks[0]["losses"]], results, ref)
    for r, out in enumerate(ranks):
        i0, i1 = (int(x) for x in out["split"])
        if int(out["k1"]) == 0 or i1 - i0 != ref[0][1].shape[0] // MESH_GLOO["n_model"]:
            fail(f"rank {r} of the gloo mesh launched K1 {int(out['k1'])} times on items [{i0}, {i1})")
        if not np.array_equal(out["values"], ranks[0]["values"]):
            fail(f"rank {r} of the gloo mesh finalized other metrics than rank 0")
        print(f"  rank {r}: {float(out['fit_s']) / MESH_EPOCHS:.4f} s/epoch, evaluation "
              f"{float(out['eval_s']):.4f} s, K1 launches {int(out['k1'])} on items [{i0}, {i1}), "
              f"{int(out['local_rows'])} user rows held  [{card}, gloo]")
    secs = max(float(out["fit_s"]) for out in ranks) / MESH_EPOCHS
    print(f"  losses {ranks[0]['losses'].tolist()}; largest parameter difference {worst:.3e}, metrics within "
          f"{worst_m:.3e} of the one-card path; phase wall {wall:.2f} s (the ranks' start-up included)")
    return sum(int(out["launches"]) for out in ranks), secs


# -- phases 35-36: DisGANMF, CFGAN (dense and csr) and CAAE on a mesh ------------

#: name: (split, model, fit keywords); one epoch each (MESH_EPOCHS)
GAN_MESH_FITS = {
    "DisGANMF": ("lastfm", "DisGANMF", dict(DISGANMF_PARAMS)),
    "CFGAN dense": ("lastfm", "CFGAN", dict(CFGAN_PARAMS)),
    "CFGAN csr": ("lastfm", "CFGAN", dict(CFGAN_PARAMS, urm_storage="csr")),
    "CAAE dedup": ("ml1m", "CAAE", dict(CAAE_PARAMS, d_scatter="dedup")),
}
#: K2 at a data rank's shapes on phase 36's mesh: CFGAN dense's rows of the
#: padded LastFM URM (2048 / 2) and CAAE's Nu chunk (32 users / 2)
MESH_K2_SHAPES = ((1024, 17632, "uniform", CFGAN_PARAMS["zr_ratio"], 0.00279), (16, 3706, "gumbel", CAAE_S, 0.0446))


def gan_split(which):
    return lastfm_split() if which == "lastfm" else ml1m_split()


def gan_mesh_fit(name, train, test, dev, plan):
    """One of GAN_MESH_FITS for MESH_EPOCHS epochs with ``plan`` (None: one
    card), then evaluated on the same plan: (model, results, fit seconds,
    evaluation seconds, K1 launches in the evaluation, the masks K2 drew in
    the fit)."""
    import torch

    from ganmf_tpu_torch import models
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import cfgan as pcf

    _, kind, params = GAN_MESH_FITS[name]
    model = getattr(models, kind)(train, seed=SEED, is_experiment=True, device=dev)
    masks, draw = [], pcf.smallest_k_mask
    pcf.smallest_k_mask = lambda keys, k: masks.append(draw(keys, k)) or masks[-1]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(**params, epochs=MESH_EPOCHS, mesh_plan=plan)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        pcf.smallest_k_mask = draw
    ev = EvaluatorHoldout(test, CUTOFFS, mesh_plan=plan, device=dev)
    before = _counter("k1.launches")
    t0 = time.perf_counter()
    results, _ = ev.evaluateRecommender(model)  # reads its sums to the host
    return model, results, fit_s, time.perf_counter() - t0, _counter("k1.launches") - before, masks


def gan_steps_lrs(name, n_rows, n_params):
    """(Adam steps in MESH_EPOCHS epochs, lr) of each parameter of an Adam
    model of GAN_MESH_FITS, in ``parameters()`` order."""
    _, kind, p = GAN_MESH_FITS[name]
    if kind == "DisGANMF":
        steps = -(-n_rows // p["batch_size"]) * MESH_EPOCHS
        return [(steps, p["g_lr"])] * 2 + [(steps, p["d_lr"])] * (n_params - 2)
    d_n, g_n = -(-n_rows // p["d_batch_size"]), -(-n_rows // p["g_batch_size"])
    n_g = 2 * (p["g_layers"] + 1)
    return [(g_n * MESH_EPOCHS, p["g_lr"])] * n_g + [(d_n * MESH_EPOCHS, p["d_lr"])] * (n_params - n_g)


def hold_gan_params(name, params, ref):
    """A mesh fit's full parameters against the one-card fit ``ref`` =
    (parameters, results, initial parameters, training rows) from the same
    state and draws: the Adam bound of phase 8 (CAAE, plain SGD: every tensor
    within CAAE_MOVE_SHARE of the distance it moved). Returns the largest
    parameter difference (CAAE: share)."""
    import torch

    ref_params, _, init, n_rows = ref
    params = [torch.as_tensor(t).cpu() for t in params]
    if GAN_MESH_FITS[name][1] == "CAAE":
        worst = 0.0
        for i, (a, b, t0) in enumerate(zip(params, ref_params, init)):
            moved, diff = float((b - t0).abs().max()), float((a - b).abs().max())
            if not (moved > 0 and diff <= CAAE_MOVE_SHARE * moved):
                fail(f"{name}: parameter {i} differs by {diff:.3e} from the one-card fit's, which moved {moved:.3e}")
            worst = max(worst, diff / moved)
    else:
        worst = adam_bound_check(name, params, ref_params, gan_steps_lrs(name, n_rows, len(params)))
    return worst


def metric_gaps(results, ref_results):
    """(largest difference between two evaluations, the metric and cutoff
    where it lies)."""
    return max((abs(results[c][m] - ref_results[c][m]), f"{m}@{c}") for c in CUTOFFS for m in results[c])


def phase_gan_mesh_nccl(dev, card):
    """Phase 35: a world of one rank over NCCL on the card; DisGANMF, CFGAN
    (dense, csr) and CAAE (dedup) fit one epoch and evaluate with the plan,
    each against the one-card path from the same state, with each path's K1,
    K2 and keyed-draw counts set to 0 just before its mesh run and read just
    after; then K2 at phase 36's per-rank shapes. Returns (the one-card
    references, the launches by fit, K2's error and times)."""
    import torch
    import torch.distributed as dist

    from ganmf_tpu_torch.ops.select import smallest_k_mask_cuda
    from ganmf_tpu_torch.ops.topk import smallest_k_mask_reference
    from ganmf_tpu_torch.parallel import comm, make_mesh

    comm.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0, local_rank=dev.index, device=dev)
    refs, launches = {}, {}
    try:
        plan = make_mesh(device=dev)
        if dist.get_backend() != "nccl" or plan.device != dev:
            fail(f"the one-rank mesh runs on {dist.get_backend()} on {plan.device}, not NCCL on {dev}")
        print(f"[35] DisGANMF, CFGAN (dense, csr) and CAAE on a mesh of one rank over {dist.get_backend()}: "
              f"{MESH_EPOCHS} epoch(s) and the evaluation each, against the one-card path from the same state")
        for name, (which, kind, params) in GAN_MESH_FITS.items():
            train, test = gan_split(which)
            single, s_res, s_fit, s_eval, _, s_masks = gan_mesh_fit(name, train, test, dev, None)
            init = [t.detach() for t in _gan_init(single)]
            ref = ([t.detach().cpu() for t in single.params.parameters()], s_res, init,
                   single._train_matrix().shape[0])
            del single
            _reset_counters()
            t0 = time.perf_counter()
            model, res, fit_s, eval_s, k1, masks = gan_mesh_fit(name, train, test, dev, plan)
            wall = time.perf_counter() - t0
            launches[name] = (_counter("k1.launches"), _counter("k2.launches"), _counter("keyed.launches"))
            want_k2 = kind != "DisGANMF"
            if (k1 == 0) == (kind == "DisGANMF") or (_counter("k2.launches") == 0) == want_k2 or (
                    (_counter("keyed.launches") == 0) == ("csr" in name)):
                fail(f"the one-rank mesh's {name} path launched K1 {k1} times in its evaluation, K2 "
                     f"{_counter("k2.launches")} times and the keyed draw {_counter("keyed.launches")} times")
            if kind == "CFGAN":
                if len(masks) != len(s_masks) or not all(torch.equal(a, b) for a, b in zip(masks, s_masks)):
                    fail(f"{name}: the mesh's {len(masks)} masks are not bitwise the one-card path's {len(s_masks)}")
            full = [t.detach() for t in model._full_params().parameters()]
            worst = hold_gan_params(name, full, ref)
            worst_m = worst_metric_diff(name, res, s_res, METRIC_TOL)
            refs[name] = ref
            what = "share of the distance moved" if kind == "CAAE" else "parameter difference"
            mask_note = f"{len(masks)} K2 masks bitwise the one-card path's; " if kind == "CFGAN" else ""
            print(f"  {name}: {fit_s / MESH_EPOCHS:.4f} s/epoch on the mesh ({s_fit / MESH_EPOCHS:.4f} one card); "
                  f"evaluation {eval_s:.4f} s ({s_eval:.4f}); launches K1 {k1} (evaluation), K2 {_counter("k2.launches")}, "
                  f"keyed draw {_counter("keyed.launches")}; {mask_note}largest {what} {worst:.3e}, metrics within "
                  f"{worst_m:.3e}; phase wall {wall:.2f} s  [{card}]")
            del model
    finally:
        comm.shutdown()
    g = torch.Generator().manual_seed(SEED + 35)
    worst, times = 0.0, {}
    for R, I, kind, ratio, density in MESH_K2_SHAPES:
        keys, k = (t.to(dev) for t in select_case(kind, R, I, g, ratio=ratio, density=density))
        if not torch.equal(smallest_k_mask_cuda(keys, k), smallest_k_mask_reference(keys, k)):
            worst = 1.0
            fail(f"K2 at phase 36's per-rank shape [{R}, {I}] differs from its plain version")
        t = times[f"mesh rank [{R}, {I}]"] = time_k2(keys, k)
        print(f"  K2 at phase 36's per-rank shape [{R}, {I}] ({kind} keys): bitwise its plain version; "
              f"{t['ms']:.4f} ms (launch {t['launch_ms']:.4f}, plain {t['plain_ms']:.4f}, bound "
              f"{t['bound_ms']:.4f} by {t['bound_by']})  [{card}]")
    return refs, launches, worst, times


def _gan_init(model):
    """The initial parameters of a fit of ``model``'s class from SEED, on
    the CPU (every fit draws them on the host from a seeded generator)."""
    import torch

    from ganmf_tpu_torch.models import caae as pca
    from ganmf_tpu_torch.models import cfgan as pcf
    from ganmf_tpu_torch.models import disganmf as pdg

    cpu, gen = torch.device("cpu"), torch.Generator().manual_seed(SEED)
    kind = type(model).__name__
    cfg = model.config
    n_rows, n_cols = model._train_matrix().shape
    if kind == "DisGANMF":
        return list(pdg.init_params(n_rows, n_cols, cfg["num_factors"], cfg["d_layers"], cfg["d_nodes"], gen,
                                    cpu).parameters())
    if kind == "CFGAN":
        g_dims = [n_cols] + [cfg["g_nodes"]] * cfg["g_layers"] + [n_cols]
        d_dims = [2 * n_cols] + [cfg["d_nodes"]] * cfg["d_layers"] + [1]
        return list(pcf.init_params(g_dims, d_dims, gen, cpu).parameters())
    g_dims = [n_cols] + [cfg["g_units"]] * cfg["g_layers"] + [n_cols]
    return list(pca.init_params(n_rows, n_cols, cfg["num_factors"], g_dims, gen, cpu).parameters())


def gan_one_card_copy(name, params, dev):
    """A one-card model of GAN_MESH_FITS[name] holding the full ``params``
    (numpy arrays in ``parameters()`` order)."""
    from ganmf_tpu_torch import models
    from ganmf_tpu_torch.models import caae as pca
    from ganmf_tpu_torch.models import cfgan as pcf
    from ganmf_tpu_torch.models import disganmf as pdg

    which, kind, p = GAN_MESH_FITS[name]
    model = getattr(models, kind)(gan_split(which)[0], seed=SEED, is_experiment=True, device=dev)
    model.config = dict(p)
    if kind == "DisGANMF":
        model.params = pdg.params_from_jax(params, dev)
    elif kind == "CFGAN":
        model.params = pcf.params_from_jax(params, p["g_layers"], dev)
    else:
        model.params = pca.params_from_jax(params, dev)
    return model


def gan_mesh_worker(rank, world, port, out_dir):
    """A rank of phase 36: joins the gloo group on the one card, fits and
    evaluates each of GAN_MESH_FITS on MESH_GLOO and writes its results (rank
    0 also the gathered parameters) to out_dir, one file a fit."""
    import torch

    from ganmf_tpu_torch.ops import _build
    from ganmf_tpu_torch.parallel import comm, make_mesh

    comm.initialize(f"tcp://127.0.0.1:{port}", world, rank, local_rank=0, backend="gloo")
    try:
        plan = make_mesh(**MESH_GLOO)
        _build.load_library()  # built by the parent
        for i, (name, (which, _, _)) in enumerate(GAN_MESH_FITS.items()):
            train, test = gan_split(which)
            _reset_counters()
            model, res, fit_s, eval_s, k1, masks = gan_mesh_fit(name, train, test, plan.device, plan)
            out = dict(fit_s=fit_s, eval_s=eval_s, k1=k1, k2=_counter("k2.launches"), keyed=_counter("keyed.launches"),
                       keys=np.asarray(list(res[CUTOFFS[0]])), values=np.asarray([list(res[c].values()) for c in CUTOFFS]),
                       local_bytes=sum(t.numel() * t.element_size() for t in model.params.parameters()))
            full = [t.detach().cpu().numpy() for t in model._full_params().parameters()]
            if rank == 0:
                out.update({f"p{j}": t for j, t in enumerate(full)})
            np.savez(os.path.join(out_dir, f"gan{i}_rank{rank}.npz"), **out)
            del model, masks
            torch.cuda.empty_cache()
    finally:
        comm.shutdown()
    return 0


def phase_gan_mesh_gloo(dev, card, refs):
    """Phase 36: four ranks that share the one card over gloo, mesh
    MESH_GLOO, the fits and evaluations of phase 35 against its one-card
    references. gloo stages every collective through the host: the walls are
    no multi-card figure. Returns the launches by fit, summed over the ranks."""
    from ganmf_tpu_torch.eval import EvaluatorHoldout

    world = MESH_GLOO["n_data"] * MESH_GLOO["n_model"]
    out_dir = os.path.abspath(os.path.join(SCRATCH, "gan_mesh"))
    os.makedirs(out_dir, exist_ok=True)
    print(f"[36] DisGANMF, CFGAN (dense, csr) and CAAE on a mesh {MESH_GLOO} of {world} ranks sharing the card "
          f"over gloo, {MESH_EPOCHS} epoch(s) and the evaluation each, against phase 35's one-card path (gloo "
          f"stages its collectives through the host: this is no multi-card measurement)")
    port = free_port()
    t0 = time.perf_counter()
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gan-mesh-rank", str(r), str(world),
                               str(port), out_dir], stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.perf_counter() + GAN_MESH_RANK_TIMEOUT
    try:
        for proc in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for r, (proc, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode != 0:
            fail(f"rank {r} of the gloo mesh exited {proc.returncode}:\n{text[-3000:]}")
    launches = {}
    for i, (name, (_, kind, _)) in enumerate(GAN_MESH_FITS.items()):
        ranks = [dict(np.load(os.path.join(out_dir, f"gan{i}_rank{r}.npz"))) for r in range(world)]
        keys = [str(k) for k in ranks[0]["keys"]]
        results = {c: dict(zip(keys, ranks[0]["values"][ci])) for ci, c in enumerate(CUTOFFS)}
        n_params = sum(1 for k in ranks[0] if k.startswith("p"))
        full = [ranks[0][f"p{j}"] for j in range(n_params)]
        worst = hold_gan_params(name, full, refs[name])
        # the mesh evaluator against the one-card evaluator on the same
        # parameters; the gap to phase 35's fit, whose parameters differ by
        # the rounding the bound above admits, is printed
        single = gan_one_card_copy(name, full, dev)
        which = GAN_MESH_FITS[name][0]
        one, _ = EvaluatorHoldout(gan_split(which)[1], CUTOFFS, device=dev).evaluateRecommender(single)
        worst_m = worst_metric_diff(name, results, one, METRIC_TOL)
        gap, where = metric_gaps(results, refs[name][1])
        del single
        for r, out in enumerate(ranks):
            if not np.array_equal(out["values"], ranks[0]["values"]):
                fail(f"rank {r} of the gloo mesh finalized other metrics than rank 0 for {name}")
        k1, k2, drawn = (sum(int(out[key]) for out in ranks) for key in ("k1", "k2", "keyed"))
        if (k1 == 0) == (kind == "DisGANMF") or (k2 == 0) == (kind != "DisGANMF") or (drawn == 0) == ("csr" in name):
            fail(f"the gloo mesh's {name} path launched K1 {k1} times, K2 {k2} times and the keyed draw {drawn} times")
        launches[name] = (k1, k2, drawn)
        secs = max(float(out["fit_s"]) for out in ranks) / MESH_EPOCHS
        held = max(int(out["local_bytes"]) for out in ranks)
        what = "share of the distance moved" if kind == "CAAE" else "parameter difference"
        print(f"  {name}: {secs:.4f} s/epoch (the slowest rank), evaluation "
              f"{max(float(out['eval_s']) for out in ranks):.4f} s; launches over the ranks K1 {k1}, K2 {k2}, "
              f"keyed draw {drawn}; parameter bytes held by a rank {held} of {sum(t.nbytes for t in refs[name][0])}; "
              f"largest {what} {worst:.3e} against phase 35's one-card fit; metrics within {worst_m:.3e} of a "
              f"one-card evaluation of the same parameters, {gap:.3e} of phase 35's fit ({where})  [{card}, gloo]")
    print(f"  phase wall {wall:.2f} s (the ranks' start-up included)")
    return launches


# -- phases 37-38: IALS, MF-SGD and SLIM-BPR on a mesh, the distributed-Cholesky
# EASE-R and the sharded similarity build ------------------------------------------

#: one epoch each (MESH_EPOCHS): IALS at the committed LastFM params on the
#: LastFM-shaped split (dense, then csr with the flat route forced), MF-SGD BPR
#: at the JAX fit's defaults on the ML-1M-shaped split (phase 22), SLIM-BPR at
#: phase 19's params
BASELINE_MESH_FITS = ("IALS dense", "IALS flat csr", "MF-SGD BPR", "SLIM-BPR")
# MF-SGD's mesh epoch (one-card reference and mesh alike) draws a quarter of
# the default max(U, nnz / 4) samples: on 4 gloo ranks each chunk pays two
# host-staged collectives, and the whole epoch took 17 s of phase 38
MESH_MF_SGD_SAMPLES = 50_000
BASELINE_MESH_RANK_TIMEOUT = 600  # phase 38's ranks: four fits, three evaluations, EASE-R, ItemKNN
EASE_MESH_RTOL, EASE_MESH_ATOL_SHARE = 1e-4, 1e-5  # tests/test_torch_extras.py's bound on a pruned W


def baseline_split(name):
    return ml1m_split() if name.startswith("MF-SGD") else lastfm_split()


def baseline_mesh_fit(name, train, test, dev, plan):
    """One of BASELINE_MESH_FITS with ``plan`` (None: one card, no mesh),
    then, but for SLIM-BPR, evaluated by an evaluator on the same plan:
    (model, the full result tensors on the card, fit seconds, evaluation
    seconds, K1's launches in the evaluation, its results or None)."""
    import torch

    from ganmf_tpu_torch import models
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import ials

    if name.startswith("IALS"):
        model = models.IALSRecommender(train, device=dev)
        params = dict(ials_best_params(), urm_storage="csr" if "csr" in name else "dense")
    elif name.startswith("MF-SGD"):
        model = models.MatrixFactorization_BPR(train, device=dev)
        params = dict(MF_SGD_PARAMS, samples_per_epoch=MESH_MF_SGD_SAMPLES)
    else:
        model = models.SLIM_BPR(train, device=dev)
        params = similarity_best_params("SLIM_BPR_Recommender__LastFM")
    params["epochs"] = MESH_EPOCHS
    limit = ials._PAD_PLANE_BYTE_LIMIT
    if "flat" in name:
        ials._PAD_PLANE_BYTE_LIMIT = 1  # the flat route forced for both orientations
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(**params, mesh_plan=plan)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        ials._PAD_PLANE_BYTE_LIMIT = limit
    if "flat" in name and (model._store_users[0], model._store_items[0]) != ("flat", "flat"):
        fail(f"{name}: the storage is {model._store_users[0]} / {model._store_items[0]}, not flat")
    if name == "SLIM-BPR":
        return model, [model._full_w(model._state.W)], fit_s, 0.0, 0, None
    ev = EvaluatorHoldout(test, CUTOFFS, mesh_plan=plan, device=dev)
    before = _counter("k1.launches") - _counter("k1.wide_launches")
    t0 = time.perf_counter()
    results, _ = ev.evaluateRecommender(model)  # reads its sums to the host
    eval_s = time.perf_counter() - t0
    k1 = _counter("k1.launches") - _counter("k1.wide_launches") - before
    factors = [model._on_device(model._USER_factors_store), model._on_device(model._ITEM_factors_store)]
    return model, factors, fit_s, eval_s, k1, results


def hold_baseline(name, got, want, summed):
    """A mesh fit's full tensors against the one-card fit's from the same
    state and draws, with the port's one-card bounds: IALS dense within
    IALS_RTOL / IALS_ATOL, or, where the Gram is ``summed`` over item shards
    (another float32 order, whose CG exits may differ), each row within
    IALS_ROW_GAP of its norm; flat-CSR IALS bitwise; MF-SGD within
    MF_EPOCH_ATOL and SLIM-BPR's W within SLIM_EPOCH_ATOL (index_add_'s
    atomics). Returns the largest difference (IALS summed: the row gap)."""
    import torch

    worst = 0.0
    for a, b in zip(got, want):
        a, b = torch.as_tensor(a).to(b.device), b
        if name == "IALS flat csr":
            if not torch.equal(a, b):
                fail(f"{name}: the mesh fit is not bitwise the one-card flat fit "
                     f"(largest difference {float((a - b).abs().max()):.3e})")
        elif name == "IALS dense" and summed:
            gap = float(((a - b).abs().amax(1) / torch.linalg.norm(b, dim=1).clamp_min(1e-30)).max())
            if gap > IALS_ROW_GAP:
                fail(f"{name}: a factor row differs from the one-card fit's by {gap:.3e} of its norm > {IALS_ROW_GAP}")
            worst = max(worst, gap)
            continue
        elif name == "IALS dense":
            if not torch.allclose(a, b, rtol=IALS_RTOL, atol=IALS_ATOL):
                fail(f"{name}: the mesh fit differs from the one-card fit beyond rtol {IALS_RTOL} / atol {IALS_ATOL}")
        else:
            gate = MF_EPOCH_ATOL if name.startswith("MF-SGD") else SLIM_EPOCH_ATOL
            gap = float((a - b).abs().max())
            if gap > gate:
                fail(f"{name}: the mesh fit differs from the one-card fit by {gap:.3e} > {gate}")
        worst = max(worst, float((a - b).abs().max()))
    return worst


def hold_pruned_w(name, g, w):
    """A pruned EASE-R W against another: the same count of entries in every
    column, the entries both keep within EASE_MESH_RTOL plus
    EASE_MESH_ATOL_SHARE of max|w|, an entry kept by one only within that of
    the other's column edge (tests/test_torch_extras.py's bound). Returns
    (largest difference, entries kept by one only)."""
    atol = EASE_MESH_ATOL_SHARE * float(np.abs(w).max())
    if not np.array_equal((g != 0).sum(0), (w != 0).sum(0)):
        fail(f"{name}: the pruned W keeps another count of entries in some column than the one-card W")
    both = (g != 0) & (w != 0)
    if not np.all(np.abs(g[both] - w[both]) <= atol + EASE_MESH_RTOL * np.abs(w[both])):
        fail(f"{name}: the pruned W differs from the one-card W beyond rtol {EASE_MESH_RTOL} + atol {atol:.3e}")
    only = 0
    for a, b in ((g, w), (w, g)):
        lone = (a != 0) & (b == 0)
        only += int(lone.sum())
        edge = np.where(b != 0, b, np.inf).min(0)
        r, c = np.nonzero(lone)
        if not np.all(np.abs(a[r, c] - edge[c]) <= atol + EASE_MESH_RTOL * np.abs(edge[c])):
            fail(f"{name}: the pruned W keeps an entry the one-card W does not, beyond a near tie")
    return float(np.abs(g[both] - w[both]).max()), only


def phase_baseline_mesh_nccl(dev, card):
    """Phase 37: a world of one rank over NCCL on the card; IALS (dense, then
    flat csr), MF-SGD BPR and SLIM-BPR fit one epoch with the plan, each
    against the one-card fit from the same state and draws, IALS's and
    MF-SGD's evaluations on the plan through K1 against the one-card
    evaluation, each path's counts set to 0 just before its mesh run and
    read just after; then ``ease_r_topk_sharded`` on the plan at ML-1M's
    3706 items against the one-card EASE-R, both timed. Returns (the one-card
    references, K1's launches by fit)."""
    import torch
    import torch.distributed as dist

    from ganmf_tpu_torch.data.device import dense_from_sparse
    from ganmf_tpu_torch.models.extras import ease_r_weights_topk
    from ganmf_tpu_torch.ops.distchol import ease_r_topk_sharded
    from ganmf_tpu_torch.ops.topk import scatter_col_topk_dense
    from ganmf_tpu_torch.parallel import comm, make_mesh

    comm.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0, local_rank=dev.index, device=dev)
    refs, launches = {}, {}
    try:
        plan = make_mesh(device=dev)
        if dist.get_backend() != "nccl" or plan.device != dev:
            fail(f"the one-rank mesh runs on {dist.get_backend()} on {plan.device}, not NCCL on {dev}")
        print(f"[37] IALS (dense, flat csr), MF-SGD BPR and SLIM-BPR on a mesh of one rank over "
              f"{dist.get_backend()}: {MESH_EPOCHS} epoch(s) each and IALS's and MF-SGD's evaluations, against the "
              f"one-card path from the same state and draws")
        for name in BASELINE_MESH_FITS:
            train, test = baseline_split(name)
            single, want, s_fit, s_eval, _, s_res = baseline_mesh_fit(name, train, test, dev, None)
            refs[name] = ([t.cpu() for t in want], s_res)
            del single
            _reset_counters()
            t0 = time.perf_counter()
            model, got, fit_s, eval_s, k1, res = baseline_mesh_fit(name, train, test, dev, plan)
            wall = time.perf_counter() - t0
            if _counter("k2.launches") or _counter("keyed.launches") or (k1 == 0) != (name == "SLIM-BPR"):
                fail(f"the one-rank mesh's {name} path launched K1 {k1} times in its evaluation, K2 "
                     f"{_counter("k2.launches")} times and the keyed draw {_counter("keyed.launches")} times")
            launches[name] = k1
            worst = hold_baseline(name, got, want, summed=False)
            metrics = ""
            if res is not None:
                metrics = (f"; evaluation {eval_s:.4f} s ({s_eval:.4f}), K1 launches {k1}, metrics within "
                           f"{worst_metric_diff(name, res, s_res, METRIC_TOL):.3e}")
            print(f"  {name}: {fit_s / MESH_EPOCHS:.4f} s/epoch on the mesh ({s_fit / MESH_EPOCHS:.4f} one card)"
                  f"{metrics}; largest difference {worst:.3e}; phase wall {wall:.2f} s  [{card}]")
            del model, got, want
            torch.cuda.empty_cache()
        # the distributed Cholesky on this plan at ML-1M's items
        train, _ = ml1m_split()
        A = dense_from_sparse(train, dev)
        times = {}
        for what, run in (("one card", lambda: ease_r_weights_topk(A, EASE_L2, EASE_TOPK)),
                          ("ease_r_topk_sharded", lambda: ease_r_topk_sharded(A, EASE_L2, EASE_TOPK, plan))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals, idx = run()
            torch.cuda.synchronize()
            times[what] = (time.perf_counter() - t0, scatter_col_topk_dense(vals, idx).cpu().numpy())
        gap, only = hold_pruned_w("ease_r_topk_sharded", times["ease_r_topk_sharded"][1], times["one card"][1])
        refs["EASE-R"] = times["one card"][1]
        print(f"  ease_r_topk_sharded on the one-rank plan, {train.shape[0]} x {train.shape[1]}, l2_norm {EASE_L2}, "
              f"topK {EASE_TOPK}, panels of 256 ({-(-train.shape[1] // 256)} panels): "
              f"{times['ease_r_topk_sharded'][0]:.4f} s (the one-card fit {times['one card'][0]:.4f} s); W within "
              f"{gap:.3e} of the one-card W, {only} entries kept by one only  [{card}]")
    finally:
        comm.shutdown()
    return refs, launches


def baseline_mesh_worker(rank, world, port, out_dir):
    """A rank of phase 38: joins the gloo group on the one card, fits (and
    evaluates) each of BASELINE_MESH_FITS on MESH_GLOO, then EASE-R and
    ItemKNN cosine through their sharded builds, and writes its results (rank
    0 also the full tensors, SLIM-BPR's W as its gap to the one-card W
    that main wrote) to out_dir, one file a fit."""
    import torch

    from ganmf_tpu_torch import models
    from ganmf_tpu_torch.ops import _build
    from ganmf_tpu_torch.parallel import comm, make_mesh

    comm.initialize(f"tcp://127.0.0.1:{port}", world, rank, local_rank=0, backend="gloo")
    try:
        plan = make_mesh(**MESH_GLOO)
        _build.load_library()  # built by the parent
        for i, name in enumerate(BASELINE_MESH_FITS):
            train, test = baseline_split(name)
            _reset_counters()
            model, got, fit_s, eval_s, k1, res = baseline_mesh_fit(name, train, test, plan.device, plan)
            out = dict(fit_s=fit_s, eval_s=eval_s, k1=k1)
            if res is not None:
                out.update(keys=np.asarray(list(res[CUTOFFS[0]])),
                           values=np.asarray([list(res[c].values()) for c in CUTOFFS]))
            if name.startswith("IALS"):
                out["rows"] = np.asarray([model._rows_u.rows, model._rows_i.rows])
            if rank == 0 and name == "SLIM-BPR":
                ref = np.load(os.path.join(out_dir, "slim_ref.npy"), mmap_mode="r")
                W, gap = got[0], 0.0
                for lo in range(0, W.shape[0], 2048):
                    block = torch.from_numpy(np.ascontiguousarray(ref[lo : lo + 2048])).to(W.device)
                    gap = max(gap, float((W[lo : lo + 2048] - block).abs().max()))
                out.update(gap=gap, moved=int((W != 0).sum()))
            elif rank == 0:
                out.update({f"t{j}": t.cpu().numpy() for j, t in enumerate(got)})
            np.savez(os.path.join(out_dir, f"base{i}_rank{rank}.npz"), **out)
            del model, got
            torch.cuda.empty_cache()
        train, _ = ml1m_split()
        ease = models.EASE_R_Recommender(train, device=plan.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ease.fit(topK=EASE_TOPK, l2_norm=EASE_L2, mesh_plan=plan)
        ease_s = time.perf_counter() - t0
        train, _ = lastfm_split()
        knn = models.ItemKNNCFRecommender(train, device=plan.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        knn.fit(topK=ITEMKNN_TOPK, shrink=ITEMKNN_SHRINK, similarity="cosine", mesh_plan=plan)
        knn_s = time.perf_counter() - t0
        out = dict(ease_s=ease_s, knn_s=knn_s, knn_host=knn._device_w is None)
        if rank == 0:
            W = knn.W_sparse
            out.update(ease=ease.W_sparse.toarray(), knn_data=W.data, knn_indices=W.indices, knn_indptr=W.indptr)
        np.savez(os.path.join(out_dir, f"linalg_rank{rank}.npz"), **out)
    finally:
        comm.shutdown()
    return 0


def phase_baseline_mesh_gloo(dev, card, refs):
    """Phase 38: four ranks that share the one card over gloo, mesh
    MESH_GLOO, phase 37's fits and evaluations against its one-card
    references, then EASE-R's fit through the distributed Cholesky (model 2)
    against phase 37's one-card W and ItemKNN cosine through the sharded
    similarity build against a one-card build. gloo stages every collective
    through the host: the walls are no multi-card figure. Returns K1's
    launches by fit, summed over the ranks."""
    import scipy.sparse as sps

    from ganmf_tpu_torch import models
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.ops.similarity import compute_similarity

    world = MESH_GLOO["n_data"] * MESH_GLOO["n_model"]
    out_dir = os.path.abspath(os.path.join(SCRATCH, "baseline_mesh"))
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "slim_ref.npy"), refs["SLIM-BPR"][0][0].numpy())
    print(f"[38] IALS (dense, flat csr), MF-SGD BPR, SLIM-BPR, EASE-R and ItemKNN cosine on a mesh {MESH_GLOO} of "
          f"{world} ranks sharing the card over gloo, {MESH_EPOCHS} epoch(s) each, against phase 37's one-card path "
          f"(gloo stages its collectives through the host: this is no multi-card measurement)")
    port = free_port()
    t0 = time.perf_counter()
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--baseline-mesh-rank", str(r), str(world),
                               str(port), out_dir], stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.perf_counter() + BASELINE_MESH_RANK_TIMEOUT
    try:
        for proc in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for r, (proc, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode != 0:
            fail(f"rank {r} of the gloo mesh exited {proc.returncode}:\n{text[-3000:]}")
    launches = {}
    for i, name in enumerate(BASELINE_MESH_FITS):
        ranks = [dict(np.load(os.path.join(out_dir, f"base{i}_rank{r}.npz"))) for r in range(world)]
        want, ref_results = refs[name]
        if name == "SLIM-BPR":
            worst = float(ranks[0]["gap"])
            if not (worst <= SLIM_EPOCH_ATOL and int(ranks[0]["moved"]) > 0):
                fail(f"{name}: the gloo mesh's W differs from the one-card W by {worst:.3e} > {SLIM_EPOCH_ATOL}")
        else:
            worst = hold_baseline(name, [ranks[0][f"t{j}"] for j in range(len(want))], want, summed=True)
        metrics = ""
        if "values" in ranks[0]:
            keys = [str(k) for k in ranks[0]["keys"]]
            results = {c: dict(zip(keys, ranks[0]["values"][ci])) for ci, c in enumerate(CUTOFFS)}
            gap, where = metric_gaps(results, ref_results)
            for r, out in enumerate(ranks):
                if not np.array_equal(out["values"], ranks[0]["values"]):
                    fail(f"rank {r} of the gloo mesh finalized other metrics than rank 0 for {name}")
            # the mesh evaluator against the one-card evaluator on the same
            # factors; the gap to phase 37's fit, whose factors differ by the
            # rounding the bounds above admit, is printed
            train, test = baseline_split(name)
            single = (models.MatrixFactorization_BPR if name.startswith("MF-SGD") else models.IALSRecommender)(
                train, device=dev)
            single.USER_factors, single.ITEM_factors = ranks[0]["t0"], ranks[0]["t1"]
            one, _ = EvaluatorHoldout(test, CUTOFFS, device=dev).evaluateRecommender(single)
            same = worst_metric_diff(name, results, one, METRIC_TOL)
            metrics = (f"; evaluation {max(float(o['eval_s']) for o in ranks):.4f} s, metrics within {same:.3e} of "
                       f"a one-card evaluation of the same factors, {gap:.3e} of phase 37's fit ({where})")
        k1 = sum(int(out["k1"]) for out in ranks)
        if (k1 == 0) != (name == "SLIM-BPR"):
            fail(f"the gloo mesh's {name} path launched K1 {k1} times in its evaluations")
        launches[name] = k1
        rows = f"; rows held (users, items) {[out['rows'].tolist() for out in ranks]}" if "rows" in ranks[0] else ""
        print(f"  {name}: {max(float(o['fit_s']) for o in ranks) / MESH_EPOCHS:.4f} s/epoch (the slowest rank)"
              f"{metrics}; K1 launches over the ranks {k1}; largest difference {worst:.3e} against phase 37's "
              f"one-card fit{rows}  [{card}, gloo]")
    ranks = [dict(np.load(os.path.join(out_dir, f"linalg_rank{r}.npz"))) for r in range(world)]
    gap, only = hold_pruned_w("EASE-R on the gloo mesh", ranks[0]["ease"], refs["EASE-R"])
    n_items, S = ml1m_split()[0].shape[1], MESH_GLOO["n_model"]
    w = max(8, min(256, -(-n_items // S)))
    print(f"  EASE-R fit(mesh_plan) through the distributed Cholesky (model {S}, {-(-n_items // (S * w)) * S * w} "
          f"padded items, panels of {w}): "
          f"{max(float(o['ease_s']) for o in ranks):.4f} s (the slowest rank); W within {gap:.3e} of phase 37's "
          f"one-card W, {only} entries kept by one only  [{card}, gloo]")
    train, _ = lastfm_split()
    want = compute_similarity(train, "cosine", topK=ITEMKNN_TOPK, shrink=ITEMKNN_SHRINK, device=dev)
    got = sps.csr_matrix((ranks[0]["knn_data"], ranks[0]["knn_indices"], ranks[0]["knn_indptr"]), shape=want.shape)
    if not all(bool(o["knn_host"]) for o in ranks) or ((got != 0) != (want != 0)).nnz:
        fail("ItemKNN on the gloo mesh: the sharded build's W keeps other entries than the one-card build's")
    knn_gap = float(abs(got - want).max())
    if knn_gap > SIM_RTOL * float(abs(want).max()):
        fail(f"ItemKNN on the gloo mesh: W differs from the one-card build's by {knn_gap:.3e}")
    print(f"  ItemKNN cosine fit(mesh_plan) through the sharded similarity build ({-(-want.shape[1] // S)} target "
          f"columns a model rank): {max(float(o['knn_s']) for o in ranks):.4f} s (the slowest rank); W's "
          f"{want.nnz} entries as the one-card build's, within {knn_gap:.3e}  [{card}, gloo]")
    print(f"  phase wall {wall:.2f} s (the ranks' start-up included)")
    return launches


# the ML-20M stand-in (phase 39): the full 138,493 x 26,744 user base and
# catalog of ganmf_tpu_torch.data.synthetic, parsed and split by the port's
# reader; the iterative fits cut to one epoch (IALS: a fit of 1 and one timed
# _run_epoch, bench.py's row), no stage and no user or item cut
ML20M_EPOCHS = 1
ML20M_SERVE_BLOCK = 2048  # serve_all's default block
ML20M_K2_ROWS = 1024  # CFGAN's G minibatch at its published params
ML20M_MAP_GAP = 1e-4  # ItemKNN's MAP@20 against SCALE20M.json's


def ml20m_rows_line(key, r):
    """One stage's route, walls, eval users/s and peak device memory."""
    parts = [f"route {r['route']}", f"fit {r['fit_s']:.3f} s"]
    for name in ("epoch_s", "gram_s", "serve_s"):
        if name in r:
            parts.append(f"{name[:-2]} {r[name]:.3f} s")
    if "serve_users_per_s" in r:
        parts.append(f"serve_all {r['serve_users_per_s']:,.0f} users/s")
    if "eval_s" in r:
        parts.append(f"eval {r['eval_s']:.3f} s (first {r['eval_first_s']:.3f}), {r['eval_users_per_s']:,.0f} "
                     f"users/s over {r['n_eval_users']} users; MAP@20 {r['MAP@20']:.6f} NDCG@20 {r['NDCG@20']:.6f}")
    if "RMSE" in r:
        parts.append(f"RMSE {r['RMSE']:.6f} (global mean {r['global_mean_rmse']:.6f})")
    parts.append("peak not measured" if r["peak_gib"] is None else f"peak {r['peak_gib']:.2f} GiB")
    return f"  {key}: " + "; ".join(parts)


def ml20m_itemknn_float32(model, train, ev, r, dev, card):
    """Phase 39's ItemKNN beside the float32 routes it no longer takes, in
    the same call: the resident bf16 Gram and the streamed float32 Gram in
    turns (float32, bf16, bf16, float32), G bitwise equal; the evaluation of
    the same model through the float32 product (``_SIM_SPLIT_MIN_ITEMS``
    raised past the catalog) beside its plane evaluation; the plane
    evaluation's MAP@20 within ML20M_MAP_GAP of SCALE20M.json's."""
    import scipy.sparse as sps
    import torch

    from ganmf_tpu_torch.cli import scale20m
    from ganmf_tpu_torch.models import base as pbase
    from ganmf_tpu_torch.ops import similarity as psim

    X = sps.csr_matrix(train, dtype=np.float32)
    ones = torch.ones(X.shape[0], device=dev)
    walls, grams = {True: [], False: []}, {}
    for binary in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        G, _, route = psim.build_gram(X, ones, False, dev, binary)
        torch.cuda.synchronize()
        walls[binary].append(time.perf_counter() - t0)
        if route != ("resident" if binary else "streamed") or G.dtype != torch.float32:
            fail(f"ML-20M: the {'bf16' if binary else 'float32'} Gram took the {route} route ({G.dtype})")
        grams[binary] = G
        del G
    if not torch.equal(grams[True], grams[False]):
        fail("ML-20M: the resident bf16 Gram differs from the streamed float32 one")
    del grams
    flop = r["gram_flop"]
    for binary, what, peak in ((True, "resident bf16", scale20m.BF16_FLOPS),
                               (False, "streamed float32", scale20m.F32_FLOPS)):
        print(f"    {what} Gram: {', '.join(f'{w:.3f}' for w in walls[binary])} s, "
              f"{100 * flop / min(walls[binary]) / peak:.1f}% of the {what.split()[1]} peak at the best  [{card}]")
    print(f"    G bitwise equal on both routes; bf16 / float32 wall {min(walls[True]) / min(walls[False]):.3f}")

    saved = pbase._SIM_SPLIT_MIN_ITEMS
    pbase._SIM_SPLIT_MIN_ITEMS = X.shape[1] + 1
    try:
        results, f32_walls = scale20m.evaluate(ev, model)
    finally:
        pbase._SIM_SPLIT_MIN_ITEMS = saved
    f32_map = float(results[20]["MAP"])
    print(f"    evaluation through W's bf16 planes {r['eval_s']:.3f} s (first {r['eval_first_s']:.3f}), MAP@20 "
          f"{r['MAP@20']:.6f}; through the float32 product {f32_walls[-1]:.3f} s (first {f32_walls[0]:.3f}), "
          f"MAP@20 {f32_map:.6f}; gap {abs(r['MAP@20'] - f32_map):.3e}  [{card}]")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "SCALE20M.json")) as fh:
        jax_map = json.load(fh)["ItemKNN_cosine"]["MAP@20"]
    if not abs(r["MAP@20"] - jax_map) <= ML20M_MAP_GAP:
        fail(f"ML-20M: ItemKNN's MAP@20 {r['MAP@20']:.6f} is not within {ML20M_MAP_GAP} of SCALE20M.json's "
             f"{jax_map:.6f}")
    print(f"    ItemKNN MAP@20: the port {r['MAP@20']:.8f}, SCALE20M.json (the JAX package on a TPU) "
          f"{jax_map:.8f}, gap {abs(r['MAP@20'] - jax_map):.3e}")


def phase_ml20m(dev, card, scratch):
    """The ML-20M stand-in end to end (ganmf_tpu_torch/cli/scale20m.py's
    stages, cut to one epoch), then K1 at its evaluation and serve_all
    blocks and K2 at CFGAN's minibatch on its rows, each against its plain
    version. Returns (K1 fused launches, merge launches, K2 launches, keyed
    launches, K1 times by shape, K2 times by shape, K1 error)."""
    import torch

    from ganmf_tpu_torch.cli import scale20m
    from ganmf_tpu_torch.data import synthetic
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.ops import keyed
    from ganmf_tpu_torch.ops.select import smallest_k_mask_cuda
    from ganmf_tpu_torch.ops.topk import smallest_k_mask_reference

    print("[39] the ML-20M stand-in (ganmf_tpu_torch.data.synthetic) end to end: the stages of "
          f"ganmf_tpu_torch/cli/scale20m.py at their settings, the iterative fits cut to {ML20M_EPOCHS} epoch")
    root = os.path.join(scratch, "ml20m")
    shutil.rmtree(root, ignore_errors=True)  # every step runs and is timed
    data_dir, split_dir = os.path.join(root, "data"), os.path.join(root, "splits")
    t0 = time.perf_counter()
    synthetic.synthesize(synthetic.ratings_path(data_dir), verbose=False)
    synth_s = time.perf_counter() - t0
    implicit, explicit, info = scale20m.load_splits(data_dir, split_dir, explicit=True,
                                                    log=lambda line: print(f"  {line}", flush=True))
    if info["parser"] != "native":
        fail(f"ML-20M: the ratings were parsed by the {info['parser']} parser, not the host engine's")
    shape = implicit.train.shape
    if shape != ML20M_SHAPE or explicit.train.shape != ML20M_SHAPE:
        fail(f"ML-20M: the splits are {shape} and {explicit.train.shape}, not {ML20M_SHAPE}")
    print(f"  {shape[0]:,} users x {shape[1]:,} items; implicit train nnz {implicit.train.nnz:,}, test nnz "
          f"{implicit.test.nnz:,}; walls: synthesize {synth_s:.2f} s, parse and reindex {info['read_s']:.2f} s "
          f"({info['parser']} parser), implicit split {info['split_s']:.2f} s, save {info['save_s']:.2f} s, "
          f"explicit split {info['explicit_split_s']:.2f} s")

    ev = EvaluatorHoldout(implicit.test, CUTOFFS, device=dev)
    ev_x = EvaluatorHoldout(explicit.test, scale20m.EXPLICIT_CUTOFFS, device=dev)
    cut = dict(epochs=ML20M_EPOCHS)
    # the main path: every count set to 0 just before it and read just after;
    # K1's launches held against its plain version are taken out again
    _reset_counters()
    rows = {}

    def stage(key, fn, *args, **kwargs):
        r, model = fn(*args, dev, **kwargs)
        rows[key] = r
        print(ml20m_rows_line(key, r) if key != "CFGAN_csr" else
              f"  {key}: one epoch {r['epoch_s']:.3f} s (fit {r['fit_s']:.3f} s), K2 {r['k2_launches']} and the "
              f"keyed draw {r['keyed_launches']} launches", flush=True)
        return model

    stage("TopPop", scale20m.toppop, implicit, ev)
    svd = stage("PureSVD", scale20m.puresvd, implicit, ev)
    # K1 at the path's two shapes on PureSVD's factors: the evaluator's first
    # block (its users ordered by training length) and serve_all's first
    k1_counters = ("k1.launches", "k1.wide_launches", "k1.merge_launches")
    saved = [_counter(name) for name in k1_counters]
    U, V, _ = svd._factors_device()
    users = np.asarray(ev.usersToEvaluate, dtype=np.int64)
    users = users[np.argsort(np.ediff1d(implicit.train.indptr)[users], kind="stable")]
    k1_times, k1_err = {}, 0.0
    for name, uids, k in (("evaluation block", users[: ev.block_rows()], max(CUTOFFS)),
                          ("serve_all block", np.arange(min(ML20M_SERVE_BLOCK, shape[0])), 20)):
        uids = torch.from_numpy(uids).to(dev)
        Ub, M = U.index_select(0, uids).contiguous(), svd.device_seen_rows(uids)
        k1_err = max(k1_err, compare_k1(f"K1 at ML-20M's {name}", Ub, V, M, k))
        t = k1_times[f"ML-20M {name}: B={Ub.shape[0]} K={Ub.shape[1]} I={V.shape[0]} k={k}"] = time_k1(Ub, V, M, k)
        print(f"    {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f}% of it  [{card}]")
    from ganmf_tpu_torch.utils import profiling

    for name, n in zip(k1_counters, saved):
        profiling.count(name, n - _counter(name))
    del svd, U, V, Ub, M
    knn = stage("ItemKNN_cosine", scale20m.itemknn, implicit, ev)
    r = rows["ItemKNN_cosine"]
    if r["route"] != "resident bf16 Gram, bf16 planes scoring":
        fail(f"ML-20M: ItemKNN took {r['route']}, not JAX's resident bf16 Gram and plane scoring")
    print(f"    the {r['route'].split(',')[0]} alone: {r['gram_s']:.3f} s for {r['gram_flop']:.3e} FLOP, "
          f"{100 * r['gram_peak_share']:.1f}% of the {r['gram_peak']} peak  [{card}]")
    ml20m_itemknn_float32(knn, implicit.train, ev, r, dev, card)
    del knn
    stage("IALS", scale20m.ials, implicit, ev, **cut)
    stage("GANMF", scale20m.ganmf, implicit, ev, **cut)
    stage("IALS_explicit", scale20m.ials_explicit, explicit, ev_x, **cut)
    stage("FunkSVD_explicit", scale20m.funksvd_explicit, explicit, ev_x, **cut)
    stage("CFGAN_csr", scale20m.cfgan, implicit)
    wide, merge, k2, drawn = _counter("k1.wide_launches"), _counter("k1.merge_launches"), _counter("k2.launches"), _counter("keyed.launches")
    fused = _counter("k1.launches") - wide
    k3 = {}
    _k3_launches("ML-20M stand-in", k3)
    per_epoch, _, _ = expected_csr_draws(scale20m.CFGAN_PARAMS, shape[0])
    print(f"  launches on the ML-20M path: K1 fused {fused} (merge pass {merge}), wide pair {wide}, K2 {k2}, "
          f"keyed draw {drawn}, K3 {sum(k3.values())}")
    if fused == 0 or wide or k2 != per_epoch or drawn != per_epoch:
        fail(f"ML-20M: K1's fused kernel launched {fused} times and its wide pair {wide}; K2 {k2} and the keyed "
             f"draw {drawn} times, where CFGAN's csr epoch draws {per_epoch}")

    floor = rows["TopPop"]["MAP@20"]
    for key in ("PureSVD", "ItemKNN_cosine"):  # fits that are not iterative: the receipt holds at one epoch
        if not rows[key]["MAP@20"] > floor:
            fail(f"ML-20M: {key}'s MAP@20 {rows[key]['MAP@20']:.6f} is not above TopPop's {floor:.6f}")
    for key, r in rows.items():
        if "n_eval_users" in r and r["n_eval_users"] != r["users_to_evaluate"]:
            fail(f"ML-20M: {key} scored {r['n_eval_users']} users of {r['users_to_evaluate']} to evaluate")
    for key in ("IALS_explicit", "FunkSVD_explicit"):
        if not np.isfinite(rows[key]["RMSE"]):
            fail(f"ML-20M: {key}'s RMSE is not finite")
    print(f"  PureSVD's and ItemKNN's MAP@20 above TopPop's ({floor:.6f}); every evaluation scored all "
          f"{len(ev.usersToEvaluate):,} (explicit: {len(ev_x.usersToEvaluate):,}) users to evaluate; both explicit "
          f"RMSEs finite")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "SCALE20M.json")) as fh:
        jax_map = json.load(fh)["TopPop"]["MAP@20"]
    print(f"  TopPop MAP@20: the port {floor:.8f}, SCALE20M.json (the JAX package on a TPU) {jax_map:.8f}, gap "
          f"{abs(floor - jax_map):.3e}")

    # K2 at CFGAN's G minibatch on the stand-in's rows: a seeded sample of
    # users, their keyed draws with +inf at their interactions
    g = torch.Generator().manual_seed(SEED + 39)
    rows_k2 = torch.randperm(shape[0], generator=g)[:ML20M_K2_ROWS]
    inter = torch.from_numpy(implicit.train[rows_k2.numpy()].toarray() != 0).to(dev)
    rows_k2 = rows_k2.to(dev)
    keys = keyed.keyed_uniforms_reference(SEED, 3, 0, rows_k2, shape[1]).masked_fill(inter, float("inf"))
    ratio = torch.tensor(scale20m.CFGAN_PARAMS["zr_ratio"], device=dev)
    k = ((~inter).sum(1).to(torch.float32) * ratio).to(torch.int32)
    got, want = smallest_k_mask_cuda(keys, k), smallest_k_mask_reference(keys, k)
    if not torch.equal(got, want):
        fail(f"K2 at ML-20M's [{ML20M_K2_ROWS}, {shape[1]}] differs from its plain version")
    name = f"ML-20M csr [{ML20M_K2_ROWS}, {shape[1]}] (the stand-in's rows)"
    t = time_k2(keys, k)
    print(f"  K2 {name}: bitwise equal ({int(got.sum())} selected, rows of {int(inter.sum(1).min())}-"
          f"{int(inter.sum(1).max())} interactions); {t['ms']:.4f} ms through the wrapper, {t['launch_ms']:.4f} ms "
          f"the launch alone; plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']})  [{card}]")
    shutil.rmtree(root)
    return fused, merge, k2, drawn, k3, k1_times, {name: t}, k1_err


# -- phase 40: JAX's bf16 similarity routes -------------------------------------

SPLIT_SHAPE, SPLIT_DENSITY = (4000, 24000), 0.00279  # past _SIM_SPLIT_MIN_ITEMS, at LastFM's density
PLANE_BLOCK = 512  # users in the plane product's comparison block (the CPU ranks it too)


def split_20k():
    """A binary 80/20 split of SPLIT_SHAPE at SPLIT_DENSITY, its cells drawn
    from SEED."""
    import scipy.sparse as sps

    n_rows, n_cols = SPLIT_SHAPE
    rng = np.random.default_rng(SEED)
    cells = rng.choice(n_rows * n_cols, size=int(SPLIT_DENSITY * n_rows * n_cols), replace=False)
    held = rng.random(cells.size) >= 0.8
    parts = []
    for keep in (~held, held):
        c = cells[keep]
        parts.append(sps.csr_matrix((np.ones(c.size, np.float32), (c // n_cols, c % n_cols)), shape=SPLIT_SHAPE))
    return parts


def routes_gram_check(train, dev, card):
    """G of 0/1 data on the dense, resident, streamed, column-blocked scatter
    and one-rank sharded routes, each reached by lowering the port's limits,
    bitwise the float32 product's, every product a bf16 one with a float32
    output; the dense Gram's bf16 and float32 products timed in turns."""
    import torch

    from ganmf_tpu_torch.data.device import dense_from_sparse
    from ganmf_tpu_torch.ops import similarity as psim
    from ganmf_tpu_torch.parallel import comm, make_mesh

    n_rows, n_cols = train.shape
    ones = torch.ones(n_rows, device=dev)
    G32, _, route = psim.build_gram(train, ones, False, dev)
    if route != "dense":
        fail(f"bf16 routes: the float32 reference took the {route} route")
    calls, grams = [], []
    bf16_mm, w_block = psim.bf16_mm, psim._w_block

    def counting(a, b, out=None):
        r = bf16_mm(a, b, out=out)
        if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or r.dtype != torch.float32:
            fail(f"bf16 routes: a product of {a.dtype} and {b.dtype} returned {r.dtype}")
        calls.append(1)
        return r

    def capturing(G, s1, s2, off, *a, **k):
        grams.append((G.clone(), off))
        return w_block(G, s1, s2, off, *a, **k)

    saved = {name: getattr(psim, name) for name in ("bf16_mm", "_w_block", "_DENSE_A_BYTE_LIMIT",
                                                    "_GRAM_BYTE_LIMIT", "_INT8_A_BYTE_LIMIT", "device_memory_bytes")}
    psim.bf16_mm, psim._w_block = counting, capturing
    w_kw = dict(mode="cosine", topk=ITEMKNN_TOPK, shrink=0.0, normalize=True, asymmetric_alpha=0.5,
                tversky_alpha=1.0, tversky_beta=1.0, normalize_avg_row=False, distance_mode="lin",
                use_row_weights=False)
    try:
        for route in ("dense", "resident", "streamed", "colblock", "sharded"):
            del calls[:], grams[:]
            if route != "dense":
                psim._DENSE_A_BYTE_LIMIT = 1
            if route == "streamed":
                psim.device_memory_bytes = lambda device: 1 << 30  # no room for the resident A
            if route == "colblock":
                psim._GRAM_BYTE_LIMIT, psim._INT8_A_BYTE_LIMIT = 4 * n_cols * n_cols - 1, 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route in ("dense", "resident", "streamed"):
                G, _, got = psim.build_gram(train, ones, False, dev, True)
                slabs = [(G, 0)]
            elif route == "colblock":
                got = psim.build_route(n_rows, n_cols)
                psim.compute_similarity(train, "cosine", topK=ITEMKNN_TOPK, device=dev)
                slabs = list(grams)
            else:
                comm.initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0)
                try:
                    plan = make_mesh()
                    got = "sharded"
                    psim.similarity_topk_sharded(dense_from_sparse(train, dev), ones, False, n_rows, plan,
                                                 binary=True, **w_kw)
                finally:
                    comm.shutdown()
                slabs = list(grams)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for name, value in saved.items():
                if name not in ("bf16_mm", "_w_block"):
                    setattr(psim, name, value)
            if got != route or not calls or not slabs:
                fail(f"bf16 routes: {route} took {got}, {len(calls)} bf16 products, {len(slabs)} Gram blocks")
            for G, off in slabs:
                if not torch.equal(G, G32[:, off : off + G.shape[1]]):
                    fail(f"bf16 routes: the {route} route's G differs from the float32 product's")
            print(f"  {route}: G bitwise the float32 product's over {len(slabs)} block(s) of "
                  f"{slabs[0][0].shape[1]} columns, {len(calls)} bf16 products (float32 outputs); {wall:.3f} s "
                  f"with its set-up  [{card}]")
            slabs = G = None
            grams.clear()
    finally:
        for name, value in saved.items():
            setattr(psim, name, value)
    A = dense_from_sparse(train, dev)
    times = {True: [], False: []}
    for binary in (False, True, True, False):
        times[binary].append(cuda_ms(lambda: psim._dense_gram(A, ones, False, binary), reps=10))
    flop = 2.0 * n_rows * n_cols * n_cols
    ms16, ms32 = min(times[True]), min(times[False])
    print(f"  the dense Gram at {n_rows} x {n_cols} ({flop:.3e} FLOP): bf16 product "
          f"{', '.join(f'{t:.4f}' for t in times[True])} ms ({100 * flop / ms16 / 1e-3 / BF16_FLOPS:.1f}% of the bf16 "
          f"peak), float32 {', '.join(f'{t:.4f}' for t in times[False])} ms "
          f"({100 * flop / ms32 / 1e-3 / F32_FLOPS:.1f}% of the float32 peak); bf16 / float32 "
          f"{ms16 / ms32:.4f}  [{card}]")


def plane_block_check(name, model, ev, dev, card):
    """One block of PLANE_BLOCK users of a similarity model whose operands
    are planes: the card's plane product against the CPU's plain version
    from the same operands and against the card's float32 product, values
    within RTOL / ATOL and ids equal but at near ties (K1's rules); both
    products and both rankings timed."""
    import torch

    from ganmf_tpu_torch.models.base import ItemSimilarityRecommender
    from ganmf_tpu_torch.ops.simscore import masked_topk_matmul, plane_product

    uids = torch.from_numpy(np.asarray(ev.usersToEvaluate[:PLANE_BLOCK], dtype=np.int64)).to(dev)
    rows, right = model._fused_serving_operands(uids)
    if not (isinstance(rows, tuple) or isinstance(right, tuple)):
        fail(f"{name}: the operands are not bf16 planes at {model.n_items} items")
    item_based = isinstance(model, ItemSimilarityRecommender)
    seen = None if item_based else model.device_seen_rows(uids)
    W = model._w_device()
    f32_rows, f32_right = (rows.float(), W) if item_based else (W.index_select(0, uids), model.device_urm().dense)
    pairs = torch.zeros((uids.shape[0], 1), dtype=torch.int64, device=dev)
    k = max(CUTOFFS)

    def rank(r, w, s, p):
        return masked_topk_matmul(r, w, s, p, k, mask_from_rows=item_based)[:2]

    def on_cpu(x):
        return tuple(t.cpu() for t in x) if isinstance(x, tuple) else x.cpu()

    vals, ids = rank(rows, right, seen, pairs)
    pvals, pids = rank(on_cpu(rows), on_cpu(right), None if seen is None else seen.cpu(), pairs.cpu())
    fvals, fids = rank(f32_rows, f32_right, seen, pairs)
    excl = (rows != 0) if item_based else seen
    plane_scores = plane_product(rows, right).masked_fill(excl, float("-inf"))
    f32_scores = (f32_rows @ f32_right).masked_fill(excl, float("-inf"))
    gaps = {}
    for what, (ov, oi), scores in (("the CPU's plain version", (pvals.to(dev), pids.to(dev)), plane_scores),
                                   ("the float32 product", (fvals, fids), f32_scores)):
        fin = torch.isfinite(ov)
        if not torch.equal(torch.isfinite(vals), fin):
            fail(f"{name}: the planes and {what} differ in which slots are finite")
        err = (vals[fin] - ov[fin]).abs()
        if not bool((err <= RTOL * ov[fin].abs() + ATOL).all()):
            fail(f"{name}: the plane scores differ from {what} beyond rtol {RTOL}")
        gaps[what] = (float((err / ov[fin].abs().clamp_min(1e-30)).max()), ids_agree(ids, oi, scores, fin))
    ms = cuda_ms(lambda: plane_product(rows, right), reps=10)
    f32_ms = cuda_ms(lambda: f32_rows @ f32_right, reps=10)
    rank_ms = cuda_ms(lambda: rank(rows, right, seen, pairs), reps=10)
    f32_rank_ms = cuda_ms(lambda: rank(f32_rows, f32_right, seen, pairs), reps=10)
    B, C = f32_rows.shape
    flop = 2.0 * B * C * f32_right.shape[1]
    n_pairs = (len(rows) if isinstance(rows, tuple) else 1) * (len(right) if isinstance(right, tuple) else 1)
    print(f"  {name}: block of {B} users, [{B}, {C}] x [{C}, {f32_right.shape[1]}], {n_pairs} bf16 products; "
          + "; ".join(f"against {w}: values within {g:.3e} (relative), {t} near-tie id slots"
                      for w, (g, t) in gaps.items()))
    print(f"    products: planes {ms:.4f} ms ({100 * n_pairs * flop / ms / 1e-3 / BF16_FLOPS:.1f}% of the bf16 peak), "
          f"float32 {f32_ms:.4f} ms ({100 * flop / f32_ms / 1e-3 / F32_FLOPS:.1f}% of the float32 peak); masked "
          f"top-{k}: planes {rank_ms:.4f} ms, float32 {f32_rank_ms:.4f} ms  [{card}]")


def phase_bf16_routes(dev, card):
    """Phase 40: the Gram's bf16 routes on the LastFM-shaped split, then
    ItemKNN and UserKNN on a binary split past _SIM_SPLIT_MIN_ITEMS scoring
    through W's bf16 planes: a block against the CPU and against the float32
    product, and the whole evaluation in both products."""
    import torch

    from ganmf_tpu_torch.cli import scale20m
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import ItemKNNCFRecommender, UserKNNCFRecommender
    from ganmf_tpu_torch.models import base as pbase

    train, _ = lastfm_split()
    print(f"[40] JAX's bf16 similarity routes: the Gram of the {train.shape[0]} x {train.shape[1]} binary split on "
          f"every route, then ItemKNN and UserKNN on a {SPLIT_SHAPE[0]} x {SPLIT_SHAPE[1]} binary split through "
          f"W's bf16 planes")
    routes_gram_check(train, dev, card)
    del train
    train, test = split_20k()
    if train.shape[1] < pbase._SIM_SPLIT_MIN_ITEMS:
        fail(f"bf16 routes: {train.shape[1]} items do not reach _SIM_SPLIT_MIN_ITEMS")
    ev = EvaluatorHoldout(test, CUTOFFS, device=dev)
    for cls in (ItemKNNCFRecommender, UserKNNCFRecommender):
        model = cls(train, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(topK=ITEMKNN_TOPK, shrink=ITEMKNN_SHRINK, similarity="cosine")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        name = cls.__name__.replace("Recommender", "")
        plane_block_check(name, model, ev, dev, card)
        results, walls = scale20m.evaluate(ev, model)
        saved = pbase._SIM_SPLIT_MIN_ITEMS
        pbase._SIM_SPLIT_MIN_ITEMS = train.shape[1] + 1
        try:
            f32_results, f32_walls = scale20m.evaluate(ev, model)
        finally:
            pbase._SIM_SPLIT_MIN_ITEMS = saved
        gap = max(abs(results[c][m] - f32_results[c][m]) for c in CUTOFFS for m in ("PRECISION", "RECALL", "MAP",
                                                                                    "NDCG"))
        if not all(np.isfinite(results[c][m]) for c in CUTOFFS for m in ("PRECISION", "RECALL", "MAP", "NDCG")):
            fail(f"{name}: a ranking metric of the plane evaluation is not finite")
        n = len(ev.usersToEvaluate)
        print(f"    fit {fit_s:.3f} s; evaluation of {n} users through the planes {walls[-1]:.4f} s, through the "
              f"float32 product {f32_walls[-1]:.4f} s; MAP@20 {results[20]['MAP']:.6f} / "
              f"{f32_results[20]['MAP']:.6f}, largest metric gap {gap:.3e}  [{card}]")
        del model


# -- phase 41: the graft entry points (ganmf_tpu_torch/graft.py) ----------------

def phase_graft(dev, card):
    """Phase 41: ``entry()``'s losses on the card, eager and under
    torch.compile, each within rtol 1e-5 of the CPU's; then
    ``dryrun_multichip(8)``, 8 gloo ranks sharing the card, and its wall."""
    import torch

    from ganmf_tpu_torch import graft

    print("[41] the graft entry points (ganmf_tpu_torch/graft.py): entry() eagerly and under torch.compile, "
          "then dryrun_multichip(8)")
    fn, args = graft.entry()
    cpu_fn, cpu_args = graft.entry(device="cpu")
    want = [float(x.detach()) for x in cpu_fn(*cpu_args)]
    eager = [float(x.detach()) for x in fn(*args)]
    t0 = time.perf_counter()
    compiled = [float(x.detach()) for x in torch.compile(fn)(*args)]
    compile_s = time.perf_counter() - t0
    for what, got in (("eager", eager), ("compiled", compiled)):
        if not np.allclose(got, want, rtol=1e-5, atol=0):
            fail(f"graft: entry()'s {what} losses {got} are not within rtol 1e-5 of the CPU's {want}")
    print(f"  entry ok: CPU {want}, card eager {eager}, compiled {compiled} (first call {compile_s:.2f} s)")
    mode = "NCCL ranks, one card each" if torch.cuda.device_count() >= 8 else "gloo ranks sharing card 0"
    t0 = time.perf_counter()
    graft.dryrun_multichip(8)
    print(f"  dryrun ok: dryrun_multichip(8) as 8 {mode}, (data 4, model 2) and (slice 2, data 2, model 2), "
          f"{time.perf_counter() - t0:.2f} s wall (the ranks' start-up included)  [{card}]")


# -- phase 42: training past the card's memory (ganmf_tpu_torch/cli/beyond_hbm.py) -

BEYOND_SHAPE = (262144, 131072, 100)  # users, items, draws a user: 128 GiB as a dense float32 URM
BEYOND_MODELS = ("ganmf", "cfgan", "ials")  # DisGANMF and MF-BPR: scripts/torch_beyond_hbm.py
BEYOND_K2_ROWS = 128  # CFGAN's G minibatch at the JAX script's settings
K2_SMEM_MAX_COLS = 56320  # K2 holds a row in shared memory up to this width (csrc/select.cu kSmemMaxCols)


def phase_beyond_hbm(dev, card):
    """Phase 42: one csr epoch each of GANMF, CFGAN and IALS through ``fit``
    at scripts/beyond_hbm_demo.py's settings (``cli.beyond_hbm``'s stages) on
    a ``synthetic_urm`` of BEYOND_SHAPE, whose dense float32 form is past the
    card's memory: each fit's walls, storage and peak device memory (under
    the module's PEAK_BOUND_GIB, 16: half a bool [U, I] mask), its tensors
    finite; K2 and the keyed draw launched once a CFGAN G minibatch and by
    no other fit. Returns (the URM, CFGAN's expected launches)."""
    import torch

    from ganmf_tpu_torch.cli import beyond_hbm
    from ganmf_tpu_torch.data.synthetic import synthetic_urm

    total = torch.cuda.get_device_properties(dev).total_memory
    t0 = time.perf_counter()
    train = synthetic_urm(*BEYOND_SHAPE)
    U, I = train.shape
    print(f"[42] training past the card's memory: {U} x {I}, {train.nnz} interactions (synthetic_urm, "
          f"{BEYOND_SHAPE[2]} uniform draws a user, numpy seed 0; {time.perf_counter() - t0:.2f} s); dense "
          f"float32 {4 * U * I / 2**30:.0f} GiB, a bool mask {U * I / 2**30:.0f} GiB, the card's "
          f"{total / 2**30:.1f} GiB; one csr epoch each through fit at scripts/beyond_hbm_demo.py's settings")
    expected, _, _ = expected_csr_draws(dict(beyond_hbm.CFGAN_PARAMS, d_steps=1, g_steps=1), U)
    for name in BEYOND_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        k2, drawn, t0 = _counter("k2.launches"), _counter("keyed.launches"), time.perf_counter()
        if name == "ials":
            row, detail, model = beyond_hbm.ials(train, dev, card, timed_epochs=0)
            tensors = [model._U_dev, model._V_dev]
            extra = (f"; chunks of {detail['chunks'][0]} users and {detail['chunks'][1]} items, "
                     f"{detail['cg_reads']} host reads of CG's exit test")
        else:
            row, detail, model = getattr(beyond_hbm, name)(train, dev, card, epochs=1)
            tensors, extra = list(model.params.parameters()), ""
        wall = time.perf_counter() - t0
        k2, drawn = _counter("k2.launches") - k2, _counter("keyed.launches") - drawn
        want = expected if name == "cfgan" else 0
        if k2 != want or drawn != want:
            fail(f"beyond HBM {name}: K2 launched {k2} times and the keyed draw {drawn}, expected {want} each")
        if not row["peak_gib"] < beyond_hbm.PEAK_BOUND_GIB:
            fail(f"beyond HBM {name}: peak device memory {row['peak_gib']:.3f} GiB, not under "
                 f"{beyond_hbm.PEAK_BOUND_GIB}")
        if not all(bool(torch.isfinite(t).all()) for t in tensors):
            fail(f"beyond HBM {name}: a trained tensor is not finite")
        print(f"  {row['bench']}: storage {row['storage']}; epoch {detail['epoch_walls'][0]:.3f} s, fit "
              f"{detail['fit_s']:.3f} s ({wall:.3f} s with the model's set-up); peak {row['peak_gib']:.3f} GiB, "
              f"under {beyond_hbm.PEAK_BOUND_GIB}; K2 {k2} and the keyed draw {drawn} launches{extra}  [{card}]")
        del model, tensors
    gc.collect()
    torch.cuda.empty_cache()
    return train, expected


def phase_beyond_hbm_kernels(dev, card, train):
    """K2 and the keyed draw at [BEYOND_K2_ROWS, I] on CFGAN's first G
    minibatch at phase 42's shape (seed 1, epoch 1, the ZR stream; +inf at
    the interactions, k = int(n_zeros * zr_ratio) in float32): each bitwise
    its plain version, timed beside its bound; the rows' tied keys and the
    rows whose k-th key ties (K2's tie cut) counted. Returns (K2's times,
    the keyed draw's times) by shape."""
    import torch

    from ganmf_tpu_torch.cli import beyond_hbm
    from ganmf_tpu_torch.data.device import padded_csr_from_sparse, padded_rows_dense
    from ganmf_tpu_torch.models.cfgan import ZR_STREAM
    from ganmf_tpu_torch.ops import _build, keyed
    from ganmf_tpu_torch.ops.select import smallest_k_mask_cuda
    from ganmf_tpu_torch.ops.topk import smallest_k_mask_reference

    R, I = BEYOND_K2_ROWS, train.shape[1]
    seed, ratio = beyond_hbm.SEED, beyond_hbm.CFGAN_PARAMS["zr_ratio"]
    rows = torch.arange(R, device=dev)
    cond = padded_rows_dense(padded_csr_from_sparse(train[:R], dev), rows, I)
    u = keyed.keyed_uniforms_cuda(seed, 1, ZR_STREAM, rows, I)
    if not torch.equal(u, keyed.keyed_uniforms_reference(seed, 1, ZR_STREAM, rows, I)):
        fail(f"beyond HBM: the keyed draw at [{R}, {I}] differs from its plain version")
    lib, stream, out = _build.load_library(), _build.stream_handle(dev), torch.empty_like(u)
    k0, k1 = keyed.key_halves(seed)

    def launch():
        _build.check(lib, lib.ganmf_keyed_uniforms(rows.data_ptr(), R, I, k0, k1, 1, ZR_STREAM, out.data_ptr(),
                                                   stream), "chip_smoke: keyed draw launch")

    kt = {"ms": cuda_ms(lambda: keyed.keyed_uniforms_cuda(seed, 1, ZR_STREAM, rows, I)), "launch_ms": cuda_ms(launch),
          "plain_ms": cuda_ms(lambda: keyed.keyed_uniforms_reference(seed, 1, ZR_STREAM, rows, I), reps=5),
          "library_ms": None}
    kt["bound_ms"], kt["bound_by"] = bound(0, 4 * R * I + 8 * R)
    print(f"  keyed draw [{R}, {I}] (CFGAN's G minibatch): bitwise equal; {kt['ms']:.4f} ms through the wrapper, "
          f"{kt['launch_ms']:.4f} ms the launch alone, plain {kt['plain_ms']:.4f} ms, bound {kt['bound_ms']:.4f} ms "
          f"({kt['bound_by']}), {100 * kt['bound_ms'] / kt['launch_ms']:.1f}% of it  [{card}]")

    # negative_mask's keys and k (models/cfgan.py)
    interacted = cond != 0
    keys = torch.where(interacted, float("inf"), u)
    k = ((~interacted).sum(1).to(torch.float32) * float(ratio)).to(torch.int32)
    got = smallest_k_mask_cuda(keys, k)
    n_diff = int((got != smallest_k_mask_reference(keys, k)).sum())
    if n_diff:
        fail(f"beyond HBM: K2 at [{R}, {I}] differs from its plain version in {n_diff} entries")
    if not torch.equal(got.sum(1), k.long()):
        fail(f"beyond HBM: a row of K2's mask at [{R}, {I}] does not hold k entries")
    ordered = torch.sort(keys, dim=1).values
    tied = int((ordered[:, 1:] == ordered[:, :-1]).logical_and(torch.isfinite(ordered[:, 1:])).sum())
    kth = ordered.gather(1, (k.long() - 1).clamp(min=0)[:, None])
    cut = int(((k > 0) & ((keys == kth).sum(1) > k - (keys < kth).sum(1))).sum())
    t = time_k2(keys, k)
    route = "streamed-row" if I > K2_SMEM_MAX_COLS else "shared-memory"
    print(f"  K2 [{R}, {I}] on those keys (its {route} route): bitwise equal, every row count = k; "
          f"{tied} keys equal to a smaller neighbour, {cut} of {R} rows cut at a tied k-th key; {t['ms']:.4f} ms "
          f"through the wrapper, {t['launch_ms']:.4f} ms the launch alone; plain {t['plain_ms']:.4f} ms; bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {100 * t['bound_ms'] / t['launch_ms']:.1f}% of it  [{card}]")
    shape = f"beyond HBM [{R}, {I}]"
    return {shape: t}, {shape: kt}


# -- phase 43: serving latency (ganmf_tpu_torch/cli/serving_latency.py) ------------

SERVING_FAMILIES = ("MF", "GANMF")  # ItemKNN (the dense route): scripts/torch_serving_latency.py
SERVING_K1_BATCHES = (1, 32)


def phase_serving_latency(dev, card):
    """Phase 43: p50 and p99 of ``recommend(cutoff=20)`` at b=1 and b=32 for
    PureSVD (K=50) and GANMF (K=64, 2 epochs) on the ML-1M- and LastFM-shaped
    splits (``cli.serving_latency``'s settings and measure: every timed list
    equal to an untimed call's, K1's fused kernel launched on every timed
    call and its wide pair never). Returns the models by (dataset, family)."""
    import torch

    from ganmf_tpu_torch.cli import serving_latency

    print(f"[43] serving latency: p50 and p99 of recommend(cutoff={serving_latency.CUTOFF}) at b=1 "
          f"({serving_latency.N_SINGLE} calls) and b={serving_latency.BATCH} ({serving_latency.N_BATCH} calls) "
          f"for {', '.join(SERVING_FAMILIES)} on the ML-1M- and LastFM-shaped splits")
    models = {}
    for ds, split in (("1M", ml1m_split), ("LastFM", lastfm_split)):
        train, _ = split()
        for family in SERVING_FAMILIES:
            t0 = time.perf_counter()
            model = serving_latency.fit_family(family, train, dev)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            rows = serving_latency.measure(model, family, ds, train.shape[0], dev, card,
                                           log=lambda line: print("  " + line))
            for r in rows:
                if not (0 < r["p50_ms"] <= r["p99_ms"] < float("inf")):
                    fail(f"serving latency {r['name']}: p50 {r['p50_ms']} and p99 {r['p99_ms']} ms")
                if r["k1_fused_launches"] < r["n"] or r["k1_wide_launches"]:
                    fail(f"serving latency {r['name']}: K1 fused {r['k1_fused_launches']} and wide "
                         f"{r['k1_wide_launches']} launches over {r['n']} timed calls")
            print(f"    {family} on {ds}: fit {fit_s:.3f} s; K1 fused launches over the timed calls "
                  f"{rows[0]['k1_fused_launches']} (b=1) and {rows[1]['k1_fused_launches']} "
                  f"(b={serving_latency.BATCH}), wide 0; every timed list equal to an untimed call's")
            models[ds, family] = model
    return models


def phase_serving_kernels(dev, card, models):
    """K1's fused kernel at the latency path's shapes (B=1 and B=32, k=20, on
    each model's factors and seen rows), held against its plain version and
    timed beside the library composition and its bound. Returns (the largest
    error, the times by shape)."""
    import torch

    from ganmf_tpu_torch.cli import serving_latency

    k, worst, times = serving_latency.CUTOFF, 0.0, {}
    for (ds, family), model in models.items():
        U, V, _ = model._factors_device()
        rng = np.random.RandomState(0)
        for B in SERVING_K1_BATCHES:
            users = torch.from_numpy(rng.randint(0, model.n_users, size=B)).to(dev)
            Ub, mask = U.index_select(0, users).contiguous(), model._exclusion_mask(users, True)
            label = f"serving latency {family} {ds}"
            worst = max(worst, compare_k1(label, Ub, V, mask, k))
            t = times[f"{label}: B={B} K={U.shape[1]} I={V.shape[0]} k={k}"] = time_k1(Ub, V, mask, k)
            print(f"    {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}), bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f}% of it  [{card}]")
    return worst, times


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"[1] CUDA: {torch.cuda.device_count()} device(s); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    card = card_line()
    print(f"[2] card: {card}")

    from ganmf_tpu_torch.ops import _build
    from ganmf_tpu_torch.utils.device import cuda_device

    dev = cuda_device()
    start = time.perf_counter()

    def elapsed(done):
        print(f"  [{time.perf_counter() - start:.1f} s since the build began: {done}]")

    t0 = time.perf_counter()
    _build.load_library()
    print(f"[3] built and loaded {_build.library_path().name} in {time.perf_counter() - t0:.2f} s")
    print("\n".join(ptxas_lines(_build.ptxas_report())))

    k1_err, fused, wide_err, wide = phase_kernel(dev, card)
    k2_err, k2_times = phase_select(dev, card)
    keyed_err, keyed_times, k2_csr_times = phase_keyed(dev, card)
    k3_err, k3_times = phase_metrics(dev, card)
    elapsed("the kernel phases")
    k3_by_path = {}  # K3's launches on each path below, read with its other counts

    train, test = ml1m_split()
    # count only the main path's launches
    _reset_counters()
    phase_slice(dev, card, train, test)
    wide_launches = _counter("k1.wide_launches")
    k1_launches = _counter("k1.launches") - wide_launches  # the fused kernel's
    merge_launches = _counter("k1.merge_launches")
    if k1_launches == 0 or wide_launches == 0 or merge_launches == 0:
        fail(f"the GANMF path launched K1's fused kernel {k1_launches} times (its merge pass "
             f"{merge_launches} times) and its wide pair {wide_launches} times")
    if not _k3_launches("GANMF serving", k3_by_path):
        fail("the GANMF path's evaluations on the card did not launch K3")

    # GANMF's training path, its counts read alone
    _reset_counters()
    ganmf_models = phase_ganmf_train(dev, card, train, test)
    train_wide = _counter("k1.wide_launches")
    train_fused = _counter("k1.launches") - train_wide
    train_merge = _counter("k1.merge_launches")
    _k3_launches("GANMF training", k3_by_path)
    if train_fused == 0 or train_wide == 0:
        fail(f"GANMF's training path launched K1's fused kernel {train_fused} times and its wide "
             f"pair {train_wide} times")
    phase_ganmf_train_plain(dev, card, train, test, ganmf_models)
    elapsed("GANMF")
    ganmf_user = ganmf_models["user"][0]  # phase 30 evaluates it again
    del ganmf_models

    train, test = lastfm_split()
    _reset_counters()
    models = phase_cfgan(dev, card, train, test)
    k2_launches = _counter("k2.launches")
    _k3_launches("CFGAN training", k3_by_path)
    if k2_launches < 2 * CFGAN_EPOCHS:
        fail(f"the CFGAN path launched K2 {k2_launches} times, under once per epoch")
    phase_cfgan_plain(dev, card, train, test, models)
    elapsed("CFGAN")
    del models

    # DisGANMF's training path on the LastFM-shaped split, its counts read alone
    _reset_counters()
    dis_models = phase_disganmf(dev, card, train, test)
    dis_wide = _counter("k1.wide_launches")
    dis_fused = _counter("k1.launches") - dis_wide
    dis_merge = _counter("k1.merge_launches")
    _k3_launches("DisGANMF training", k3_by_path)
    if dis_fused == 0 or dis_wide == 0:
        fail(f"DisGANMF's training path launched K1's fused kernel {dis_fused} times and its wide pair "
             f"{dis_wide} times")
    phase_disganmf_plain(dev, card, train, test, dis_models)
    elapsed("DisGANMF")
    del dis_models

    # PureSVD's serving path on the ML-1M-shaped split with cold users
    train, test = ml1m_cold_split()
    _reset_counters()
    svd, svd_ev = phase_puresvd(dev, card, train, test)
    svd_wide = _counter("k1.wide_launches")
    svd_fused = _counter("k1.launches") - svd_wide
    svd_merge = _counter("k1.merge_launches")
    _k3_launches("PureSVD serving", k3_by_path)
    if svd_fused == 0 or svd_wide == 0:
        fail(f"PureSVD's serving path launched K1's fused kernel {svd_fused} times and its wide pair "
             f"{svd_wide} times")
    phase_puresvd_plain(dev, card, train, test, svd, svd_ev)
    elapsed("PureSVD")
    del svd

    # CAAE's training path on the ML-1M-shaped split, its K2 count read alone
    train, test = ml1m_split()
    _reset_counters()
    caae, caae_ev = phase_caae(dev, card, train, test)
    caae_k2 = _counter("k2.launches")
    _k3_launches("CAAE training", k3_by_path)
    if caae_k2 < CAAE_EPOCHS:
        fail(f"the CAAE path launched K2 {caae_k2} times, under once per epoch")
    phase_caae_plain(dev, card, train, test, caae, caae_ev)
    elapsed("CAAE")
    del caae

    # TopPop on the ML-1M-shaped split: the dense route, no kernel
    _reset_counters()
    phase_toppop(dev, card, train, test)
    _k3_launches("TopPop serving", k3_by_path)
    if _counter("k1.launches"):
        fail(f"TopPop's path launched K1 {_counter("k1.launches")} times: it ranks by the dense route")
    elapsed("TopPop")

    # the new phases write their splits, logs and results under SCRATCH
    shutil.rmtree(SCRATCH, ignore_errors=True)
    split_dir = os.path.join(SCRATCH, "splits")
    os.makedirs(split_dir)
    # IALS's serving path: run_best at the committed LastFM params
    _reset_counters()
    phase_ials_run_best(dev, card, split_dir, SCRATCH)
    ials_serve_wide = _counter("k1.wide_launches")
    ials_serve_fused = _counter("k1.launches") - ials_serve_wide
    ials_serve_merge = _counter("k1.merge_launches")
    _k3_launches("IALS serving", k3_by_path)
    if ials_serve_fused == 0:
        fail("IALS run_best's test evaluation did not launch K1's fused kernel")
    # IALS's training path: early stopping, then serving on the trained model
    train, test = lastfm_split()
    _reset_counters()
    phase_ials_train(dev, card, train, test)
    ials_wide = _counter("k1.wide_launches")
    ials_fused = _counter("k1.launches") - ials_wide
    ials_merge = _counter("k1.merge_launches")
    _k3_launches("IALS training", k3_by_path)
    if ials_fused == 0 or ials_wide == 0:
        fail(f"IALS's training path launched K1's fused kernel {ials_fused} times and its wide pair "
             f"{ials_wide} times")
    phase_ials_csr(dev, card, train)
    train, test = ml1m_split()
    phase_ials_plain(dev, card, train, test)
    elapsed("IALS")

    # the tuner on the ML-1M-shaped split, its counts read alone
    _reset_counters()
    phase_tuner(dev, card, split_dir, SCRATCH)
    tuner_wide = _counter("k1.wide_launches")
    tuner_fused = _counter("k1.launches") - tuner_wide
    tuner_merge = _counter("k1.merge_launches")
    _k3_launches("tuner", k3_by_path)
    if tuner_fused == 0:
        fail("the tuner's validations did not launch K1's fused kernel")
    elapsed("the tuner")

    # the similarity family: each path's counts set to 0 just before it and
    # read just after; no kernel of the repo runs there
    def no_kernel(run, what):
        _reset_counters()
        run()
        if _counter("k1.launches") or _counter("k2.launches") or _counter("keyed.launches"):
            fail(f"{what} launched K1 {_counter("k1.launches")} times, K2 {_counter("k2.launches")} times and the keyed "
                 f"draw {_counter("keyed.launches")} times")
        print(f"  K1, K2 and keyed-draw launches on the {what} path: 0; K3 "
              f"{_k3_launches(what, k3_by_path)}")
        elapsed(what)

    train, test = lastfm_split()
    no_kernel(lambda: phase_itemknn(dev, card, train, test), "ItemKNN")
    no_kernel(lambda: phase_p3alpha_run_best(dev, card, SCRATCH), "P3alpha run_best")
    no_kernel(lambda: phase_slim(dev, card, train, SCRATCH), "SLIM-BPR")
    no_kernel(lambda: phase_sim_tuner(dev, card, split_dir, SCRATCH), "similarity tuner")
    train, test = ml1m_cold_split()
    no_kernel(lambda: phase_puresvd_itemknn(dev, card, train, test), "PureSVD itemKNN")

    # the remaining recommenders and the studies: each path's counts set to 0
    # just before it and read just after; the factor models rank through K1,
    # and none draws through K2
    new_paths = {}

    def through_k1(run, what):
        _reset_counters()
        run()
        wide, merge, k2 = _counter("k1.wide_launches"), _counter("k1.merge_launches"), _counter("k2.launches") + _counter("keyed.launches")
        fused = _counter("k1.launches") - wide
        if fused == 0 or k2:
            fail(f"the {what} path launched K1's fused kernel {fused} times and K2 {k2} times")
        new_paths[what] = (fused, wide, merge, k2)
        print(f"  launches on the {what} path: K1 fused {fused} (merge pass {merge}), wide pair {wide}, K2 {k2}, "
              f"K3 {_k3_launches(what, k3_by_path)}")
        elapsed(what)

    train, test = ml1m_split()
    through_k1(lambda: phase_mf_sgd(dev, card, train, test), "MF-SGD training")
    ltrain, ltest = lastfm_split()
    through_k1(lambda: phase_irgan(dev, card, ltrain, ltest), "IRGAN training")
    through_k1(lambda: phase_nmf(dev, card, train, test), "NMF serving")
    no_kernel(lambda: phase_ease_dense(dev, card, ltrain, ltest), "EASE-R dense")
    no_kernel(lambda: phase_ease_topk(dev, card, train, test), "EASE-R topK")
    through_k1(lambda: phase_studies(dev, card, split_dir, SCRATCH), "studies")

    # the single-card paths ported last (phases 27-32), each path's counts
    # set to 0 just before it and read just after: CFGAN's csr storage draws
    # through the keyed draw and K2 and ranks by the dense route
    def through_k2(run, what):
        _reset_counters()
        run()
        k2, drawn = _counter("k2.launches"), _counter("keyed.launches")
        if k2 == 0 or drawn == 0 or _counter("k1.launches"):
            fail(f"the {what} path launched K2 {k2} times, the keyed draw {drawn} times and K1 {_counter("k1.launches")}")
        print(f"  launches on the {what} path: K2 {k2}, keyed draw {drawn}, K1 0, "
              f"K3 {_k3_launches(what, k3_by_path)}")
        elapsed(what)
        return k2, drawn

    csr_k2, csr_keyed = through_k2(lambda: phase_cfgan_csr(dev, card, ltrain, ltest), "CFGAN csr training")
    m20_k2, m20_keyed = through_k2(lambda: phase_cfgan_20m(dev, card), "CFGAN csr ML-20M")
    no_kernel(lambda: phase_colblock(dev, card), "column-blocked similarity")
    no_kernel(lambda: phase_eval_extras(dev, card, train, test, ganmf_user), "evaluator extras")
    _reset_counters()
    dedup_epochs = phase_caae_dedup(dev, card, train)
    dedup_k2 = _counter("k2.launches")
    _k3_launches("CAAE dedup", k3_by_path)
    if dedup_k2 != dedup_epochs or _counter("keyed.launches"):  # one G step an epoch
        fail(f"the CAAE dedup path launched K2 {dedup_k2} times and the keyed draw {_counter("keyed.launches")} times")
    elapsed("CAAE dedup")
    phase_host(SCRATCH)

    # the mesh path (phases 33-34), its K1 counts set to 0 just before each
    # mesh run and read just after; the one-card runs it is held against are
    # not counted
    train, test = ml1m_split()
    mesh_ref, mesh_nccl_k1, shard_err, shard_t = phase_mesh_nccl(dev, card, train, test)
    k1_err = max(k1_err, shard_err)
    shard_items = train.shape[1] // MESH_GLOO["n_model"]
    fused[f"mesh item shard: B={MESH_SHARD_ROWS} K={NUM_FACTORS} I={shard_items} k=50"] = shard_t
    elapsed("the one-rank NCCL mesh")
    mesh_gloo_k1, _ = phase_mesh_gloo(dev, card, mesh_ref)
    elapsed("the gloo mesh")
    # DisGANMF, CFGAN and CAAE on a mesh (phases 35-36), each fit's counts set
    # to 0 just before its mesh run and read just after
    gan_refs, gan_nccl, k2_mesh_err, k2_mesh_times = phase_gan_mesh_nccl(dev, card)
    k2_err = max(k2_err, k2_mesh_err)
    elapsed("the one-rank NCCL mesh of DisGANMF, CFGAN and CAAE")
    gan_gloo = phase_gan_mesh_gloo(dev, card, gan_refs)
    elapsed("the gloo mesh of DisGANMF, CFGAN and CAAE")
    # IALS, MF-SGD, SLIM-BPR, EASE-R and ItemKNN on a mesh (phases 37-38),
    # each fit's counts set to 0 just before its mesh run and read just after
    base_refs, base_nccl = phase_baseline_mesh_nccl(dev, card)
    elapsed("the one-rank NCCL mesh of IALS, MF-SGD, SLIM-BPR and EASE-R")
    base_gloo = phase_baseline_mesh_gloo(dev, card, base_refs)
    del base_refs
    elapsed("the gloo mesh of IALS, MF-SGD, SLIM-BPR, EASE-R and ItemKNN")
    # the ML-20M stand-in (phase 39), its counts set to 0 just before its
    # stages and read just after
    m20s_fused, m20s_merge, m20s_k2, m20s_keyed, m20s_k3, m20s_k1, m20s_k2_times, m20s_k1_err = phase_ml20m(
        dev, card, SCRATCH)
    k3_by_path.update(m20s_k3)
    k1_err = max(k1_err, m20s_k1_err)
    fused.update(m20s_k1)
    elapsed("the ML-20M stand-in")
    # JAX's bf16 similarity routes (phase 40) and the graft entry points
    # (phase 41): no kernel of the repo runs there
    no_kernel(lambda: phase_bf16_routes(dev, card), "bf16 similarity routes")
    no_kernel(lambda: phase_graft(dev, card), "graft entry points")
    shutil.rmtree(SCRATCH)
    # training past the card's memory (phase 42), its counts set to 0 just
    # before its fits and read just after; the kernel comparisons come after
    _reset_counters()
    beyond_urm, beyond_expected = phase_beyond_hbm(dev, card)
    beyond_k2, beyond_keyed = _counter("k2.launches"), _counter("keyed.launches")
    _k3_launches("beyond HBM", k3_by_path)
    if beyond_k2 != beyond_expected or beyond_keyed != beyond_expected or _counter("k1.launches"):
        fail(f"the beyond-HBM path launched K2 {beyond_k2} times and the keyed draw {beyond_keyed} times "
             f"(CFGAN's G minibatches: {beyond_expected}) and K1 {_counter("k1.launches")} times")
    print(f"  launches on the beyond-HBM path: K2 {beyond_k2}, keyed draw {beyond_keyed} (one a CFGAN G "
          f"minibatch), K1 0")
    beyond_k2_times, beyond_keyed_times = phase_beyond_hbm_kernels(dev, card, beyond_urm)
    del beyond_urm
    elapsed("beyond the card's memory")
    # serving latency (phase 43), its counts set to 0 just before it and read
    # just after
    _reset_counters()
    latency_models = phase_serving_latency(dev, card)
    latency_wide, latency_merge = _counter("k1.wide_launches"), _counter("k1.merge_launches")
    latency_fused = _counter("k1.launches") - latency_wide
    _k3_launches("serving latency", k3_by_path)
    if latency_fused == 0 or latency_wide or _counter("k2.launches") or _counter("keyed.launches"):
        fail(f"the serving-latency path launched K1's fused kernel {latency_fused} times, its wide pair "
             f"{latency_wide} times and K2 {_counter("k2.launches")} times")
    print(f"  launches on the serving-latency path: K1 fused {latency_fused} (merge pass {latency_merge}), "
          f"wide pair 0, K2 0")
    latency_err, latency_times = phase_serving_kernels(dev, card, latency_models)
    k1_err = max(k1_err, latency_err)
    fused.update(latency_times)
    del latency_models
    elapsed("serving latency")

    eval_shape, *other_shapes = fused
    wide_shape, *wide_others = wide
    k2_times.update(k2_csr_times)  # K2 at the csr storage's minibatch shapes too
    k2_times.update(k2_mesh_times)  # and at a data rank's shapes on phase 36's mesh
    k2_times.update(m20s_k2_times)  # and at CFGAN's minibatch on the ML-20M stand-in's rows
    k2_times.update(beyond_k2_times)  # and on its streamed-row route past the card's memory
    keyed_times.update(beyond_keyed_times)
    k2_shape, *k2_others = k2_times
    # each path's counts were set to 0 just before it and read just after; a
    # kernel's launches are the sum over the paths it carries
    fused_by_path = {"GANMF serving": k1_launches, "GANMF training": train_fused,
                     "DisGANMF training": dis_fused, "PureSVD serving": svd_fused,
                     "IALS serving": ials_serve_fused, "IALS training": ials_fused, "tuner": tuner_fused,
                     "GANMF mesh, one rank over NCCL": mesh_nccl_k1,
                     "GANMF mesh, 4 gloo ranks on the card": mesh_gloo_k1}
    wide_by_path = {"GANMF serving": wide_launches, "GANMF training": train_wide,
                    "DisGANMF training": dis_wide, "PureSVD serving": svd_wide, "IALS training": ials_wide}
    k2_by_path = {"CFGAN training": k2_launches, "CAAE training": caae_k2, "CFGAN csr training": csr_k2,
                  "CFGAN csr ML-20M": m20_k2, "CAAE dedup": dedup_k2}
    keyed_by_path = {"CFGAN csr training": csr_keyed, "CFGAN csr ML-20M": m20_keyed}
    fused_by_path["ML-20M stand-in"] = m20s_fused
    k2_by_path["ML-20M stand-in"] = m20s_k2
    keyed_by_path["ML-20M stand-in"] = m20s_keyed
    merge_launches += m20s_merge
    k2_by_path["beyond HBM"] = beyond_k2
    keyed_by_path["beyond HBM"] = beyond_keyed
    fused_by_path["serving latency"] = latency_fused
    merge_launches += latency_merge
    for where, counts in (("one rank over NCCL", gan_nccl), ("4 gloo ranks on the card", gan_gloo)):
        for name, (n_k1, n_k2, n_keyed) in counts.items():
            if n_k1:
                fused_by_path[f"{name} mesh, {where}"] = n_k1
            if n_k2:
                k2_by_path[f"{name} mesh, {where}"] = n_k2
            if n_keyed:
                keyed_by_path[f"{name} mesh, {where}"] = n_keyed
    for where, counts in (("one rank over NCCL", base_nccl), ("4 gloo ranks on the card", base_gloo)):
        for name, n_k1 in counts.items():
            if n_k1:
                fused_by_path[f"{name} mesh, {where}"] = n_k1
    keyed_shape, *keyed_others = keyed_times
    (k3_shape, k3_t), = k3_times.items()
    for what, (n_fused, n_wide, n_merge, n_k2) in new_paths.items():
        fused_by_path[what], wide_by_path[what], k2_by_path[what] = n_fused, n_wide, n_k2
        merge_launches += n_merge
    print(json.dumps({"kernels": [
        {
            "name": "masked_topk_scores (K1, fused kernel and merge pass, k <= 64)",
            "route": "cuda",
            "source": "ganmf_tpu_torch/csrc/masked_topk.cu",
            "replaces": "ganmf_tpu/ops/pallas_scorer.py:26",
            "launches": sum(fused_by_path.values()),
            "launches_by_path": fused_by_path,
            "merge_launches": (merge_launches + train_merge + dis_merge + svd_merge + ials_serve_merge
                               + ials_merge + tuner_merge),
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
            "launches": sum(wide_by_path.values()),
            "launches_by_path": wide_by_path,
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
            "launches": sum(k2_by_path.values()),
            "launches_by_path": k2_by_path,
            "max_abs_err": k2_err,
            "shape": k2_shape,
            **k2_times[k2_shape],
            "other_shapes": [{"shape": name, **k2_times[name]} for name in k2_others],
        },
        {
            "name": "keyed_uniforms (CFGAN csr storage's per-row Philox4x32-10 draw; not a TPU kernel)",
            "route": "cuda",
            "source": "ganmf_tpu_torch/csrc/keyed.cu",
            "replaces": "ganmf_tpu/models/cfgan.py:156 (jax.random.uniform of fold_in(key, row), drawn by "
                        "XLA: no TPU kernel)",
            "launches": sum(keyed_by_path.values()),
            "launches_by_path": keyed_by_path,
            "max_abs_err": keyed_err,
            "shape": keyed_shape,
            **keyed_times[keyed_shape],
            "other_shapes": [{"shape": name, **keyed_times[name]} for name in keyed_others],
        },
        {
            "name": "evaluate_pairs (K3, an evaluation block's metrics at every cutoff; not a TPU kernel)",
            "route": "cuda",
            "source": "ganmf_tpu_torch/csrc/block_metrics.cu",
            "replaces": "ganmf_tpu/eval/metrics.py _evaluate_core (XLA ops: no TPU kernel)",
            "launches": sum(k3_by_path.values()),
            "launches_by_path": k3_by_path,
            "max_abs_err": k3_err,
            "shape": k3_shape,
            **k3_t,
        },
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of phase 34, started by main()
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--gan-mesh-rank"]:  # a rank of phase 36, started by main()
        sys.exit(gan_mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--baseline-mesh-rank"]:  # a rank of phase 38, started by main()
        sys.exit(baseline_mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
