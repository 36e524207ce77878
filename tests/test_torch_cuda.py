"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs on a machine without it (where tests/conftest.py,
which imports jax, is skipped):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

K1 is compared two ways. On continuous factors (uniform in +-0.05, the
scale of trained factors, at which a TF32 or bf16 product misses by orders
of magnitude): values within rtol 1e-5 / atol 1e-7 of the plain version's
(float32 products summed in another order than cuBLAS), ids equal at every
finite slot except where the two items' plain scores lie within that
tolerance (a near-tie the two summation orders may break either way). On
factors on a grid (64ths, or eighths with duplicated items for exact ties),
where every dot product is exact in float32 whatever the summation order:
values and ids equal at every finite slot, exact ties to the lowest id.
Always: the same finite slots, no masked item ranked, real ids in -inf
tails. K1's fused kernel at k = 64 and its wide pair at k = 65 compute
every score by the same fmaf chain, so on continuous factors their first
64 slots are bitwise equal.
The wide pair is also held to that at the widths where its layout changes
(one tile, the tile boundary, rows whose kept keys no longer fit the rank
kernel's shared memory) and at k just above 64 and k = I - 1.
K2 masks bitwise equal to the plain version's, on each of its three paths
(short rows in 128-thread blocks, longer rows in shared memory, streamed
rows) and their boundaries, and for any k (clamped to [0, I] as the JAX
function does).
Neither wrapper synchronizes the host, nor does a GANMF, DisGANMF or CAAE
epoch. One CFGAN epoch, and one GANMF and one DisGANMF epoch in both modes,
on the card against the CPU: masks bitwise, parameters within 2.2 * lr per
Adam step (a gradient at rounding level may change sign and move its element
by up to about lr either way), with 99% of the elements within 1% of lr; the
mean losses within rtol 1e-4. One CAAE epoch from the same draws: every
tensor within 1% of the distance the epoch moved it (CUDA's index_add_ sums
duplicate rows in another order). A PureSVD fit on the card: scores within
2e-4 of their scale of the CPU fit's from the same Omega, cold users empty in
recommend_fused and serve_all. A GANMF fit with early stopping on the card
launches K1 from its evaluations, and run_best trains and scores on the card
by default. One IALS epoch on the card in each storage: every factor row
within 1e-4 of its norm of the CPU's (CG's residual exit at 1e-5 of ||b||
bounds how far two summation orders leave a solution), the csr forms within
rtol 2e-4 / atol 2e-6 of the card's dense form; TF32 off through an IALS fit
whose validations launch K1; TopPop's lists on the card equal to the CPU's;
one tuner trial on the card writes the experiment's artifacts.
The similarity family launches no kernel of the repo: ``tiled_topk`` on the
card bitwise the CPU's; the Gram of 0/1 data bitwise the CPU's on both routes;
ItemKNN's W on 0/1 data within rtol 1e-6 of the CPU's; on real-valued data
(where scores have no exact ties for two summation orders to break either
way) each model's W within rtol 1e-5 and its metrics within 1e-5; the sparse
W route within 1e-6 of the dense one; one SLIM-BPR epoch within 2.2 x lr;
PureSVD's itemKNN estimate, from factors on a grid (exact scores): its W
bitwise the CPU's, and the model ranked by the dense route with the CPU's
metrics (the estimate scores no user, as in the JAX package).
The remaining recommenders: one MF-SGD epoch (BPR and AsySVD, dense and csr
storage) from the same state and draws within 1e-5 of the CPU's, and the
draws and an epoch under ``set_sync_debug_mode("error")``; a BPR fit whose
validations launch K1, with the CPU's metrics; IRGAN's first 4 pretraining
and adversarial chunks from the same Gumbel noise, every table within 1% of
the distance it moved or 8 ulps of its largest entry, and each table that
moved moved 10 times its gate or more; 5 NMF iterations from one init within
1e-4 of the largest factor; EASE-R's W, dense and pruned, within 1e-4 of
max|B|; K1 at the shapes these models' evaluations and `recommend` give it.
The keyed per-row draw of CFGAN's csr storage bitwise its
plain version (and not synchronizing); one CFGAN csr epoch in both modes,
card against CPU (the keyed masks bitwise, parameters within the Adam bound,
K2 and the keyed draw launched once a minibatch for each mask drawn), and in
a CFGAN csr fit each G minibatch launching the two once, from inside its
``train.masks`` span, and each D minibatch neither; past
the card's memory: K2's streamed-row route at [128, 65536] and [128, 131072]
on keyed-draw keys with ties bitwise its plain version, and CFGAN's csr
epoch at 8,192 x 131,072 without a host synchronization; the
column-blocked similarity build of 0/1 data in both forms bitwise the CPU's;
CAAE's dedup D phase, two card runs bitwise equal and within 1% of the
distance moved of the direct form.
The mesh path: K1 on each item shard of a (data 2, model 2) evaluation
block with its id offset, against the plain version, and the shards' merged
lists against K1 over every item; in a world of one rank over NCCL,
``sharded_topk`` bitwise ``topk_lowest_index`` and the sharded GANMF epoch
bitwise the one-card epoch, without a host synchronization; so too the
sharded epochs of DisGANMF, CFGAN (dense and csr, K2 and the keyed draw on
the mesh path) and CAAE (dedup, K2 on the mesh path).
JAX's bf16 similarity routes: ``bf16_mm`` keeps float32 outputs and
accumulates in place; the Gram of 0/1 data by bf16 products on the dense,
resident and streamed routes bitwise the float32 Gram and the CPU's; the
split-plane scoring product within rtol 1e-5 / atol 1e-7 of the CPU's, ids
equal but at near ties. The graft entry point ``entry()`` on the card,
eager and under torch.compile, within rtol 1e-5 of the CPU's losses.
The port's tracing: the host_sync counter against the synchronizations of
CUDA's sync debug mode over a GANMF epoch, an evaluation and ``recommend``,
and a program span against its kernel in a profile of the card.
K3, an evaluation block's metrics: against its plain version on the cases of
tests/test_torch_metrics.py and at ML-20M's block shape (counters equal, the
sums and each user's AP within rtol 1e-5: float32 sums in another order),
two runs bitwise equal and no synchronization, the shapes, types and devices
it refuses, and a GANMF evaluation at ML-20M's block shape that launches it
once a block, gives the CPU's metrics and meets no synchronization in a
block's ranking and metrics.
The library is built and loaded once, with ptxas's lines for every kernel.
Fits on the card by default, each against a CPU copy of what it trained:
GANMF and DisGANMF in both modes ranked through K1 (the wide pair at
recommend's default cutoff); CFGAN (dense and csr) and CAAE by the dense
route, ranking the card's scores on the CPU (evaluation within 1e-6, ids
equal); the MF-SGD family, IRGAN, NMF and PureSVD through K1. The evaluator
with a diversity object and EvaluatorNegativeItemSample (the dense route);
the paper's studies; and the mesh fits and evaluations of GANMF, DisGANMF,
CFGAN, CAAE and IALS with a plan over a world of one on NCCL against the
one-card path (metrics within 1e-5).
"""

import contextlib
import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.data.device import padded_csr_from_sparse
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.eval.metrics import (
    evaluate_pairs,
    evaluate_pairs_cuda,
    evaluate_pairs_reference,
    item_novelty_terms,
    normalized_popularity,
    pairs_from_sparse,
)
from ganmf_tpu_torch.models import GANMF, init_params
from ganmf_tpu_torch.models import cfgan as pcf
from ganmf_tpu_torch.models import ganmf as pgm
from ganmf_tpu_torch.models.gan_base import make_batches, padded_weights, shuffled_padded_perm
from ganmf_tpu_torch.ops import scorer, select
from ganmf_tpu_torch.ops.scorer import masked_topk_scores, masked_topk_scores_reference
from ganmf_tpu_torch.ops.topk import smallest_k_mask, smallest_k_mask_reference
from ganmf_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


def _counter(name: str) -> int:
    """A counter of the port (ganmf_tpu_torch/utils/profiling.py)."""
    return profiling.counters().get(name, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def test_library_is_built_once_with_ptxas_lines_for_every_kernel(cuda):
    """The kernel library of the current sources is built and loaded once;
    the ptxas report kept beside it has each kernel's entry and register
    lines."""
    import re

    from ganmf_tpu_torch.ops import _build

    lib = _build.load_library()
    assert _build.load_library() is lib and _build.library_path().is_file()
    report = _build.ptxas_report()
    entries = re.findall(r"Compiling entry function '(\w+)'", report)
    for kernel in ("masked_topk_kernel", "merge_splits_kernel", "wide_tiles_kernel", "rank_tiles_kernel",
                   "select_block_kernel", "keyed_uniforms_kernel", "block_metrics_kernel",
                   "block_metrics_sum_kernel"):
        assert any(kernel in e for e in entries), kernel
    assert len(re.findall(r"Used \d+ registers", report)) >= len(entries)


RTOL, ATOL = 1e-5, 1e-7
EXACT = ("grid", "ties")  # the cases whose scores are exact in float32


def _inputs(case, B, I, K, seed=0):
    rng = np.random.RandomState(seed)
    if case == "ties":
        # duplicated item rows on a grid of eighths: duplicates tie bitwise
        U = rng.randint(-4, 5, (B, K)).astype(np.float32) / 8
        base = rng.randint(-4, 5, (max(I // 4, 1), K)).astype(np.float32) / 8
        V = base[rng.randint(0, len(base), I)]
    elif case == "grid":
        U = rng.randint(-64, 65, (B, K)).astype(np.float32) / 64
        V = rng.randint(-64, 65, (I, K)).astype(np.float32) / 64
    else:  # "random", "masked_rows": continuous factors
        U = ((rng.rand(B, K) * 2 - 1) * 0.05).astype(np.float32)
        V = ((rng.rand(I, K) * 2 - 1) * 0.05).astype(np.float32)
    mask = rng.rand(B, I) < 0.2
    if case == "masked_rows":
        mask[1 % B] = True  # fully masked
        mask[min(6, B - 1)] = True
        mask[min(6, B - 1), ::9] = False  # fewer unmasked items than k when I < 9k
    return U, V, mask


def _assert_k1_matches(U, V, mask, k, vals, ids, exact):
    ref_vals, ref_ids = masked_topk_scores_reference(U, V, mask, k)
    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
    ref_vals, ref_ids = ref_vals.cpu().numpy(), ref_ids.cpu().numpy()
    fin = np.isfinite(ref_vals)
    np.testing.assert_array_equal(np.isfinite(vals), fin)
    assert ids.min() >= 0 and ids.max() < V.shape[0]  # -inf tails hold real items
    assert not np.take_along_axis(mask.cpu().numpy(), ids, axis=1)[fin].any()
    if exact:
        np.testing.assert_array_equal(vals[fin], ref_vals[fin])
        np.testing.assert_array_equal(ids[fin], ref_ids[fin])
        return
    np.testing.assert_allclose(vals[fin], ref_vals[fin], rtol=RTOL, atol=ATOL)
    diff = (ids != ref_ids) & fin  # near-ties only
    if diff.any():
        rows = torch.from_numpy(np.nonzero(diff)[0]).to(U.device)
        scores = (U[rows] @ V.T).cpu().numpy()  # the plain version's scores of those rows
        at = np.arange(len(rows))
        np.testing.assert_allclose(scores[at, ids[diff]], scores[at, ref_ids[diff]],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["random", "grid", "ties", "masked_rows"])
@pytest.mark.parametrize("I,k", [(3706, 50), (1001, 20), (96, 5), (257, 64), (6040, 50),
                                 (3706, 3705), (257, 65), (96, 96), (17632, 100)])
@pytest.mark.parametrize("K", [64, 250, 33])
@pytest.mark.parametrize("B", [1, 5, 37, 3024])
def test_kernel_matches_plain(cuda, B, K, I, k, case):
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs(case, B, I, K))
    before, wide_before = _counter("k1.launches"), _counter("k1.wide_launches")
    vals, ids = masked_topk_scores(U, V, mask, k)
    assert _counter("k1.launches") == before + 1
    assert _counter("k1.wide_launches") == wide_before + (k > scorer.MAX_K)
    _assert_k1_matches(U, V, mask, k, vals, ids, case in EXACT)


@pytest.mark.parametrize("case", ["random", "grid", "ties", "masked_rows"])
@pytest.mark.parametrize("B,K,I,k", [
    (3024, 10, 3706, 50),  # BPR's evaluation block: K below one 16-wide slice
    (3024, 12, 3706, 50),  # FunkSVD's and AsySVD's, two bias columns folded in
    (1884, 11, 17632, 50),  # IRGAN's, its bias folded in as a ones column
    (3024, 100, 3706, 50),  # NMF's
    (3024, 30, 3706, 5),  # the latent-factor study's MAP@5 at K=30 and K=150
    (3024, 150, 3706, 5),
    (5, 10, 3706, 3705),  # recommend's default cutoff, through the wide pair
    (5, 11, 17632, 17631),
    (5, 100, 3706, 3705),
])
def test_kernel_at_the_factor_models_shapes(cuda, B, K, I, k, case):
    """K1 at the shapes the MF-SGD, IRGAN and NMF evaluations and the studies
    give it, against its plain version."""
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs(case, B, I, K))
    before = _counter("k1.launches")
    vals, ids = masked_topk_scores(U, V, mask, k)
    assert _counter("k1.launches") == before + 1
    _assert_k1_matches(U, V, mask, k, vals, ids, case in EXACT)


@pytest.mark.parametrize("case", ["random", "ties", "masked_rows"])
@pytest.mark.parametrize("B,I,K", [(37, 3706, 250), (3024, 3706, 250), (5, 257, 33),
                                   (3648, 26744, 128), (1000, 3706, 128), (200, 1001, 64)])
def test_fused_and_wide_share_one_arithmetic(cuda, B, I, K, case):
    """The fused kernel at k = 64 and the wide pair at k = 65 return the same
    bits in the first 64 slots of every row: on continuous factors, where a
    different summation order would change the bits, and with exact ties.
    At K % 4 == 0 and a full row block the fused kernel takes its aligned
    main loop."""
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs(case, B, I, K))
    aligned = _counter("k1.aligned_launches")
    fused = masked_topk_scores(U, V, mask, scorer.MAX_K)
    assert _counter("k1.aligned_launches") == aligned + (K % 4 == 0 and B >= scorer.ALIGNED_MIN_ROWS)
    before = _counter("k1.wide_launches")
    wide = masked_topk_scores(U, V, mask, scorer.MAX_K + 1)
    assert _counter("k1.wide_launches") == before + 1
    fin = torch.isfinite(fused[0])
    assert torch.equal(fused[0], wide[0][:, :scorer.MAX_K])
    assert torch.equal(fused[1][fin], wide[1][:, :scorer.MAX_K][fin])


def test_merge_pass_at_the_evaluation_shape(cuda):
    """At B=3024 K=250 I=3706 k=50 the plan splits the items, the merge pass
    runs, and the result matches the plain version."""
    from ganmf_tpu_torch.ops._build import load_library

    lib = load_library()
    for aligned in (False, True):  # each route's tiling as the kernel fixes it
        assert lib.ganmf_masked_topk_smem_bytes(int(aligned)) == scorer.fused_smem_bytes(aligned)
        assert lib.ganmf_masked_topk_blocks_per_sm(int(aligned)) == scorer.BLOCKS_PER_SM
    plan = scorer.fused_plan(3024, 3706, 50, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.splits > 1
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs("random", 3024, 3706, 250))
    before = _counter("k1.merge_launches")
    vals, ids = masked_topk_scores(U, V, mask, 50)
    assert _counter("k1.merge_launches") == before + 1
    assert scorer.LAST_SPLITS == plan.splits
    _assert_k1_matches(U, V, mask, 50, vals, ids, exact=False)


def _unaligned(monkeypatch):
    """Sends every fused launch to the other main loop."""
    monkeypatch.setattr(scorer, "ALIGNED_MIN_ROWS", 1 << 40)


@pytest.mark.parametrize("case", ["random", "grid", "ties", "masked_rows"])
@pytest.mark.parametrize("B,K,I,k", [
    (3648, 128, 26744, 50),  # ML-20M's evaluation block: item splits and the merge pass
    (3648, 64, 26744, 64),
    (100, 64, 3706, 1),  # B not a multiple of the row tile, I % 16 != 0
    (100, 128, 3706, 64),
    (1000, 64, 1001, 50),
    (3000, 128, 250, 50),  # one tile: a single split, no merge pass
])
def test_aligned_route_matches_plain_and_the_other_loop(cuda, B, K, I, k, case, monkeypatch):
    """The aligned main loop against the plain version, and bitwise against
    the other main loop on the same inputs (one arithmetic): values and
    ids, the -inf tails of masked_rows included."""
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs(case, B, I, K))
    before, aligned = _counter("k1.launches"), _counter("k1.aligned_launches")
    vals, ids = masked_topk_scores(U, V, mask, k)
    assert _counter("k1.launches") == before + 1 and _counter("k1.aligned_launches") == aligned + 1
    plan = scorer.fused_plan(B, I, k, torch.cuda.get_device_properties(cuda).multi_processor_count, True)
    assert scorer.LAST_SPLITS == plan.splits and (plan.splits > 1) == (I > plan.items_per_tile)
    _assert_k1_matches(U, V, mask, k, vals, ids, case in EXACT)
    _unaligned(monkeypatch)
    other = masked_topk_scores(U, V, mask, k)
    assert _counter("k1.aligned_launches") == aligned + 1
    assert torch.equal(vals, other[0]) and torch.equal(ids, other[1])


@pytest.mark.parametrize("K", [64, 128])
def test_aligned_route_on_an_item_shard(cuda, K, monkeypatch):
    """A mesh rank's item slice V[i0:i1] with its mask columns and
    id_offset: the aligned loop ranks it, ids global, as the other loop
    does."""
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs("masked_rows", 700, 9000, K))
    i0, i1 = 1237, 6001
    shard, seen = V[i0:i1], mask[:, i0:i1].contiguous()
    aligned = _counter("k1.aligned_launches")
    vals, ids = masked_topk_scores(U, shard, seen, 50, id_offset=i0)
    assert _counter("k1.aligned_launches") == aligned + 1
    _assert_k1_matches(U, shard, seen, 50, vals, ids - i0, exact=False)
    _unaligned(monkeypatch)
    other = masked_topk_scores(U, shard, seen, 50, id_offset=i0)
    assert torch.equal(vals, other[0]) and torch.equal(ids, other[1])


@pytest.mark.parametrize("B,K,aligned", [(3648, 128, True), (1, 250, False), (1, 128, False),
                                         (3648, 250, False), (63, 64, False), (64, 64, True)])
def test_aligned_route_is_taken_where_it_applies(cuda, B, K, aligned):
    """k1.aligned_launches counts each launch of the aligned loop: at the
    evaluation block's shape, and never at serving's B=1, at K % 4 != 0 or
    below a full row block; factors off a 16-byte boundary take the other
    loop too."""
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs("random", B, 3706, K))
    before = _counter("k1.aligned_launches")
    for _ in range(2):
        masked_topk_scores(U, V, mask, 20)
    assert _counter("k1.aligned_launches") == before + 2 * aligned
    if aligned:  # the same factors one float past a 16-byte boundary
        U4 = torch.empty(B * K + 1, device=cuda)[1:].view(B, K).copy_(U)
        before = _counter("k1.aligned_launches")
        vals, ids = masked_topk_scores(U4, V, mask, 20)
        assert _counter("k1.aligned_launches") == before
        _assert_k1_matches(U, V, mask, 20, vals, ids, exact=False)


@pytest.mark.parametrize("case", ["random", "grid"])
@pytest.mark.parametrize("I", [97, 3706, 17632, 65536])
@pytest.mark.parametrize("B", [1, 5, 37])
@pytest.mark.parametrize("at", ["k=65", "k=I-1"])
def test_wide_pair_matches_plain(cuda, B, I, at, case):
    """The wide pair at one tile (97 items), recommend's catalog, LastFM's
    and a row of 128 tiles, just above the fused kernel's k and at I - 1."""
    k = scorer.MAX_K + 1 if at == "k=65" else I - 1
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs(case, B, I, 64))
    before = _counter("k1.wide_launches")
    vals, ids = masked_topk_scores(U, V, mask, k)
    assert _counter("k1.wide_launches") == before + 1
    _assert_k1_matches(U, V, mask, k, vals, ids, case in EXACT)


@pytest.mark.parametrize("tile", scorer.WIDE_TILES)
@pytest.mark.parametrize("I,k", [(128, 127), (129, 128), (512, 100), (513, 512), (6144, 6143),
                                 (6145, 6144), (6145, 100), (40000, 39999)])
def test_wide_pair_at_its_layout_boundaries(cuda, I, k, tile, monkeypatch):
    """Every tile width at rows of exactly one tile and one item more, and
    where the rank kernel's kept keys (48 KB a round: 12 tiles x 512 at k >=
    512) first take a second round, and many rounds (40000 items)."""
    plan = scorer.wide_plan
    monkeypatch.setattr(scorer, "wide_plan", lambda B, I, k, sms: plan(B, I, k, sms, tile=tile))
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs("masked_rows", 9, I, 33))
    vals, ids = masked_topk_scores(U, V, mask, k)
    _assert_k1_matches(U, V, mask, k, vals, ids, exact=False)


def test_wide_kernel_in_row_chunks(cuda, monkeypatch):
    """The wide pair ranks the rows in chunks whose kept keys fit its
    scratch buffer; chunks of 4 rows give the lists of one chunk, bitwise."""
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs("random", 37, 9000, 32))
    whole = masked_topk_scores(U, V, mask, 500)
    monkeypatch.setattr(scorer, "WIDE_SCRATCH_BYTES", 4 * 8 * 18 * 500)  # 18 tiles of 500
    assert scorer.wide_plan(37, 9000, 500).chunk_rows == 4
    chunked = masked_topk_scores(U, V, mask, 500)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
    _assert_k1_matches(U, V, mask, 500, *chunked, exact=False)


def test_kernel_rejects_what_it_does_not_take(cuda):
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs("random", 4, 100, 8))
    with pytest.raises(ValueError):
        masked_topk_scores(U, V, mask, 101)  # k > I
    with pytest.raises(ValueError):
        masked_topk_scores(U, V.T.contiguous().T, mask, 5)  # not contiguous
    with pytest.raises(ValueError):
        masked_topk_scores(U, V.cpu(), mask, 5)  # devices differ


def _k3_case(case, dev, seed=0, B=24, I=70, K=20, cutoffs=(5, 10, 20), max_test=None):
    """(evaluate_pairs' arguments, on ``dev``) for one of the cases that
    tests/test_torch_metrics.py holds the plain version to the dense
    computation with; "ml20m" is ML-20M's evaluation block (test rows of up
    to ``max_test`` items, most short)."""
    rng = np.random.RandomState(seed)
    if case == "ml20m":
        lens = np.minimum(rng.zipf(1.6, size=B), max_test)
        lens[:4] = max_test
        test = np.zeros((B, I), np.float32)
        for b, n in enumerate(lens):
            test[b, rng.choice(I, size=n, replace=False)] = rng.randint(1, 6, size=n)
    else:
        density = {"npos_above_k": 0.6, "cutoff_beyond_list": 0.3}.get(case, 0.15)
        test = (rng.rand(B, I) < density).astype(np.float32)
        if case in ("negative", "cutoff_beyond_list"):
            test *= rng.choice([-3.0, -1.0, 1.0, 2.0, 4.0], size=test.shape)
        elif case != "implicit":
            test *= rng.randint(1, 6, size=test.shape)
    vals = -np.sort(-rng.randn(B, K).astype(np.float32), axis=1)
    idx = np.stack([rng.permutation(I)[:K] for _ in range(B)]).astype(np.int64)
    for b in range(B):  # each row's first places on its test items, where it has them
        hit = np.flatnonzero(test[b])[: K // 10 + 1]
        rest = [i for i in idx[b] if i not in hit]
        idx[b] = np.concatenate([hit, rest])[:K]
    valid = np.ones(B, bool)
    rmse = rng.rand(B).astype(np.float32)
    if case in ("short_lists", "ml20m"):
        vals[5, 12:] = -np.inf
        vals[6, :] = -np.inf
    if case in ("invalid_nan", "ml20m"):
        valid[[0, 9, B - 1]] = False
        rmse[[9, B - 1]] = np.nan
    if case == "unsorted_duplicates":  # ids out of order, some values split in two entries
        rows, cols = np.nonzero(test)
        data = test[rows, cols]
        split = rng.rand(len(data)) < 0.3
        rows = np.concatenate([rows, rows[split]])
        cols = np.concatenate([cols, cols[split]])
        data = np.concatenate([np.where(split, data - 1.0, data), np.ones(split.sum())]).astype(np.float32)
        order = np.lexsort((rng.rand(len(rows)), rows))
        counts = np.bincount(rows, minlength=B)
        csr = sps.csr_matrix((data[order], cols[order].astype(np.int32), np.concatenate([[0], np.cumsum(counts)])),
                             shape=(B, I))
    else:
        csr = sps.csr_matrix(test)
    train = sps.csr_matrix((rng.rand(50, I) < 0.2).astype(np.float32))
    novelty = item_novelty_terms(train, I).astype(np.float32)
    pop = normalized_popularity(train).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (vals, idx)]
    t += [pairs_from_sparse(csr, dev), torch.arange(B, device=dev)]
    t += [torch.from_numpy(a).to(dev) for a in (np.diff(csr.indptr).astype(np.int64), valid, novelty, pop, rmse)]
    return (*t, cutoffs)


K3_CASES = {
    "implicit": {}, "explicit": {}, "negative": {}, "npos_above_k": {}, "short_lists": {}, "invalid_nan": {},
    "cutoff_beyond_list": dict(K=70, cutoffs=(5, 20, 100)), "unsorted_duplicates": {},
    "many_cutoffs": dict(K=70, cutoffs=tuple(range(1, 71, 3))),
    "ml20m": dict(B=3648, I=26744, K=50, cutoffs=(5, 10, 20, 50), max_test=2048),
}


def _assert_k3_close(got, want):
    np.testing.assert_array_equal(got.counters.cpu().numpy(), want.counters.cpu().numpy())
    np.testing.assert_allclose(got.user_ap.cpu().numpy(), want.user_ap.cpu().numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.scalars.cpu().numpy(), want.scalars.cpu().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_matches_its_plain_version(cuda, case):
    """K3 against the plain version on the same CUDA tensors: one launch a
    group of cutoffs, the counters equal, the sums and each user's AP within
    float32 summation order."""
    from ganmf_tpu_torch.ops._build import load_library

    args = _k3_case(case, cuda, **K3_CASES[case])
    before = _counter("k3.launches")
    got = evaluate_pairs(*args)
    want = evaluate_pairs_reference(*args)
    torch.cuda.synchronize()
    groups = -(-len(args[-1]) // load_library().ganmf_block_metrics_max_cutoffs())
    assert groups == (2 if case == "many_cutoffs" else 1)
    assert _counter("k3.launches") == before + groups
    _assert_k3_close(got, want)
    assert torch.isfinite(got.scalars).all()  # NaN RMSEs only on rows not counted


def test_k3_repeats_bitwise_and_does_not_sync(cuda):
    """Two runs at ML-20M's block shape give the same bits; a launch meets no
    synchronization under CUDA's sync debug mode."""
    args = _k3_case("ml20m", cuda, **K3_CASES["ml20m"])
    first = evaluate_pairs(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = evaluate_pairs(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_k3_rejects_what_it_does_not_take(cuda):
    args = list(_k3_case("explicit", cuda))
    with pytest.raises(TypeError):
        evaluate_pairs(args[0], args[1].int(), *args[2:])  # int32 ids
    with pytest.raises(ValueError):
        evaluate_pairs(args[0][:, :5].contiguous(), *args[1:])  # the lists' shapes differ
    with pytest.raises(ValueError):
        evaluate_pairs(args[0].T.contiguous().T, *args[1:])  # not contiguous
    with pytest.raises(ValueError):
        evaluate_pairs(*args[:8], args[8].cpu(), args[9])  # devices differ
    with pytest.raises(ValueError):
        evaluate_pairs_cuda(*_k3_case("explicit", torch.device("cpu")))  # the wrapper takes CUDA tensors
    with pytest.raises(ValueError):
        evaluate_pairs(*args[:9], ())  # no cutoff


def test_evaluation_launches_k3_once_a_block(cuda):
    """A K1-route evaluation of GANMF at ML-20M's block shape (3,648 users of
    26,744 items a block) counts one K3 launch a block and gives the CPU's
    metrics; the CPU's evaluation launches none. Its blocks' ranking and
    metrics meet no synchronization beyond the host_sync sites."""
    rng = np.random.RandomState(8)
    U, I, B = 7296, 26744, 3648
    lens = np.minimum(rng.zipf(1.6, size=U) + 4, 2048)
    rows = np.repeat(np.arange(U), lens)
    cols = np.concatenate([rng.choice(I, size=n, replace=False) for n in lens])
    held = rng.rand(len(rows)) < 0.2
    train = sps.csr_matrix((np.ones((~held).sum(), np.float32), (rows[~held], cols[~held])), shape=(U, I))
    test = sps.csr_matrix((rng.randint(1, 6, held.sum()).astype(np.float32), (rows[held], cols[held])),
                          shape=(U, I))
    models, results = {}, {}
    for dev in (cuda, torch.device("cpu")):
        model = GANMF(train, device=dev)
        model.params = init_params(U, I, 16, 32, torch.Generator().manual_seed(3), dev)
        ev = EvaluatorHoldout(test, [5, 10, 20, 50], device=dev)
        ev.block_rows = lambda: B
        blocks = -(-len(ev.usersToEvaluate) // B)
        before = _counter("k3.launches"), _counter("eval.blocks." + dev.type)
        results[dev.type], _ = ev.evaluateRecommender(model)
        assert _counter("eval.blocks." + dev.type) - before[1] == blocks
        assert _counter("k3.launches") - before[0] == (blocks if dev.type == "cuda" else 0)
        models[dev.type] = (model, ev)
    for c in results["cpu"]:
        for metric, value in results["cpu"][c].items():
            assert results["cuda"][c][metric] == pytest.approx(value, abs=1e-5), (c, metric)
    model, ev = models["cuda"]
    factors = model._factors_device()
    uids = torch.from_numpy(np.asarray(ev.usersToEvaluate[:B], np.int64)).to(cuda)
    n_pos, valid = ev._n_pos.index_select(0, uids), torch.ones(B, dtype=torch.bool, device=cuda)
    plan = ev._block_plan_cache
    novelty, pop = plan.novelty, plan.popularity
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vals, idx, rmse = ev._fused_block(model, factors, uids, max_len=2048, pair_len=2048)
        evaluate_pairs(vals, idx, ev._pairs, uids, n_pos, valid, novelty, pop, rmse, ev.cutoff_list)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_slice_on_card_matches_plain_cpu_path(cuda):
    """GANMF's recommend, serve_all and evaluation on the card (through K1)
    against the same weights on the CPU (plain version), in both modes."""
    rng = np.random.RandomState(0)
    full = (rng.rand(300, 500) < 0.05).astype(np.float32)
    held = rng.rand(300, 500) < 0.2
    train, test = sps.csr_matrix(full * ~held), sps.csr_matrix(full * held)
    cpu = torch.device("cpu")
    for mode in ("user", "item"):
        card = GANMF(train, mode=mode, device=cuda)
        n_rows, n_cols = card._train_matrix().shape
        card.params = init_params(n_rows, n_cols, 16, 32, torch.Generator().manual_seed(3), cuda)
        plain = GANMF(train, mode=mode, device=cpu)
        plain.params = init_params(n_rows, n_cols, 16, 32, torch.Generator().manual_seed(3), cpu)

        before = _counter("k1.launches")
        users = np.arange(20)
        assert card.recommend(users, cutoff=10) == plain.recommend(users, cutoff=10)
        idx, vals = card.serve_all(cutoff=20, block=128)
        pidx, pvals = plain.serve_all(cutoff=20, block=128)
        np.testing.assert_array_equal(idx, pidx)
        np.testing.assert_allclose(vals, pvals, rtol=1e-5, atol=1e-6)
        got, _ = EvaluatorHoldout(test, [5, 10, 20, 50], device=cuda).evaluateRecommender(card)
        want, _ = EvaluatorHoldout(test, [5, 10, 20, 50], device=cpu).evaluateRecommender(plain)
        assert _counter("k1.launches") >= before + 1 + 3 + 1  # recommend, 3 serve blocks, eval
        for c in want:
            for metric, value in want[c].items():
                assert got[c][metric] == pytest.approx(value, abs=1e-5), (mode, c, metric)


@pytest.mark.parametrize("kind", ["diversity", "negative_sample"])
def test_evaluator_extras_on_card_match_cpu(cuda, kind):
    """A GANMF model evaluated on the card with a diversity object (an
    ItemKNN cosine W built on the card) or by EvaluatorNegativeItemSample
    (30 sampled negatives a user): the dense route, K1 not launched, every
    metric within 1e-5 of a CPU copy's."""
    from ganmf_tpu_torch.eval import EvaluatorNegativeItemSample
    from ganmf_tpu_torch.ops.similarity import compute_similarity

    train, test = _sim_split(binary=True)
    cpu = torch.device("cpu")
    if kind == "diversity":
        div = compute_similarity(train, "cosine", topK=50, shrink=10.0, device=cuda)
        assert div.nnz > 0

        def make(dev):
            return EvaluatorHoldout(test, [5, 10, 20, 50], diversity_object=div, device=dev)
    else:
        keys = np.random.RandomState(1).rand(*train.shape)
        keys[(train + test).toarray() != 0] = np.inf  # negatives: neither trained nor tested
        cols = np.argpartition(keys, 30, axis=1)[:, :30]
        neg = sps.csr_matrix((np.ones(cols.size, np.float32), (np.repeat(np.arange(train.shape[0]), 30),
                                                               cols.ravel())), shape=train.shape)

        def make(dev):
            return EvaluatorNegativeItemSample(test, neg, [5, 10, 20, 50], device=dev)
    models = []
    for dev in (cuda, cpu):
        model = GANMF(train, device=dev)
        model.params = init_params(*train.shape, 16, 32, torch.Generator().manual_seed(3), dev)
        models.append(model)
    before = _counter("k1.launches")
    got, _ = make(cuda).evaluateRecommender(models[0])
    assert _counter("k1.launches") == before
    want, _ = make(cpu).evaluateRecommender(models[1])
    for c in want:
        for metric, value in want[c].items():
            assert got[c][metric] == pytest.approx(value, abs=1e-5, nan_ok=True), (c, metric)
    if kind == "diversity":
        assert got[10]["DIVERSITY_SIMILARITY"] > 0


def _select_case(case, R, I, seed=0):
    g = torch.Generator().manual_seed(seed)
    keys = torch.rand(R, I, generator=g)
    if case == "ties":
        keys = torch.round(keys * 8)
    elif case == "signed":
        keys = keys - 0.5
        keys[:, 0:8:2] = 0.0
        keys[:, 1:8:2] = -0.0
    inter = torch.rand(R, I, generator=g) < 0.0028 * 10
    keys = keys.masked_fill(inter, float("inf"))
    k = ((~inter).sum(1).float() * torch.tensor(0.4515475140394092)).to(torch.int32)
    k[0], k[-1] = 0, I
    return keys, k


@pytest.mark.parametrize("case", ["uniform", "ties", "signed"])
@pytest.mark.parametrize("R,I", [
    (2048, 17632), (6040, 3706), (128, 65536), (5, 131072), (7, 97),
    (1884, 17632),  # CFGAN's user mode: a row in shared memory
    (17632, 1884),  # item mode: short rows, 128-thread blocks
    (4099, 97), (33, 1883), (3, 2048),  # short rows, ragged (I % 4 != 0) and the widest
    (9, 2049), (5, 17633),  # the narrowest row of the 512-thread blocks, and a ragged one
    (3, 56320), (3, 56321),  # the widest row kept in shared memory, and one streamed
])
def test_k2_matches_plain(cuda, R, I, case):
    keys, k = (t.to(cuda) for t in _select_case(case, R, I))
    before = _counter("k2.launches")
    got = smallest_k_mask(keys, k)
    assert _counter("k2.launches") == before + 1
    want = smallest_k_mask_reference(keys, k)
    assert torch.equal(got, want)
    assert torch.equal(got.sum(1), k.long())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("I", [97, 17632, 65536])
def test_k2_takes_k_outside_its_range(cuda, I, dtype):
    """k < 0 selects nothing and k > I everything, as in the JAX function
    and the plain version, on each of the kernel's three paths."""
    keys, _ = _select_case("uniform", 6, I)
    k = torch.tensor([-1, I + 3, -(2 ** 31), 2 ** 31 - 1, 0, I], dtype=dtype)
    if dtype == torch.int64:
        k[2], k[3] = -(2 ** 40), 2 ** 40
    got = smallest_k_mask(keys.to(cuda), k.to(cuda))
    assert torch.equal(got.cpu(), smallest_k_mask_reference(keys, k))
    assert got[0].sum() == 0 and bool(got[1].all()) and bool(got[3].all())


@pytest.mark.parametrize("what", ["K1 fused", "K1 wide pair", "K2", "K1 fused aligned"])
def test_wrappers_do_not_synchronize(cuda, what):
    """Each wrapper only enqueues: under sync debug mode "error" any
    host-device synchronization in it would raise."""
    if what == "K2":
        keys, k = (t.to(cuda) for t in _select_case("uniform", 64, 17632))
        call = lambda: smallest_k_mask(keys, k)  # noqa: E731
    elif what == "K1 fused aligned":
        U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs("random", 3648, 26744, 128))
        call = lambda: masked_topk_scores(U, V, mask, 50)  # noqa: E731
    else:
        U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs("random", 5, 3706, 250))
        kk = 20 if what == "K1 fused" else 3705
        call = lambda: masked_topk_scores(U, V, mask, kk)  # noqa: E731
    call()  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_k2_rejects_what_it_does_not_take(cuda):
    keys = torch.rand(4, 10, device=cuda)
    k = torch.full((4,), 3, dtype=torch.int32, device=cuda)
    assert torch.equal(select.smallest_k_mask_cuda(keys, k + 8),  # k > I: every column
                       torch.ones(4, 10, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        select.smallest_k_mask_cuda(keys.T.contiguous().T, k)  # not contiguous
    with pytest.raises(ValueError):
        select.smallest_k_mask_cuda(keys, k.cpu())  # devices differ
    wide = torch.rand(1, select.MAX_COLS + 1, device=cuda)
    with pytest.raises(ValueError):
        select.smallest_k_mask_cuda(wide, k[:1])  # past the 16-bit counts


def test_cfgan_epoch_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(0)
    n_rows, n_cols, batch = 256, 700, 64
    urm = np.zeros((n_rows, n_cols), np.float32)
    urm[rng.rand(n_rows, n_cols) < 0.02] = 1.0
    w = np.ones(n_rows, np.float32)
    g_dims, d_dims = [n_cols, 128, n_cols], [2 * n_cols, 4, 4, 1]
    lr = 1e-3
    kw = dict(d_reg=1e-4, g_reg=1e-4, zr_ratio=0.45, zp_ratio=0.2, zr_coefficient=0.05, scheme="ZP",
              d_hidden_act="linear", g_hidden_act="tanh", d_n_batches=n_rows // batch, d_batch=batch,
              g_n_batches=n_rows // batch, g_batch=batch, d_steps=1, g_steps=1)
    uniforms = tuple(torch.from_numpy(rng.rand(n_rows, n_cols).astype(np.float32)) for _ in range(2))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        p = pcf.init_params(g_dims, d_dims, torch.Generator().manual_seed(1), dev)
        d_opt = torch.optim.Adam(p.D.parameters(), lr=lr, betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
        g_opt = torch.optim.Adam(p.G.parameters(), lr=lr, betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
        t_urm, t_w = torch.from_numpy(urm).to(dev), torch.from_numpy(w).to(dev)
        t_uni = tuple(u.to(dev) for u in uniforms)
        masks = pcf.sample_negative_masks(t_urm, 0.45, 0.2, "ZP", uniforms=t_uni)
        pcf.cfgan_epoch(p, d_opt, g_opt, t_urm, t_uni, t_w, t_w, **kw)
        runs.append(([m.cpu() for m in masks], [t.detach().cpu() for t in p.parameters()]))
    (card_masks, card_p), (cpu_masks, cpu_p) = runs
    for a, b in zip(card_masks, cpu_masks):
        assert torch.equal(a, b)
    steps = n_rows // batch
    for a, b in zip(card_p, cpu_p):
        diff = (a - b).abs()
        assert float(diff.max()) <= 2.2 * lr * steps
        assert float((diff <= 0.01 * lr).float().mean()) >= 0.99


def test_recommend_default_cutoff_on_card(cuda):
    """recommend(u) with the default cutoff (n_items - 1), and an evaluation
    at a cutoff above 64, work on a CUDA factor model: both launch K1's wide
    pair."""
    rng = np.random.RandomState(1)
    train = sps.csr_matrix((rng.rand(50, 300) < 0.05).astype(np.float32))
    card = GANMF(train, device=cuda)
    card.params = init_params(50, 300, 8, 16, torch.Generator().manual_seed(3), cuda)
    plain = GANMF(train, device=torch.device("cpu"))
    plain.params = init_params(50, 300, 8, 16, torch.Generator().manual_seed(3), torch.device("cpu"))
    before = _counter("k1.wide_launches")
    got = card.recommend(4)
    assert len(got) == 300 - train[4].nnz
    assert got == plain.recommend(4)
    got, _ = EvaluatorHoldout(train, [5, 100], device=cuda).evaluateRecommender(card)
    assert np.isfinite(got[100]["MAP"])
    assert _counter("k1.wide_launches") >= before + 2


def _ganmf_epoch_inputs(dev, mode, storage, seed=0):
    """(params, optimizers, TF1 state, urm, perm, weights) for one GANMF
    epoch on ``dev`` at a small width: 300 x 500, K=16, E=64, batches of 32."""
    rng = np.random.RandomState(seed)
    mat = sps.csr_matrix((rng.rand(300, 500) < 0.05).astype(np.float32))
    if mode == "item":
        mat = mat.T.tocsr()
    n_rows, n_cols = mat.shape
    n_batches, padded = make_batches(n_rows, 32)
    perm = shuffled_padded_perm(np.random.RandomState(seed), n_rows, padded)
    p = pgm.init_params(n_rows, n_cols, 16, 64, torch.Generator().manual_seed(seed), dev)
    d_opt = torch.optim.Adam(p.d_params(), lr=1e-3, betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
    item_opt = torch.optim.Adam([p.item_emb], lr=2e-3, betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
    urm = padded_csr_from_sparse(mat, dev) if storage == "csr" else torch.from_numpy(mat.toarray()).to(dev)
    return (p, d_opt, item_opt, pgm.user_adam_state(p.user_emb), urm,
            torch.from_numpy(perm).to(dev, torch.int64),
            torch.from_numpy(padded_weights(n_rows, padded)).to(dev), n_batches)


_GANMF_KW = dict(g_lr=2e-3, m=1.5, recon_coefficient=0.2, d_reg=1e-4, g_reg=1e-4, batch_size=32,
                 d_steps=1, g_steps=1)


@pytest.mark.parametrize("lazy", [False, True], ids=["dense_adam", "lazy_adam"])
@pytest.mark.parametrize("storage", ["dense", "csr"])
@pytest.mark.parametrize("mode", ["user", "item"])
def test_ganmf_epoch_on_card_matches_cpu(cuda, mode, storage, lazy):
    runs = []
    for dev in (cuda, torch.device("cpu")):
        p, d_opt, item_opt, state, urm, perm, w, n = _ganmf_epoch_inputs(dev, mode, storage)
        dl, gl = pgm.ganmf_epoch(p, d_opt, item_opt, state, urm, perm, w, n_batches=n,
                                 lazy_user_adam=lazy, **_GANMF_KW)
        assert dl.device == perm.device and dl.dim() == 0  # a device scalar
        runs.append(([t.detach().cpu() for t in p.parameters()], (float(dl), float(gl)), float(state["t"])))
    (card_p, card_l, card_t), (cpu_p, cpu_l, cpu_t) = runs
    assert card_t == cpu_t == n
    np.testing.assert_allclose(card_l, cpu_l, rtol=1e-4, atol=0)
    for i, (a, b) in enumerate(zip(card_p, cpu_p)):
        lr = 2e-3 if i < 2 else 1e-3
        diff = (a - b).abs()
        assert float(diff.max()) <= 2.2 * lr * n, i
        assert float((diff <= 0.01 * lr).float().mean()) >= 0.99, i


@pytest.mark.parametrize("lazy", [False, True], ids=["dense_adam", "lazy_adam"])
@pytest.mark.parametrize("storage", ["dense", "csr"])
def test_ganmf_epoch_does_not_synchronize(cuda, storage, lazy):
    """A GANMF epoch only enqueues: no host-device synchronization in its
    steps, its optimizers or its losses (sync debug mode "error")."""
    p, d_opt, item_opt, state, urm, perm, w, n = _ganmf_epoch_inputs(cuda, "user", storage)
    for compute_dtype in ("f32", "bf16"):
        run = lambda: pgm.ganmf_epoch(p, d_opt, item_opt, state, urm, perm, w, n_batches=n,  # noqa: E731
                                      lazy_user_adam=lazy, compute_dtype=compute_dtype, **_GANMF_KW)
        run()  # the optimizers make their state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(x)) for x in losses)


_GAN_WIDTHS = {"GANMF": dict(emb_dim=64), "DisGANMF": dict(d_nodes=64, d_hidden_act="relu")}


@pytest.mark.parametrize("name", sorted(_GAN_WIDTHS))
def test_ganmf_fit_on_card_launches_k1(cuda, name):
    """A 3-epoch fit of GANMF or DisGANMF with early stopping at every
    epoch, on the card by default, in both modes: the evaluations launch K1's
    fused kernel, recommend at the default cutoff its wide pair, and the
    trained model scores like its CPU copy (every metric within 1e-5)."""
    import copy

    import ganmf_tpu_torch.models as pm

    cls = getattr(pm, name)
    rng = np.random.RandomState(2)
    full = (rng.rand(300, 500) < 0.05).astype(np.float32)
    held = rng.rand(300, 500) < 0.2
    train, test = sps.csr_matrix(full * ~held), sps.csr_matrix(full * held)
    for mode in ("user", "item"):
        model = cls(train, mode=mode, seed=5, is_experiment=True)
        assert model.device == cuda
        ev = EvaluatorHoldout(test, [5, 10, 20, 50])
        before = _counter("k1.launches") - _counter("k1.wide_launches")
        returned = model.fit(num_factors=16, epochs=3, batch_size=32, d_lr=1e-3, g_lr=1e-3,
                             validation_evaluator=ev, freq=1, allow_worse=5, **_GAN_WIDTHS[name])
        assert returned == 4 and (name != "GANMF" or len(model.train_d_loss) == 3)  # DisGANMF keeps none
        assert _counter("k1.launches") - _counter("k1.wide_launches") >= before + 3
        wide = _counter("k1.wide_launches")
        assert len(model.recommend(0)) == train.shape[1] - train[0].nnz
        assert _counter("k1.wide_launches") == wide + 1
        plain = cls(train, mode=mode, device=torch.device("cpu"))
        plain.params = copy.deepcopy(model.params).cpu()
        got, _ = ev.evaluateRecommender(model)
        want, _ = EvaluatorHoldout(test, [5, 10, 20, 50], device=torch.device("cpu")).evaluateRecommender(plain)
        for c in want:
            for metric, value in want[c].items():
                assert got[c][metric] == pytest.approx(value, abs=1e-5), (mode, c, metric)


def test_run_best_on_card(cuda, tmp_path, monkeypatch):
    """run_best trains GANMF on the card by default and writes its results."""
    import pickle

    from ganmf_tpu_torch.cli.run_best import run
    from ganmf_tpu_torch.data.splits import make_experiment_splits, save_experiment_splits

    rng = np.random.RandomState(0)
    splits = make_experiment_splits(sps.csr_matrix((rng.rand(200, 300) < 0.1).astype(np.float32)))
    save_experiment_splits(splits, "synth", str(tmp_path / "splits"))
    monkeypatch.setenv("GANMF_TPU_SPLIT_DIR", str(tmp_path / "splits"))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "experiments" / "GANMF_item_synth").mkdir(parents=True)
    (tmp_path / "experiments" / "GANMF_item_synth" / "best_params.pkl").write_bytes(
        pickle.dumps(dict(num_factors=8, emb_dim=32, epochs=2, batch_size=32)))
    before = _counter("k1.launches")
    results = run("synth", "GANMF", train_mode="item")
    assert _counter("k1.launches") > before
    out = tmp_path / "test_results" / "GANMF_item_synth"
    assert sorted(p.name for p in out.iterdir()) == ["GANMF.zip", "test_results.pkl", "test_results.txt"]
    assert np.isfinite(results[5]["MAP"])


def _disganmf_epoch_inputs(dev, mode, seed=0):
    """(params, optimizers, TF1 state, urm, perm, weights, n_batches) for one
    DisGANMF epoch on ``dev``: 300 x 500, K=16, one relu layer of 64."""
    from ganmf_tpu_torch.models import disganmf as pdg

    rng = np.random.RandomState(seed)
    mat = sps.csr_matrix((rng.rand(300, 500) < 0.05).astype(np.float32))
    if mode == "item":
        mat = mat.T.tocsr()
    n_rows, n_cols = mat.shape
    n_batches, padded = make_batches(n_rows, 32)
    perm = shuffled_padded_perm(np.random.RandomState(seed), n_rows, padded)
    p = pdg.init_params(n_rows, n_cols, 16, 1, 64, torch.Generator().manual_seed(seed), dev)
    d_opt = torch.optim.Adam(p.d_params(), lr=1e-3, betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
    item_opt = torch.optim.Adam([p.item_emb], lr=2e-3, betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
    return (p, d_opt, item_opt, pgm.user_adam_state(p.user_emb), torch.from_numpy(mat.toarray()).to(dev),
            torch.from_numpy(perm).to(dev, torch.int64),
            torch.from_numpy(padded_weights(n_rows, padded)).to(dev), n_batches)


_DIS_KW = dict(g_lr=2e-3, recon_coefficient=0.25, d_reg=1e-4, g_reg=0.0, batch_size=32, d_steps=1, g_steps=1,
               d_hidden_act="relu")


@pytest.mark.parametrize("mode", ["user", "item"])
def test_disganmf_epoch_on_card_matches_cpu(cuda, mode):
    from ganmf_tpu_torch.models import disganmf as pdg

    runs = []
    for dev in (cuda, torch.device("cpu")):
        p, d_opt, item_opt, state, urm, perm, w, n = _disganmf_epoch_inputs(dev, mode)
        dl, gl = pdg.disganmf_epoch(p, d_opt, item_opt, state, urm, perm, w, n_batches=n,
                                    lazy_user_adam=mode == "user", **_DIS_KW)
        runs.append(([t.detach().cpu() for t in p.parameters()], (float(dl), float(gl))))
    (card_p, card_l), (cpu_p, cpu_l) = runs
    np.testing.assert_allclose(card_l, cpu_l, rtol=1e-4, atol=0)
    for i, (a, b) in enumerate(zip(card_p, cpu_p)):
        lr = 2e-3 if i < 2 else 1e-3
        diff = (a - b).abs()
        assert float(diff.max()) <= 2.2 * lr * n, i
        assert float((diff <= 0.01 * lr).float().mean()) >= 0.99, i


def test_disganmf_epoch_does_not_synchronize(cuda):
    from ganmf_tpu_torch.models import disganmf as pdg

    p, d_opt, item_opt, state, urm, perm, w, n = _disganmf_epoch_inputs(cuda, "user")
    for compute_dtype in ("f32", "bf16"):
        run = lambda: pdg.disganmf_epoch(p, d_opt, item_opt, state, urm.to(  # noqa: E731
            torch.bfloat16 if compute_dtype == "bf16" else torch.float32), perm, w, n_batches=n,
            lazy_user_adam=True, compute_dtype=compute_dtype, **_DIS_KW)
        run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(x)) for x in losses)


def test_puresvd_fit_on_card_matches_cpu(cuda):
    """A PureSVD fit with two cold users: scores within 2e-4 of their scale
    of the CPU fit's, cold users empty in recommend_fused and serve_all, and
    the evaluation through K1 within 1e-5 of a CPU copy of the card's
    factors."""
    from ganmf_tpu_torch.models import PureSVDRecommender

    rng = np.random.RandomState(3)
    full = (rng.rand(400, 600) < 0.05).astype(np.float32)
    full[[5, 77]] = 0.0  # cold users
    train = sps.csr_matrix(full)
    test = sps.csr_matrix(((rng.rand(400, 600) < 0.01) & (full == 0)).astype(np.float32))
    card, plain = PureSVDRecommender(train), PureSVDRecommender(train, device=torch.device("cpu"))
    assert card.device == cuda
    card.fit(num_factors=20)
    plain.fit(num_factors=20)
    users = np.setdiff1d(np.arange(400), [5, 77])
    got = card.score_device(torch.from_numpy(users).to(cuda)).cpu()
    want = plain.score_device(torch.from_numpy(users))
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())
    before = _counter("k1.launches")
    lists = card.recommend_fused(np.arange(10), cutoff=20)
    assert _counter("k1.launches") == before + 1 and lists[5] == [] and all(len(lists[u]) == 20 for u in (0, 1, 9))
    idx, vals = card.serve_all(cutoff=20)
    assert np.isneginf(vals[[5, 77]]).all() and np.isfinite(vals[users]).all()
    copy = PureSVDRecommender(train, device=torch.device("cpu"))
    copy.USER_factors, copy.ITEM_factors = card.USER_factors, card.ITEM_factors
    before = _counter("k1.launches")
    _metrics_close(card, copy, test)
    assert _counter("k1.launches") == before + 1


def _caae_epoch_args(dev, seed=0):
    """(params, urm, interactions, draws, keywords) for one CAAE epoch on
    ``dev``: 300 x 500, K=8, G and G' with one layer of 32, chunks of 512."""
    from ganmf_tpu_torch.models import caae as pca

    rng = np.random.RandomState(seed)
    urm = (rng.rand(300, 500) < 0.05).astype(np.float32)
    rows, cols = np.nonzero(urm)
    B = 512
    n_chunks = -(-len(rows) // B)
    pad = n_chunks * B - len(rows)
    inter = [torch.from_numpy(np.concatenate([a, np.zeros(pad, a.dtype)]).astype(np.int64)).to(dev)
             for a in (rows, cols)]
    weight = torch.from_numpy(np.concatenate([np.ones(len(rows)), np.zeros(pad)]).astype(np.float32)).to(dev)
    draws = pca.draw_epoch(torch.Generator().manual_seed(seed), torch.device("cpu"), n_chunks * B, 300, 500,
                           2 * n_chunks * B, 1, 1, 16, 20)
    params = pca.init_params(300, 500, 8, [500, 32, 500], torch.Generator().manual_seed(seed), dev)
    kw = dict(lr=1e-2, beta=0.01, lmbda=0.5, S=0.3, d_bsize=B, n_d_chunks=n_chunks, d_steps=2, g_steps=1,
              gpr_steps=1, m_batch=16, n_samples=20)
    return (params, torch.from_numpy(urm).to(dev), *inter, weight,
            pca.CAAEDraws(*(t.to(dev) for t in draws)), kw)


def test_caae_epoch_on_card_matches_cpu(cuda):
    from ganmf_tpu_torch.models import caae as pca

    runs = []
    for dev in (cuda, torch.device("cpu")):
        params, urm, users, items, w, draws, kw = _caae_epoch_args(dev)
        before = _counter("k2.launches")
        losses = pca.caae_epoch(params, urm, users, items, w, draws, **kw)
        assert _counter("k2.launches") == before + (dev.type == "cuda")  # K2 drew Nu on the card
        runs.append([t.detach().cpu() for t in params.parameters()])
        assert all(np.isfinite(float(x)) for x in losses)
    init = _caae_epoch_args(torch.device("cpu"))[0]
    for i, (a, b, t0) in enumerate(zip(*runs, init.parameters())):
        moved = float((b - t0.detach()).abs().max())
        assert moved > 0 and float((a - b).abs().max()) <= 1e-2 * moved, i


def test_caae_epoch_does_not_synchronize(cuda):
    from ganmf_tpu_torch.models import caae as pca

    params, urm, users, items, w, draws, kw = _caae_epoch_args(cuda)
    pca.caae_epoch(params, urm, users, items, w, draws, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = pca.caae_epoch(params, urm, users, items, w, draws, **kw)
        draws = pca.draw_epoch(torch.Generator(device=cuda).manual_seed(1), cuda, len(w), 300, 500,
                               len(draws.d_uniforms[0, 0]), 1, 1, 16, 20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x)) for x in losses)
    assert torch.equal(torch.sort(draws.perm).values, torch.arange(len(w), device=cuda))


_CFGAN_FIT = dict(g_nodes=64, d_nodes=8, d_layers=2, g_hidden_act="tanh", scheme="ZR", zr_ratio=0.45,
                  zr_coefficient=0.05, d_batch_size=64, g_batch_size=128, d_lr=1e-4, g_lr=1e-3)
_CAAE_FIT = dict(g_units=32, num_factors=8, d_bsize=512, d_steps=2, lr=1e-3, beta=0.1)
_DENSE_ROUTE_FITS = {"cfgan_dense": ("CFGAN", _CFGAN_FIT), "cfgan_csr": ("CFGAN", dict(_CFGAN_FIT, urm_storage="csr")),
                     "caae": ("CAAE", _CAAE_FIT)}


@pytest.mark.parametrize("name", sorted(_DENSE_ROUTE_FITS))
def test_dense_route_fit_on_card_matches_its_cpu_copy(cuda, name):
    """CFGAN (dense and csr storage) and CAAE, 2 epochs with an evaluation
    every epoch, on the card by default: K2 draws masks in every epoch and K1
    never runs (the dense route ranks them); the scores within rtol 1e-5 /
    atol 1e-6 of a CPU copy's from the same parameters; and, ranking the
    card's scores, the CPU copy's evaluation within 1e-6 and its serve_all
    and recommend ids equal to the card's."""
    import copy

    import ganmf_tpu_torch.models as pm

    cls_name, params = _DENSE_ROUTE_FITS[name]
    cls = getattr(pm, cls_name)
    train, test = _sim_split(binary=True)
    model = cls(train, seed=5, is_experiment=True)
    assert model.device == cuda
    ev = EvaluatorHoldout(test, [5, 10, 20, 50])
    k1, k2 = _counter("k1.launches"), _counter("k2.launches")
    model.fit(epochs=2, validation_evaluator=ev, freq=1, allow_worse=5, **params)
    assert _counter("k2.launches") - k2 >= 2 and _counter("k1.launches") == k1
    assert all(bool(torch.isfinite(t).all()) for t in model.params.parameters())
    plain = cls(train, seed=5, is_experiment=True, device=torch.device("cpu"))
    plain.fit(epochs=0, **params)
    plain.params = copy.deepcopy(model.params).cpu()
    users = torch.arange(train.shape[0])
    got = model.score_device(users.to(cuda)).cpu()
    torch.testing.assert_close(got, plain.score_device(users), rtol=1e-5, atol=1e-6)
    plain.score_device = lambda uids: got.index_select(0, uids.cpu())  # the card's scores from here on
    results, _ = ev.evaluateRecommender(model)
    want, _ = EvaluatorHoldout(test, [5, 10, 20, 50], device=torch.device("cpu")).evaluateRecommender(plain)
    for c in want:
        for metric, value in want[c].items():
            assert results[c][metric] == pytest.approx(value, abs=1e-6, nan_ok=True), (c, metric)
    np.testing.assert_array_equal(model.serve_all(cutoff=20)[0], plain.serve_all(cutoff=20)[0])
    assert model.recommend(np.arange(5)) == plain.recommend(np.arange(5))  # the default cutoff
    assert _counter("k1.launches") == k1


def _ials_urm(seed=4):
    rng = np.random.RandomState(seed)
    full = (rng.rand(600, 900) < 0.03).astype(np.float32)
    full[[3, 44]] = 0.0  # cold users
    return sps.csr_matrix(full)


def _row_gap(got, want):
    return float((np.linalg.norm(got - want, axis=1) / np.maximum(np.linalg.norm(want, axis=1), 1e-30)).max())


@pytest.mark.parametrize("storage", ["dense", "padded", "flat"])
def test_ials_epoch_on_card_matches_cpu(cuda, storage, monkeypatch):
    """One IALS epoch (K=32, alpha=5) from the same initial factors on the
    card and on the CPU: every factor row within 1e-4 of its norm (CG stops
    at a residual of 1e-5 of ||b||, so two summation orders leave the
    solutions up to about cond(A) x 1e-5 apart); the card's three storages
    within rtol 2e-4 / atol 2e-6 of its dense form."""
    from ganmf_tpu_torch.models import IALSRecommender
    from ganmf_tpu_torch.models import ials

    urm = _ials_urm()
    cfg = dict(epochs=1, num_factors=32, alpha=5.0, reg=1e-3)
    card, plain = IALSRecommender(urm), IALSRecommender(urm, device=torch.device("cpu"))
    assert card.device == cuda
    plain.fit(**cfg)
    dense = IALSRecommender(urm)
    dense.fit(**cfg)
    if storage == "flat":
        monkeypatch.setattr(ials, "_PAD_PLANE_BYTE_LIMIT", 1)
    card.fit(**cfg, urm_storage="dense" if storage == "dense" else "csr")
    assert card._store_users[0] == storage
    for got, ref, want in zip((card._U_dev, card._V_dev), (dense._U_dev, dense._V_dev), (plain._U_dev, plain._V_dev)):
        assert got.device == cuda
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=2e-4, atol=2e-6)
        assert _row_gap(got.cpu().numpy(), want.numpy()) <= 1e-4
    assert card.USER_factors[3].tolist() == plain.USER_factors[3].tolist()  # cold rows untouched


def test_ials_fits_without_tf32(cuda, monkeypatch):
    """TF32 stays off in every product of an IALS fit on the card, and its
    early-stopping validations launch K1."""
    from ganmf_tpu_torch.models import IALSRecommender

    urm = _ials_urm()
    model = IALSRecommender(urm)
    seen = []
    orig = model._run_epoch

    def epoch(n):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()))
        orig(n)

    model._run_epoch = epoch
    before = _counter("k1.launches")
    model.fit(epochs=4, num_factors=16, alpha=5.0, validation_every_n=2, validation_metric="MAP",
              evaluator_object=EvaluatorHoldout(urm, [5]))
    assert seen == [(False, "highest")] * 4
    assert _counter("k1.launches") >= before + 2
    assert model.epochs_best in (2, 4) and isinstance(model._USER_factors_store, torch.Tensor)


def test_toppop_on_card_matches_cpu(cuda):
    from ganmf_tpu_torch.models import TopPop

    urm = _ials_urm()
    card, plain = TopPop(urm), TopPop(urm, device=torch.device("cpu"))
    card.fit()
    plain.fit()
    users = np.arange(50)
    assert card.recommend(users, cutoff=20) == plain.recommend(users, cutoff=20)
    assert card.recommend(users[:5]) == plain.recommend(users[:5])
    idx, vals = card.serve_all(cutoff=20)
    pidx, pvals = plain.serve_all(cutoff=20)
    np.testing.assert_array_equal(idx, pidx)
    np.testing.assert_array_equal(vals, pvals)


def test_tuner_trial_on_card(cuda, tmp_path, monkeypatch):
    """One ALS trial of RecSysExp on the card by default: the artifacts are
    written, and the early-stopping and validation evaluations launch K1."""
    import pickle

    from ganmf_tpu_torch.cli import experiment
    from ganmf_tpu_torch.cli.spaces import DICT_DIMENSIONS
    from ganmf_tpu_torch.data.splits import make_experiment_splits, save_experiment_splits
    from ganmf_tpu_torch.tune import Categorical

    rng = np.random.RandomState(0)
    splits = make_experiment_splits(sps.csr_matrix((rng.rand(200, 300) < 0.1).astype(np.float32)))
    save_experiment_splits(splits, "synth", str(tmp_path / "splits"))
    monkeypatch.setenv("GANMF_TPU_SPLIT_DIR", str(tmp_path / "splits"))
    monkeypatch.chdir(tmp_path)
    dims = list(DICT_DIMENSIONS["ALS"]) + [Categorical([10], name="epochs")]
    exp = experiment.RecSysExp(experiment.IALSRecommender, "synth", fit_param_names=[d.name for d in dims])
    assert exp.device == cuda
    before = _counter("k1.launches")
    exp.tune(dims, evals=1)
    assert _counter("k1.launches") >= before + 3  # two early-stopping validations and the trial's
    out = tmp_path / "experiments" / "IALSRecommender__synth"
    assert sorted(p.name for p in out.iterdir()) == ["best_params.pkl", "best_params.txt", "checkpoint.pkl",
                                                    "results.txt"]
    assert pickle.loads((out / "best_params.pkl").read_bytes())["epochs"] in (0, 5, 10)


def test_studies_on_card(cuda, tmp_path, monkeypatch, capsys):
    """The paper's studies on the card by default, on a 200 x 120 five-way
    split (more items than the profile-length study's 50 factors) with
    GANMF's epochs cut to 1: describe's five splits, the
    feature-matching sweep (11 results) and its cosine study, the
    latent-factor and profile-length studies, with K1 ranking their
    evaluations; a PureSVD model's profile-length bins average to the
    evaluator's MAP@20 on the card (1e-6)."""
    import json

    from ganmf_tpu_torch.cli import ablation, describe, mf_learned
    from ganmf_tpu_torch.cli.experiment import load_urms
    from ganmf_tpu_torch.data.splits import make_experiment_splits, save_experiment_splits
    from ganmf_tpu_torch.models import PureSVDRecommender

    rng = np.random.RandomState(0)
    full = sps.csr_matrix((rng.rand(200, 120) < 0.1).astype(np.float32))
    save_experiment_splits(make_experiment_splits(full, seed=1337), "synth", str(tmp_path / "splits"))
    monkeypatch.setenv("GANMF_TPU_SPLIT_DIR", str(tmp_path / "splits"))
    monkeypatch.chdir(tmp_path)
    describe.main(["synth"])
    assert capsys.readouterr().out.count('"name"') == 5
    base = dict(num_factors=4, emb_dim=8, batch_size=16, m=2, d_lr=1e-3, g_lr=1e-3, d_reg=1e-4, recon_coefficient=0.3)
    before = _counter("k1.launches")
    alphas, maps, ndcgs = ablation.feature_matching_coefficient("synth", base_params=base, out_dir="fm", epochs=1)
    assert len(maps) == len(ndcgs) == 11 and all(np.isfinite(maps + ndcgs))
    stats = ablation.feature_matching_cos_sim("synth", base_params=base, out_dir="fm", epochs=1, sample_users=20)
    assert all(-1 <= s["mean_cos_sim"] <= 1 for s in stats.values())
    series = mf_learned.latent_factors_study("synth", out_dir="latent", epochs=1, k_grid=[2, 3])
    assert sorted(series) == ["ALS", "GANMF", "PureSVD"] and all(np.isfinite(v).all() for v in series.values())
    qual = mf_learned.mf_qualitative_study("synth", out_dir="qual", epochs=1)
    assert sorted(qual) == ["ALS", "GANMF", "PureSVD"] and all(len(b) == 10 for b in qual.values())
    with open(tmp_path / "qual" / "profile_length_map_synth.json") as fh:
        assert sorted(json.load(fh)) == ["ALS", "GANMF", "PureSVD"]
    assert _counter("k1.launches") >= before + 11 + 6  # the sweep's and the latent study's evaluations
    splits = load_urms("synth")
    svd = PureSVDRecommender(splits.train)
    svd.fit(num_factors=6)
    bins = mf_learned.per_profile_length_map(svd, splits)
    n = sum(b["n_users"] for b in bins)
    want, _ = EvaluatorHoldout(splits.test, [20]).evaluateRecommender(svd)
    assert sum(b["MAP"] * b["n_users"] for b in bins) / n == pytest.approx(want[20]["MAP"], abs=1e-6)


# -- the similarity family (no kernel: float32 products, tiled_topk) -----------


def _sim_split(seed=6, n_users=300, n_items=700, binary=False):
    """A train/test split; its training values are 1 + U(0, 1) unless
    ``binary``. On 0/1 data many scores are exactly equal sums of equal
    similarities, which the card's and the CPU's summation orders rank
    either way, so the metric comparisons take real values (all >= 1: every
    entry is a positive of SLIM-BPR's threshold)."""
    rng = np.random.RandomState(seed)
    full = (rng.rand(n_users, n_items) < 0.03).astype(np.float32)
    held = rng.rand(n_users, n_items) < 0.2
    train = full * ~held
    if not binary:
        train = train * (1.0 + rng.rand(n_users, n_items)).astype(np.float32)
    return sps.csr_matrix(train), sps.csr_matrix(full * held)


def _assert_topk_close(got, want, rtol, atol=1e-12):
    """Per-column top-K matrices: common entries within rtol, the same count a
    column, and an entry kept by one only within rtol of the other's smallest
    kept value in the column (a near tie)."""
    got, want = sps.csc_matrix(got), sps.csc_matrix(want)
    np.testing.assert_array_equal(np.diff(got.indptr), np.diff(want.indptr))
    g, w = got.toarray(), want.toarray()
    both = (g != 0) & (w != 0)
    np.testing.assert_allclose(g[both], w[both], rtol=rtol, atol=atol)
    for a, b in ((g, w), (w, g)):
        for r, c in zip(*np.nonzero((a != 0) & (b == 0))):
            edge = b[:, c][b[:, c] != 0].min()
            assert abs(a[r, c] - edge) <= rtol * abs(edge) + atol


def _metrics_close(model, plain, test, tol=1e-5):
    got, _ = EvaluatorHoldout(test, [5, 10, 20, 50]).evaluateRecommender(model)
    want, _ = EvaluatorHoldout(test, [5, 10, 20, 50], device=torch.device("cpu")).evaluateRecommender(plain)
    for c in want:
        for m, v in want[c].items():
            assert got[c][m] == pytest.approx(v, abs=tol, nan_ok=True), (c, m)


def test_tiled_topk_on_card_is_the_cpus(cuda):
    from ganmf_tpu_torch.ops.topk import tiled_topk

    rng = np.random.RandomState(0)
    w = np.floor(rng.rand(64, 5000) * 4).astype(np.float32)
    w[3] = -np.inf
    w[5, :2500] = -np.inf
    for k in (50, 761, 3000):
        got = tiled_topk(torch.from_numpy(w).to(cuda), k)
        want = tiled_topk(torch.from_numpy(w), k)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_similarity_gram_on_card_is_bitwise(cuda, monkeypatch):
    from ganmf_tpu_torch.ops import similarity as psim

    train, _ = _sim_split(binary=True)
    ones_c, ones = torch.ones(train.shape[0], device=cuda), torch.ones(train.shape[0])
    G, ss2, route = psim.build_gram(train, ones_c, False, cuda)
    Gp, ss2p, _ = psim.build_gram(train, ones, False, torch.device("cpu"))
    assert route == "dense" and torch.equal(G.cpu(), Gp) and torch.equal(ss2.cpu(), ss2p)
    monkeypatch.setattr(psim, "_DENSE_A_BYTE_LIMIT", 1)
    monkeypatch.setattr(psim, "_STREAM_CHUNK", 64)
    Gs, _, route = psim.build_gram(train, ones_c, False, cuda)
    assert route == "streamed" and torch.equal(Gs, G)


@pytest.mark.parametrize("similarity", ["cosine", "asymmetric", "euclidean", "jaccard"])
def test_itemknn_w_on_card_binary(cuda, similarity):
    """On 0/1 data W built on the card within rtol 1e-6 of the CPU's."""
    from ganmf_tpu_torch.models import ItemKNNCFRecommender

    train, _ = _sim_split(binary=True)
    card, plain = ItemKNNCFRecommender(train), ItemKNNCFRecommender(train, device=torch.device("cpu"))
    card.fit(topK=50, shrink=10, similarity=similarity)
    plain.fit(topK=50, shrink=10, similarity=similarity)
    _assert_topk_close(card.W_sparse, plain.W_sparse, 1e-6)


@pytest.mark.parametrize("cls,params", [
    ("ItemKNNCFRecommender", dict(topK=50, shrink=100)),
    ("ItemKNNCFRecommender", dict(topK=50, shrink=10, similarity="asymmetric", asymmetric_alpha=0.3)),
    ("ItemKNNCFRecommender", dict(topK=50, shrink=10, similarity="euclidean")),
    ("ItemKNNCFRecommender", dict(topK=30, shrink=10, feature_weighting="BM25")),
    ("UserKNNCFRecommender", dict(topK=40, shrink=10)),
    ("P3alphaRecommender", dict(topK=80, alpha=0.642)),
    ("RP3betaRecommender", dict(topK=80, alpha=0.8, beta=0.4)),
])
def test_similarity_models_on_card_match_cpu(cuda, cls, params):
    """W built on the card within rtol 1e-5 of the CPU build (real-valued
    data), and the metrics of the card's model within 1e-5 of the CPU
    copy's, by the similarity route; K1 is never launched."""
    import ganmf_tpu_torch.models as pm

    rtol = 1e-5
    train, test = _sim_split()
    card, plain = getattr(pm, cls)(train), getattr(pm, cls)(train, device=torch.device("cpu"))
    card.fit(**params)
    plain.fit(**params)
    assert isinstance(card._device_w, torch.Tensor) and card._device_w.device == cuda
    _assert_topk_close(card.W_sparse, plain.W_sparse, rtol)
    before = _counter("k1.launches")
    _metrics_close(card, plain, test)
    users = np.arange(20)
    assert card.recommend(users, cutoff=10) == plain.recommend(users, cutoff=10)
    assert _counter("k1.launches") == before


def test_sparse_w_route_on_card(cuda, monkeypatch):
    from ganmf_tpu_torch.models import ItemKNNCFRecommender, UserKNNCFRecommender

    train, _ = _sim_split()
    users = torch.arange(train.shape[0], device=cuda)
    for cls in (ItemKNNCFRecommender, UserKNNCFRecommender):
        dense = cls(train)
        dense.fit(topK=30, shrink=5)
        want = dense.score_device(users)
        model = cls(train)
        monkeypatch.setattr(cls, "_DENSE_W_BYTE_LIMIT", 1)
        model.fit(topK=30, shrink=5)
        got = model.score_device(users)
        monkeypatch.undo()
        assert got.device == cuda and model._device_w is False
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_slim_bpr_on_card_matches_cpu(cuda):
    """One SLIM-BPR epoch from the same state and triples: every entry of W
    within 2.2 x lr of the CPU's (index_add_ sums duplicate rows by atomics);
    then a fit on the card scores within 1e-5 of its W on the CPU."""
    from ganmf_tpu_torch.models import SLIM_BPR
    from ganmf_tpu_torch.models import slim_bpr as ps

    train, test = _sim_split()
    mask = train.copy()
    mask.data[:] = 1.0  # the positives (every entry passes the threshold of 1)
    tables, cpu_tables = ps.build_tables(mask, cuda), ps.build_tables(mask, torch.device("cpu"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    n_chunks, chunk = -(-train.shape[0] // 64), 64
    triples = [t.view(n_chunks, chunk) for t in ps.draw_triples(tables, n_chunks * chunk, gen)]
    hyper = dict(learning_rate=0.0539, li_reg=2.93e-4, lj_reg=9.39e-9, gamma=0.995, beta_1=0.9, beta_2=0.999,
                 sgd_mode="adagrad", symmetric=True)
    state = ps.init_state(train.shape[1], 0.9, 0.999, cuda)
    got = ps.bpr_epoch(state, tables.urm, triples, **hyper)
    want = ps.bpr_epoch(ps.OptState(*(t.cpu() for t in state)), cpu_tables.urm, [t.cpu() for t in triples],
                        **hyper)
    assert float((got.W.cpu() - want.W).abs().max()) <= 2.2 * 0.0539
    assert float(got.W.abs().max()) > 0

    model = SLIM_BPR(train)
    model.fit(epochs=3, topK=100, learning_rate=0.0539, lambda_i=2.93e-4)
    copy = SLIM_BPR(train, device=torch.device("cpu"))
    copy.W_sparse = model.W_sparse
    _metrics_close(model, copy, test)


def test_itemknn_cold_estimate_on_card(cuda):
    from ganmf_tpu_torch.models import PureSVDRecommender

    train, test = _sim_split()
    card, plain = PureSVDRecommender(train), PureSVDRecommender(train, device=torch.device("cpu"))
    card.fit(num_factors=12)
    # the card's factors on a grid of 64ths: every score and every entry of
    # the estimated W is exact in float32 whatever the summation order, so
    # the card and the CPU rank alike, exact ties to the lowest id
    U, V = (np.round(f * 64) / 64 for f in (card.USER_factors, card.ITEM_factors))
    for m in (card, plain):
        m.USER_factors, m.ITEM_factors = U.astype(np.float32), V.astype(np.float32)
        m.set_URM_train(train, estimate_model_for_cold_users="itemKNN", topK=50)
    assert (card._ItemKNNRecommender.W_sparse != plain._ItemKNNRecommender.W_sparse).nnz == 0
    before = _counter("k1.launches")
    _metrics_close(card, plain, test)
    assert _counter("k1.launches") == before  # the dense route ranks it


# -- the MF-SGD family, IRGAN, NMF and EASE-R ----------------------------------


def _gap_within(got, want, atol):
    for field, a, b in zip(want._fields, got, want):
        assert float((a.cpu() - b).abs().max()) <= atol, field


@pytest.mark.parametrize("cls_name", ["MatrixFactorization_BPR", "MatrixFactorization_AsySVD"])
@pytest.mark.parametrize("storage", ["dense", "csr"])
def test_mf_sgd_epoch_on_card_matches_cpu_and_does_not_synchronize(cuda, cls_name, storage):
    """One epoch from the same state and draws within 1e-5 of the CPU's
    (index_add_ sums duplicate rows by atomics; a flipped update moves an
    entry by about 2 x lr = 0.1); the draws and an epoch with no host sync."""
    import ganmf_tpu_torch.models as pmodels
    from ganmf_tpu_torch.models import mf_sgd as pm

    train, _ = _sim_split()
    model = getattr(pmodels, cls_name)(train)
    model.fit(epochs=1, num_factors=16, batch_size=64, learning_rate=0.05, urm_storage=storage)
    draws = pm.draw_samples(model._tables, (model._n_chunks, model._chunk), cls_name.endswith("BPR"),
                            torch.Generator(device=cuda).manual_seed(2))
    got = pm.mf_epoch(model._state, zip(*draws), **model._hyper)
    want = pm.mf_epoch(type(model._state)(*(t.cpu() for t in model._state)), zip(*(d.cpu() for d in draws)),
                       **model._hyper)
    _gap_within(got, want, 1e-5)
    assert float((want.U - model._state.U.cpu()).abs().max()) > 1e-3  # the epoch moved the factors
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model._run_epoch(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(model._state.U).all())


@pytest.mark.parametrize("cls_name,params", [
    ("MatrixFactorization_BPR", dict(epochs=2, num_factors=8, learning_rate=0.05)),
    ("MatrixFactorization_FunkSVD", dict(epochs=2, num_factors=8, learning_rate=0.05)),
    ("MatrixFactorization_AsySVD", dict(epochs=2, num_factors=8, learning_rate=0.05)),
    ("IRGAN_Recommender", dict(epochs=2, pre_train_epochs=1, num_factors=8, batch_size=64)),
    ("NMFRecommender", dict(num_factors=8, n_iter=20)),
])
def test_bpr_evaluation_on_card_launches_k1(cuda, cls_name, params):
    """The MF-SGD family, IRGAN and NMF fit on the card: each early-stopping
    validation ranks through K1, and the trained factors score like a CPU
    copy's (every metric within 1e-5) through one more K1 launch."""
    import ganmf_tpu_torch.models as pm

    cls = getattr(pm, cls_name)
    train, test = _sim_split()
    model = cls(train)
    validations = params.get("epochs", 0)
    if validations:
        params = dict(params, evaluator_object=EvaluatorHoldout(test, [5]), validation_every_n=1,
                      validation_metric="MAP")
    before = _counter("k1.launches")
    model.fit(**params)
    assert _counter("k1.launches") >= before + validations  # each validation through K1
    before = _counter("k1.launches")
    copy = cls(train, device=torch.device("cpu"))
    for attr in ("USER_factors", "ITEM_factors", "use_bias", "USER_bias", "ITEM_bias", "GLOBAL_bias"):
        setattr(copy, attr, getattr(model, attr))
    _metrics_close(model, copy, test)
    assert _counter("k1.launches") == before + 1


@pytest.mark.parametrize("kind", ["pretraining", "adversarial"])
def test_irgan_first_chunks_on_card_match_cpu(cuda, kind):
    """The first 4 chunks from the same Gumbel noise, at learning rates of
    0.05: every table within 1% of the distance it moved of the CPU's, or 8
    ulps of its largest entry where it did not move, and every table that
    moved moved at least 10 times its gate (a Gumbel argmax at a near tie
    would move a row by a whole update)."""
    from ganmf_tpu_torch.models import IRGAN_Recommender
    from ganmf_tpu_torch.models import irgan as pi

    train, _ = _sim_split(binary=True)
    start = IRGAN_Recommender(train)
    start.fit(epochs=0, pre_train_epochs=0, num_factors=10, batch_size=64, DNS_lr=0.05, D_lr=0.05, G_lr=0.05)
    C, I, n, hp = start._chunk, train.shape[1], 4, start._hp
    gen = torch.Generator(device=cuda).manual_seed(3)
    if kind == "pretraining":
        noise = [[pi.gumbel((hp["DNS_K"], C, I), gen) for _ in range(n)]]

        def run(st, dv, nz):
            return pi.dns_pretrain_epoch(st, *dv, nz[0], lr=hp["DNS_lr"], reg=hp["gen_reg"],
                                         temperature=hp["temperature"], n_items=I, chunk=C)
    else:
        noise = [[pi.gumbel((C, I), gen) for _ in range(n)], [pi.gumbel((hp["g_samples"], C, I), gen) for _ in range(n)]]

        def run(st, dv, nz):
            return pi.adversarial_epoch(st, *dv, [nz[0]], [nz[1]], d_lr=hp["D_lr"], g_lr=hp["G_lr"],
                                        d_reg=hp["disc_reg"], g_reg=hp["gen_reg"], temperature=hp["temperature"],
                                        n_items=I, chunk=C)
    dv = (start._u_arr[: n * C], start._i_arr[: n * C], start._pad)
    got = run(start._state, dv, noise)
    want = run(type(start._state)(*(t.cpu() for t in start._state)), tuple(t.cpu() for t in dv),
               [[g.cpu() for g in s] for s in noise])
    moved_any = False
    for a, b, s in zip(got, want, start._state):
        moved = float((b - s.cpu()).abs().max())
        moved_any |= moved > 0
        gate = max(1e-2 * moved, 8 * float(np.spacing(np.float32(b.abs().max()))))
        assert float((a.cpu() - b).abs().max()) <= gate
        assert moved == 0 or moved >= 10 * gate  # a table it trains moves far past its gate
    assert moved_any


def test_nmf_and_ease_r_on_card_match_cpu(cuda):
    """5 NMF iterations from one init within 1e-4 of the largest factor; the
    EASE-R W, dense and pruned (topK 50), within 1e-4 of max|B|."""
    from ganmf_tpu_torch.models import EASE_R_Recommender
    from ganmf_tpu_torch.models import extras as px

    train, _ = _sim_split(binary=True)
    A = torch.from_numpy(train.toarray()).to(cuda)
    W0, H0 = px.nmf_init(A, 20, torch.Generator(device=cuda).manual_seed(1))
    W, H = px.nmf_multiplicative(A, W0, H0, 5)
    Wp, Hp = px.nmf_multiplicative(A.cpu(), W0.cpu(), H0.cpu(), 5)
    for a, b in ((W, Wp), (H, Hp)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for topK in (None, 50):
        card, plain = EASE_R_Recommender(train), EASE_R_Recommender(train, device=torch.device("cpu"))
        card.fit(topK=topK, l2_norm=100.0)
        plain.fit(topK=topK, l2_norm=100.0)
        g, w = card._device_w.cpu().numpy(), plain._device_w.numpy()
        tol = 1e-4 * np.abs(w).max()
        both = (g != 0) & (w != 0)
        assert np.abs(g[both] - w[both]).max() <= tol
        assert np.array_equal((g != 0).sum(0), (w != 0).sum(0))


@pytest.mark.parametrize("B,I,dtype", [(128, 17632, torch.int64), (1024, 1884, torch.int64), (7, 1001, torch.int32),
                                       (3, 2, torch.int64)])
def test_keyed_uniforms_on_card_are_the_plain_version(cuda, B, I, dtype):
    from ganmf_tpu_torch.ops import keyed

    rows = torch.from_numpy(np.random.RandomState(B).permutation(5 * B)[:B]).to(dtype).to(cuda)
    before = _counter("keyed.launches")
    got = keyed.keyed_uniforms((3 << 32) | 1234, 7, 1, rows, I)
    assert _counter("keyed.launches") == before + 1
    want = keyed.keyed_uniforms_reference((3 << 32) | 1234, 7, 1, rows, I)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), keyed.keyed_uniforms((3 << 32) | 1234, 7, 1, rows.cpu(), I))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keyed.keyed_uniforms(5, 1, 0, rows, I)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("mode", ["user", "item"])
def test_cfgan_csr_epoch_on_card_matches_cpu(cuda, mode):
    """One csr epoch, card against CPU from the same init: the keyed masks of
    every minibatch bitwise (the kernel's draw, K2's selection), parameters
    within the Adam bound; K2 and the keyed kernel launched once a minibatch
    for each mask drawn."""
    from ganmf_tpu_torch.ops import keyed

    rng = np.random.RandomState(0)
    train = sps.csr_matrix((rng.rand(300, 700) < 0.02).astype(np.float32))
    mat = train.T.tocsr() if mode == "item" else train
    n_rows, n_cols = mat.shape
    d_batch, g_batch, lr = 64, 128, 1e-3
    d_n, d_pad = make_batches(n_rows, d_batch)
    g_n, g_pad = make_batches(n_rows, g_batch)
    w = padded_weights(n_rows, max(d_pad, g_pad))
    kw = dict(d_reg=1e-4, g_reg=1e-4, zr_ratio=0.45, zp_ratio=0.2, zr_coefficient=0.05, scheme="ZP",
              d_hidden_act="linear", g_hidden_act="tanh", d_n_batches=d_n, d_batch=d_batch,
              g_n_batches=g_n, g_batch=g_batch, d_steps=1, g_steps=1)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        def row_uniforms(stream, rows):
            return keyed.keyed_uniforms(11, 1, stream, rows, n_cols)

        pc = padded_csr_from_sparse(mat, dev)
        masks = pcf.csr_batch_inputs(pc, n_rows, n_cols, g_batch * (g_n - 1), g_batch, row_uniforms,
                                     zr_ratio=0.45, zp_ratio=0.2, scheme="ZP", with_zr=True)
        p = pcf.init_params([n_cols, 128, n_cols], [2 * n_cols, 4, 4, 1], torch.Generator().manual_seed(1), dev)
        d_opt = torch.optim.Adam(p.D.parameters(), lr=lr, betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
        g_opt = torch.optim.Adam(p.G.parameters(), lr=lr, betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
        t_w = torch.from_numpy(w).to(dev)
        k2, drawn = _counter("k2.launches"), _counter("keyed.launches")
        pcf.cfgan_epoch(p, d_opt, g_opt, pc, row_uniforms, t_w, t_w, **kw)
        if dev.type == "cuda":
            assert _counter("k2.launches") - k2 == _counter("keyed.launches") - drawn == d_n + 2 * g_n
        runs.append(([m.cpu() for m in masks], [t.detach().cpu() for t in p.parameters()]))
    (card_masks, card_p), (cpu_masks, cpu_p) = runs
    for a, b in zip(card_masks, cpu_masks):
        assert torch.equal(a, b)
    for a, b in zip(card_p, cpu_p):
        diff = (a - b).abs()
        assert float(diff.max()) <= 2.2 * lr * max(d_n, g_n)
        assert float((diff <= 0.01 * lr).float().mean()) >= 0.99


def test_cfgan_mask_kernels_launch_inside_train_masks(cuda, monkeypatch):
    """A CFGAN csr fit (scheme ZR): each G minibatch launches the keyed draw
    and then K2 once, both inside the step's ``train.masks`` span; a D
    minibatch draws no mask and launches neither."""
    from ganmf_tpu_torch.ops import keyed

    launches = []

    def spy(count):
        def counted(name, n=1):
            count(name, n)
            launches.append((name, [profiling._SPANS[i][0] for i in profiling._OPEN]))
        return counted

    monkeypatch.setattr(select, "count", spy(select.count))
    monkeypatch.setattr(keyed, "count", spy(keyed.count))
    rng = np.random.RandomState(0)
    train = sps.csr_matrix((rng.rand(300, 700) < 0.02).astype(np.float32))
    model = pcf.CFGAN(train, seed=3, is_experiment=True, device=cuda)
    with profiling.recording():
        model.fit(g_nodes=64, d_nodes=4, d_layers=5, g_hidden_act="tanh", scheme="ZR", zr_ratio=0.45,
                  zr_coefficient=0.05, d_batch_size=32, g_batch_size=128, epochs=1, urm_storage="csr")
    spans, changed = profiling.drain()
    g_n = -(-300 // 128)
    assert changed["keyed.launches"] == changed["k2.launches"] == g_n
    assert [name for name, _ in launches] == ["keyed.launches", "k2.launches"] * g_n
    assert all(stack == ["train.epoch", "train.g_step", "train.masks"] for _, stack in launches)
    steps = [s.name for s in spans if s.name in ("train.d_step", "train.g_step")]
    assert steps == ["train.d_step"] * -(-300 // 32) + ["train.g_step"] * g_n


def _beyond_hbm_keys(cuda, I, grid):
    """A CFGAN csr G minibatch's keys at the beyond-HBM script's settings:
    128 rows of a ``synthetic_urm`` (100 draws a user), the keyed draw's
    uniforms (or those cut to a grid of 4096ths, so that nearly every row's
    k-th key ties), +inf at the interactions, k = int(n_zeros * 0.3)."""
    from ganmf_tpu_torch.cli import beyond_hbm
    from ganmf_tpu_torch.data.synthetic import synthetic_urm
    from ganmf_tpu_torch.ops import keyed

    cond = torch.from_numpy(synthetic_urm(128, I, 100).toarray()).to(cuda)
    u = keyed.keyed_uniforms(beyond_hbm.SEED, 1, pcf.ZR_STREAM, torch.arange(128, device=cuda), I)
    if grid == "4096ths":
        u = torch.floor(u * 4096) / 4096
    keys = torch.where(cond != 0, float("inf"), u)
    k = ((cond == 0).sum(1).to(torch.float32) * float(beyond_hbm.CFGAN_PARAMS["zr_ratio"])).to(torch.int32)
    return keys, k


@pytest.mark.parametrize("grid", ["keyed", "4096ths"])
@pytest.mark.parametrize("I", [65536, 131072])
def test_k2_past_shared_memory_on_keyed_keys(cuda, I, grid):
    """K2's streamed-row route (rows past 56,320 keys) at the beyond-HBM
    widths, [128, 65536] and [128, 131072], on keyed-draw keys with ties:
    bitwise the plain version, every row holding k; the keyed draw's 2^-24
    grid ties keys in every row, the coarse grid ties the k-th key (K2's tie
    cut) in most."""
    keys, k = _beyond_hbm_keys(cuda, I, grid)
    before = _counter("k2.launches")
    got = smallest_k_mask(keys, k)
    assert _counter("k2.launches") == before + 1
    assert torch.equal(got, smallest_k_mask_reference(keys, k))
    assert torch.equal(got.sum(1), k.long())
    ordered = torch.sort(keys, dim=1).values
    assert bool(((ordered[:, 1:] == ordered[:, :-1]) & torch.isfinite(ordered[:, 1:])).any(1).all())
    kth = ordered.gather(1, (k.long() - 1)[:, None])
    cut = (keys == kth).sum(1) > k - (keys < kth).sum(1)
    if grid == "4096ths":
        assert int(cut.sum()) > 64


def test_cfgan_csr_epoch_past_shared_memory_does_not_synchronize(cuda):
    """CFGAN's csr epoch at the beyond-HBM script's settings (d_nodes 64,
    g_nodes 256, ZR 0.3, batches 128) on an 8,192 x 131,072 synthetic URM,
    its masks through K2's streamed-row route: K2 and the keyed draw launched
    once a G minibatch, and a second epoch only enqueuing (sync debug mode
    "error"); the parameters finite, and moved."""
    from ganmf_tpu_torch.cli import beyond_hbm
    from ganmf_tpu_torch.data.synthetic import synthetic_urm
    from ganmf_tpu_torch.ops import keyed

    p_ = beyond_hbm.CFGAN_PARAMS
    train = synthetic_urm(8192, 131072, 100)
    n_rows, n_cols = train.shape
    d_n, d_pad = make_batches(n_rows, p_["d_batch_size"])
    g_n, g_pad = make_batches(n_rows, p_["g_batch_size"])
    w = torch.from_numpy(padded_weights(n_rows, max(d_pad, g_pad))).to(cuda)
    pc = padded_csr_from_sparse(train, cuda)
    p = pcf.init_params([n_cols, p_["g_nodes"], n_cols], [2 * n_cols, p_["d_nodes"], 1],
                        torch.Generator().manual_seed(beyond_hbm.SEED), cuda)
    init = [t.detach().clone() for t in p.parameters()]
    d_opt = torch.optim.Adam(p.D.parameters(), lr=1e-3, betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
    g_opt = torch.optim.Adam(p.G.parameters(), lr=1e-3, betas=pcf.ADAM_BETAS, eps=pcf.ADAM_EPS)
    kw = dict(d_reg=0.0, g_reg=0.0, zr_ratio=p_["zr_ratio"], zp_ratio=0.0, zr_coefficient=p_["zr_coefficient"],
              scheme=p_["scheme"], d_hidden_act="linear", g_hidden_act="linear", d_n_batches=d_n,
              d_batch=p_["d_batch_size"], g_n_batches=g_n, g_batch=p_["g_batch_size"], d_steps=1, g_steps=1)

    def epoch(e):
        pcf.cfgan_epoch(p, d_opt, g_opt, pc, lambda stream, rows: keyed.keyed_uniforms(beyond_hbm.SEED, e, stream,
                                                                                       rows, n_cols), w, w, **kw)

    k2, drawn = _counter("k2.launches"), _counter("keyed.launches")
    epoch(1)
    assert _counter("k2.launches") - k2 == _counter("keyed.launches") - drawn == g_n == 64
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        epoch(2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in p.parameters())
    assert all(not torch.equal(t, i) for t, i in zip(p.parameters(), init))


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "scatter"])
def test_colblock_similarity_on_card_is_the_cpus(cuda, int8, monkeypatch):
    """The column-blocked build of 0/1 data on the card: bitwise the CPU's
    (exact integer Gram slabs; the int8 form through torch._int_mm)."""
    from ganmf_tpu_torch.ops import similarity as psim

    rng = np.random.RandomState(2)
    X = sps.csr_matrix((rng.rand(300, 1280) < 0.03).astype(np.float32))
    monkeypatch.setattr(psim, "_DENSE_A_BYTE_LIMIT", 1)
    monkeypatch.setattr(psim, "_GRAM_BYTE_LIMIT", 4 * 1280 * 1280 - 1)
    if not int8:
        monkeypatch.setattr(psim, "_INT8_A_BYTE_LIMIT", 0)
    assert psim.colblock_plan(2048, 1280, True, cuda) == (512, int8)
    for similarity in ("cosine", "jaccard"):
        got = psim.compute_similarity(X, similarity, topK=50, shrink=5.0, device=cuda)
        want = psim.compute_similarity(X, similarity, topK=50, shrink=5.0, device=torch.device("cpu"))
        assert got.nnz > 0 and (got != want).nnz == 0


def test_caae_dedup_epoch_on_card_is_deterministic(cuda):
    """d_scatter="dedup" on the card: two runs bitwise equal (no two adds
    meet), within 1% of the distance moved of the "direct" form."""
    from ganmf_tpu_torch.models import caae as pca

    runs = []
    for form in ("dedup", "dedup", "direct"):
        params, urm, users, items, w, draws, kw = _caae_epoch_args(cuda)
        pca.caae_epoch(params, urm, users, items, w, draws, d_scatter=form, **kw)
        runs.append([t.detach().cpu() for t in params.parameters()])
    init = _caae_epoch_args(torch.device("cpu"))[0]
    for i, (a, b, direct, t0) in enumerate(zip(*runs, init.parameters())):
        assert torch.equal(a, b), i
        moved = float((direct - t0.detach()).abs().max())
        assert moved > 0 and float((a - direct).abs().max()) <= 1e-2 * moved, i


# -- the mesh path: K1 on an item shard, the shards' merge -----------------------------

@pytest.mark.parametrize("case", ["random", "grid", "ties", "masked_rows"])
def test_k1_on_an_item_shard_with_its_offset(cuda, case):
    """K1 on each item shard of a (data 2, model 2) mesh's evaluation block
    (a data rank's 1512 rows, K=250, 1853 of ML-1M's 3706 items): the shard's
    plain version with its ids offset; the shards' candidates, ranked again
    by ``topk_lowest_index`` in shard order, are K1's list over all items."""
    from ganmf_tpu_torch.ops.topk import topk_lowest_index

    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs(case, 1512, 3706, 250))
    parts = []
    for i0, i1 in ((0, 1853), (1853, 3706)):
        Vm, Mm = V[i0:i1].contiguous(), mask[:, i0:i1].contiguous()
        before = _counter("k1.launches")
        vals, ids = masked_topk_scores(U, Vm, Mm, 50, id_offset=i0)
        assert _counter("k1.launches") == before + 1
        assert int(ids.min()) >= i0 and int(ids.max()) < i1
        _assert_k1_matches(U, Vm, Mm, 50, vals, ids - i0, case in EXACT)
        parts.append((vals, ids))
    merged, pos = topk_lowest_index(torch.cat([v for v, _ in parts], 1), 50)
    merged_ids = torch.gather(torch.cat([i for _, i in parts], 1), 1, pos)
    _assert_k1_matches(U, V, mask, 50, merged, merged_ids, case in EXACT)


@pytest.fixture(scope="module")
def world_of_one():
    """A mesh plan over a world of one rank on NCCL: every collective a
    real NCCL call on the card."""
    import socket

    from ganmf_tpu_torch.parallel import comm, make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    comm.initialize(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, local_rank=torch.cuda.current_device())
    try:
        yield make_mesh()
    finally:
        comm.shutdown()


def test_sharded_topk_in_a_world_of_one_over_nccl(cuda, world_of_one):
    """``sharded_topk``'s merge on CUDA tensors through real NCCL calls, in a
    world of one rank: bitwise ``topk_lowest_index`` of the whole rows, with
    ties, signed zeros and a row that is -inf throughout."""
    import torch.distributed as dist

    from ganmf_tpu_torch.ops.topk import sharded_topk, topk_lowest_index

    plan = world_of_one
    assert dist.get_backend() == "nccl" and plan.device == cuda and plan.group("model") is not None
    rng = np.random.RandomState(0)
    scores = rng.randn(8, 3706).astype(np.float32)
    scores[1] = np.round(scores[1])
    scores[2, ::2], scores[2, 1::2] = 0.0, -0.0
    scores[3] = -np.inf
    x = torch.from_numpy(scores).to(cuda)
    vals, ids = sharded_topk(x, 50, plan)
    want_vals, want_ids = topk_lowest_index(x, 50)
    assert torch.equal(ids, want_ids) and torch.equal(vals, want_vals)
    assert torch.equal(torch.signbit(vals), torch.signbit(want_vals))


@pytest.mark.parametrize("lazy", [False, True], ids=["dense_adam", "lazy_adam"])
@pytest.mark.parametrize("storage", ["dense", "csr"])
def test_sharded_epoch_in_a_world_of_one_is_the_epoch_and_does_not_synchronize(cuda, world_of_one, storage,
                                                                              lazy):
    """The sharded GANMF epoch on a world of one over NCCL: bitwise the
    one-card epoch from the same state (the same products; the collectives
    copy), and, run again, only enqueues (sync debug mode "error")."""
    from ganmf_tpu_torch.parallel.distributed import ShardLayout, shard_ganmf_params, sharded_ganmf_epoch

    plan = world_of_one
    runs = []
    for sharded in (False, True):
        p, d_opt, item_opt, state, urm, perm, w, n = _ganmf_epoch_inputs(cuda, "user", storage)
        kw = dict(n_batches=n, lazy_user_adam=lazy, **_GANMF_KW)
        if sharded:
            lay = ShardLayout(plan, p.user_emb.shape[0], p.item_emb.shape[0])
            p = shard_ganmf_params(p, plan)
            d_opt = torch.optim.Adam(p.d_params(), lr=1e-3, betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
            item_opt = torch.optim.Adam([p.item_emb], lr=2e-3, betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)
            state = pgm.user_adam_state(p.user_emb)
            run = lambda: sharded_ganmf_epoch(lay, p, d_opt, item_opt, state, urm, perm, w, **kw)  # noqa: E731
        else:
            run = lambda: pgm.ganmf_epoch(p, d_opt, item_opt, state, urm, perm, w, **kw)  # noqa: E731
        losses = run()
        runs.append(([t.detach().clone() for t in p.parameters()], [float(x) for x in losses]))
    (want, want_losses), (got, got_losses) = runs
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got_losses == want_losses
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = run()  # the sharded epoch, its optimizers' state made
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(np.isfinite(float(x)) for x in losses)


def _gan_epoch_pair(kind, dev, plan):
    """(the one-card epoch, the sharded epoch on ``plan``, the parameters of
    each) of DisGANMF, CFGAN (dense or csr) or CAAE (dedup), each from its
    own copy of the same initial state and draws."""
    from ganmf_tpu_torch.models import caae as pca
    from ganmf_tpu_torch.models import disganmf as pdg
    from ganmf_tpu_torch.ops import keyed
    from ganmf_tpu_torch.parallel import adversarial as padv
    from ganmf_tpu_torch.parallel import distributed as pdist

    def adam(params, lr):
        return torch.optim.Adam(params, lr=lr, betas=pgm.ADAM_BETAS, eps=pgm.ADAM_EPS)

    if kind == "disganmf":
        p, d_opt, item_opt, state, urm, perm, w, n = _disganmf_epoch_inputs(dev, "user")
        kw = dict(n_batches=n, lazy_user_adam=True, **_DIS_KW)
        s = pdist.shard_disganmf_params(_disganmf_epoch_inputs(dev, "user")[0], plan)
        lay = pdist.ShardLayout(plan, *urm.shape)
        s_opts = adam(s.d_params(), 1e-3), adam([s.item_emb], 2e-3), pgm.user_adam_state(s.user_emb)
        return (lambda: pdg.disganmf_epoch(p, d_opt, item_opt, state, urm, perm, w, **kw),
                lambda: padv.sharded_disganmf_epoch(lay, s, *s_opts, plan.put(urm, plan.urm), perm, w, **kw), p, s)
    if kind == "caae_dedup":
        p, urm, users, items, w, draws, kw = _caae_epoch_args(dev)
        s = pdist.shard_caae_params(_caae_epoch_args(dev)[0], plan)
        lay = pdist.ShardLayout(plan, *urm.shape)
        n_nonint = (urm == 0).sum(1)
        return (lambda: pca.caae_epoch(p, urm, users, items, w, draws, d_scatter="dedup", **kw),
                lambda: padv.sharded_caae_epoch(lay, s, plan.put(urm, plan.urm), n_nonint, users, items, w, draws,
                                                d_scatter="dedup", **kw), p, s)
    rng = np.random.RandomState(0)
    mat = sps.csr_matrix((rng.rand(300, 700) < 0.02).astype(np.float32))
    n_rows, n_cols = mat.shape
    d_n, d_pad = make_batches(n_rows, 64)
    g_n, g_pad = make_batches(n_rows, 128)
    padded = max(d_pad, g_pad)
    w = torch.from_numpy(padded_weights(n_rows, padded)).to(dev)
    kw = dict(d_reg=1e-4, g_reg=1e-4, zr_ratio=0.45, zp_ratio=0.2, zr_coefficient=0.05, scheme="ZP",
              d_hidden_act="linear", g_hidden_act="tanh", d_n_batches=d_n, d_batch=64, g_n_batches=g_n,
              g_batch=128, d_steps=1, g_steps=1)
    if kind == "cfgan_csr":
        urm = padded_csr_from_sparse(mat, dev)
        local, lay = pdist.shard_padded_csr(urm, plan), pdist.ShardLayout(plan, n_rows, n_cols)

        def uniforms(stream, rows):
            return keyed.keyed_uniforms(11, 1, stream, rows, n_cols)
    else:
        urm = torch.zeros((padded, n_cols), device=dev)
        urm[:n_rows] = torch.from_numpy(mat.toarray()).to(dev)
        local, lay = plan.put(urm, plan.urm), pdist.ShardLayout(plan, padded, n_cols)
        uniforms = tuple(torch.rand((padded, n_cols), generator=torch.Generator().manual_seed(s)).to(dev)
                         for s in (2, 3))

    def init():
        return pcf.init_params([n_cols, 128, n_cols], [2 * n_cols, 4, 4, 1], torch.Generator().manual_seed(1), dev)

    p, s = init(), pdist.shard_cfgan_params(init(), plan)
    opts = adam(p.D.parameters(), 1e-3), adam(p.G.parameters(), 1e-3)
    s_opts = adam(s.D.parameters(), 1e-3), adam(s.G.parameters(), 1e-3)
    return (lambda: pcf.cfgan_epoch(p, *opts, urm, uniforms, w, w, **kw),
            lambda: padv.sharded_cfgan_epoch(lay, s, *s_opts, local, uniforms, w, w, n_rows=n_rows, **kw), p, s)


@pytest.mark.parametrize("kind", ["disganmf", "cfgan_dense", "cfgan_csr", "caae_dedup"])
def test_gan_sharded_epochs_in_a_world_of_one_are_the_epochs_and_do_not_synchronize(cuda, world_of_one, kind):
    """DisGANMF's, CFGAN's (dense and csr storage) and CAAE's (dedup) sharded
    epochs on a world of one over NCCL: bitwise the one-card epochs from the
    same state and draws (the same products; the collectives copy), with K2
    launched on the mesh path by CFGAN and CAAE (and the keyed draw by csr),
    and, run again, only enqueuing (sync debug mode "error")."""

    one_card, sharded, p, s = _gan_epoch_pair(kind, cuda, world_of_one)
    one_card()
    k2, drawn = _counter("k2.launches"), _counter("keyed.launches")
    sharded()
    assert (_counter("k2.launches") > k2) == (kind != "disganmf")
    assert (_counter("keyed.launches") > drawn) == (kind == "cfgan_csr")
    for a, b in zip(s.parameters(), p.parameters()):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sharded()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in s.parameters())


# -- IALS, MF-SGD, SLIM-BPR and EASE-R on a mesh -----------------------------------


def _baseline_fit(name, train, plan):
    """(the model, its full result tensors) of ``name``'s one-epoch fit with
    ``plan`` (None: one card)."""
    import ganmf_tpu_torch.models as pmodels
    from ganmf_tpu_torch.models import ials

    if name.startswith("ials"):
        model = pmodels.IALSRecommender(train)
        limit = ials._PAD_PLANE_BYTE_LIMIT
        ials._PAD_PLANE_BYTE_LIMIT = 1 if name == "ials_flat" else limit
        try:
            model.fit(epochs=2, num_factors=16, alpha=5.0, urm_storage="csr" if name == "ials_flat" else "dense",
                      mesh_plan=plan)
        finally:
            ials._PAD_PLANE_BYTE_LIMIT = limit
        return model, [model._on_device(model._USER_factors_store), model._on_device(model._ITEM_factors_store)]
    if name.startswith("mf"):
        model = pmodels.MatrixFactorization_BPR(train)
        model.fit(epochs=1, num_factors=16, batch_size=64, learning_rate=0.05, mesh_plan=plan,
                  urm_storage="csr" if name.endswith("csr") else "dense")
        return model, [model._on_device(model._USER_factors_store), model._on_device(model._ITEM_factors_store)]
    model = pmodels.SLIM_BPR(train)
    model.fit(epochs=1, topK=100, learning_rate=0.0539, lambda_i=2.93e-4, mesh_plan=plan)
    return model, [model._full_w(model._state.W)]


@pytest.mark.parametrize("name", ["ials_dense", "ials_flat", "mf_dense", "mf_csr", "slim"])
def test_baseline_fits_in_a_world_of_one_match_the_one_card_fits(cuda, world_of_one, name):
    """IALS (dense, flat csr), MF-SGD BPR (dense, csr) and SLIM-BPR with a
    plan over a world of one on NCCL, against the one-card fit from the same
    state and draws: flat-csr IALS bitwise, dense IALS within rtol 2e-4 /
    atol 2e-6, MF-SGD and SLIM-BPR within 1e-5 (index_add_'s atomics order
    a chunk's duplicate rows either way); then the mesh epochs of MF-SGD and
    SLIM-BPR, run again, only enqueue (sync debug mode "error")."""
    train, _ = _sim_split()
    _, want = _baseline_fit(name, train, None)
    model, got = _baseline_fit(name, train, world_of_one)
    for a, b in zip(got, want):
        if name == "ials_flat":
            assert torch.equal(a, b)
        elif name == "ials_dense":
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-6)
        else:
            assert float((a - b).abs().max()) <= 1e-5
    if name.startswith("ials"):
        return
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model._run_epoch(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in model._state[:4])


def test_ease_r_topk_sharded_in_a_world_of_one_matches_the_card(cuda, world_of_one):
    """``ease_r_topk_sharded`` on a plan over a world of one on NCCL (the
    panel broadcasts real NCCL calls) against the one-card EASE-R: the same
    count of entries in every column, the entries within rtol 1e-4 plus 1e-5
    of max|B| (tests/test_torch_extras.py's bound)."""
    from ganmf_tpu_torch.data.device import dense_from_sparse
    from ganmf_tpu_torch.models.extras import ease_r_weights_topk
    from ganmf_tpu_torch.ops.distchol import ease_r_topk_sharded
    from ganmf_tpu_torch.ops.topk import scatter_col_topk_dense

    train, _ = _sim_split(binary=True)
    A = dense_from_sparse(train, cuda)
    want = scatter_col_topk_dense(*ease_r_weights_topk(A, 50.0, 30)).cpu()
    got = scatter_col_topk_dense(*ease_r_topk_sharded(A, 50.0, 30, world_of_one)).cpu()
    assert torch.equal((got != 0).sum(0), (want != 0).sum(0))
    both = (got != 0) & (want != 0)
    torch.testing.assert_close(got[both], want[both], rtol=1e-4, atol=1e-5 * float(want.abs().max()))


_GAN_MESH_FIT = dict(num_factors=16, epochs=1, batch_size=32, d_lr=1e-3, g_lr=1e-3)
_SEEDED = dict(seed=5, is_experiment=True)
_MESH_FITS = {  # (class, its constructor's keywords, fit's keywords)
    "ganmf_user": ("GANMF", dict(_SEEDED, mode="user"), dict(_GAN_MESH_FIT, **_GAN_WIDTHS["GANMF"])),
    "ganmf_item": ("GANMF", dict(_SEEDED, mode="item"), dict(_GAN_MESH_FIT, **_GAN_WIDTHS["GANMF"])),
    "disganmf": ("DisGANMF", _SEEDED, dict(_GAN_MESH_FIT, **_GAN_WIDTHS["DisGANMF"])),
    "cfgan_csr": ("CFGAN", _SEEDED, dict(_CFGAN_FIT, urm_storage="csr", epochs=1)),
    "caae_dedup": ("CAAE", _SEEDED, dict(_CAAE_FIT, d_scatter="dedup", epochs=1)),
    "ials_flat": ("IALSRecommender", {}, dict(epochs=2, num_factors=16, alpha=5.0, urm_storage="csr")),
}


@pytest.mark.parametrize("name", sorted(_MESH_FITS))
def test_mesh_fit_and_evaluation_in_a_world_of_one_match_the_one_card_path(cuda, world_of_one, name,
                                                                          monkeypatch):
    """GANMF (both modes), DisGANMF, CFGAN (csr), CAAE (dedup) and IALS
    (flat csr) fit with a plan over a world of one on NCCL and evaluated by
    an evaluator on that plan: every metric within 1e-5 of the one-card
    fit's one-card evaluation from the same seed; the mesh evaluation ranks
    the factor models through K1, and CFGAN's and CAAE's mesh fits draw
    through K2."""
    import ganmf_tpu_torch.models as pm
    from ganmf_tpu_torch.models import ials

    cls_name, init, params = _MESH_FITS[name]
    monkeypatch.setattr(ials, "_PAD_PLANE_BYTE_LIMIT", 1)  # IALS's csr storage in its flat form
    train, test = _sim_split(binary=True)
    results = []
    for plan in (None, world_of_one):
        model = getattr(pm, cls_name)(train, **init)
        k2 = _counter("k2.launches")
        model.fit(mesh_plan=plan, **params)
        if plan is not None:
            assert (_counter("k2.launches") > k2) == (cls_name in ("CFGAN", "CAAE"))
        k1 = _counter("k1.launches")
        results.append(EvaluatorHoldout(test, [5, 10, 20, 50], mesh_plan=plan).evaluateRecommender(model)[0])
        assert (_counter("k1.launches") > k1) == (cls_name not in ("CFGAN", "CAAE"))
    want, got = results
    for c in want:
        for metric, value in want[c].items():
            assert got[c][metric] == pytest.approx(value, abs=1e-5, nan_ok=True), (c, metric)


# -- JAX's bf16 similarity routes and the graft entry points ----------------------

def test_bf16_products_on_card_keep_float32_outputs(cuda):
    """``bf16_mm`` on the card (``torch.mm``/``addmm`` with
    ``out_dtype=torch.float32``): a float32 result that no bf16 output could
    hold, and the in-place accumulation into a float32 G."""
    from ganmf_tpu_torch.ops.simscore import bf16_mm

    a = torch.ones((3, 601), dtype=torch.bfloat16, device=cuda)
    s = bf16_mm(a, a.T)
    assert s.dtype == torch.float32 and bool((s == 601.0).all())
    G = torch.ones((3, 3), device=cuda)
    assert bf16_mm(a, a.T, out=G).data_ptr() == G.data_ptr() and bool((G == 602.0).all())


@pytest.mark.parametrize("route", ["dense", "resident", "streamed"])
def test_bf16_gram_routes_on_card_are_bitwise(cuda, route, monkeypatch):
    """The Gram of 0/1 data by bf16 products on each single-card route,
    bitwise the card's float32 Gram and the CPU's bf16 one."""
    from ganmf_tpu_torch.ops import similarity as psim

    train, _ = _sim_split(binary=True)
    ones_c, ones = torch.ones(train.shape[0], device=cuda), torch.ones(train.shape[0])
    want, _, _ = psim.build_gram(train, ones_c, False, cuda)
    monkeypatch.setattr(psim, "_STREAM_CHUNK", 64)
    if route != "dense":
        monkeypatch.setattr(psim, "_DENSE_A_BYTE_LIMIT", 1)
    if route == "streamed":
        monkeypatch.setattr(psim, "device_memory_bytes", lambda device: 1 << 30)
    G, _, got = psim.build_gram(train, ones_c, False, cuda, True)
    Gp, _, _ = psim.build_gram(train, ones, False, torch.device("cpu"), True)
    assert got == route and G.dtype == torch.float32
    assert torch.equal(G, want) and torch.equal(G.cpu(), Gp)


def test_plane_scoring_on_card_matches_cpu(cuda):
    """The split-plane product on the card against the CPU's plain version
    from the same planes: values within rtol 1e-5 / atol 1e-7, ids equal but
    at near ties of the card's scores."""
    from ganmf_tpu_torch.ops.simscore import masked_topk_matmul, plane_product, split_bf16_planes

    rng = np.random.RandomState(4)
    rows = torch.from_numpy((rng.rand(256, 3000) < 0.02).astype(np.float32)).to(torch.bfloat16)
    W = torch.from_numpy((rng.rand(3000, 3000) * (rng.rand(3000, 3000) < 0.05)).astype(np.float32))
    planes = split_bf16_planes(W.to(cuda))
    pairs = torch.zeros((256, 1), dtype=torch.int64)
    v, i, _, _ = masked_topk_matmul(rows.to(cuda), planes, None, pairs.to(cuda), 50, mask_from_rows=True)
    pv, pi, _, _ = masked_topk_matmul(rows, tuple(p.cpu() for p in planes), None, pairs, 50, mask_from_rows=True)
    v, i = v.cpu(), i.cpu()
    fin = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(v), fin)
    torch.testing.assert_close(v[fin], pv[fin], rtol=RTOL, atol=ATOL)
    scores = plane_product(rows.to(cuda), planes).masked_fill(rows.to(cuda) != 0, float("-inf")).cpu()
    diff = (i != pi) & fin
    sa, sb = torch.gather(scores, 1, i)[diff], torch.gather(scores, 1, pi)[diff]
    assert bool(((sa - sb).abs() <= RTOL * sb.abs() + ATOL).all())


def test_graft_entry_on_card_eager_and_compiled(cuda):
    """``entry()``'s losses on the card, eagerly and under torch.compile,
    within rtol 1e-5 of the CPU's."""
    from ganmf_tpu_torch import graft

    fn, args = graft.entry()
    cpu_fn, cpu_args = graft.entry(device="cpu")
    want = torch.stack([x.detach() for x in cpu_fn(*cpu_args)])
    for f in (fn, torch.compile(fn)):
        got = torch.stack([x.detach() for x in f(*args)]).cpu()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def _host_syncs() -> int:
    return sum(v for k, v in profiling.counters().items() if k.startswith("host_sync."))


@contextlib.contextmanager
def _sync_warnings():
    """The warnings of the block, with CUDA's sync debug mode on "warn": one
    for each synchronization of the host with the card."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _syncs_in(caught) -> int:
    return sum("synchronizing" in str(w.message) for w in caught)


class _EpochSyncs:
    """A metrics logger that takes, at each epoch's end, the synchronizations
    reported so far and the host_sync counter."""

    def __init__(self):
        self.caught, self.at = None, []

    def log_epoch(self, epoch):
        self.at.append((_syncs_in(self.caught), _host_syncs()))

    def log_eval(self, epoch, results):
        pass


def test_host_sync_counter_is_the_sync_debug_count(cuda):
    """On the three paths the benchmark times, the host_sync counter rises
    by the synchronizations CUDA's sync debug mode reports: a GANMF epoch
    after the first (dense and csr, one: the shuffle's upload), a full
    evaluation after the first (the two reads back: its block plan is kept
    from the first) and a recommend call (the ids in, the values and the ids back)."""
    rng = np.random.RandomState(3)
    full = (rng.rand(300, 500) < 0.05).astype(np.float32)
    held = rng.rand(300, 500) < 0.2
    train, test = sps.csr_matrix(full * ~held), sps.csr_matrix(full * held)
    for storage in ("dense", "csr"):
        model = GANMF(train, seed=5, is_experiment=True)
        model.metrics_logger = logger = _EpochSyncs()
        with _sync_warnings() as caught:
            logger.caught = caught
            model.fit(num_factors=16, emb_dim=64, epochs=3, batch_size=32, urm_storage=storage)
        (w1, c1), (w2, c2), (w3, c3) = logger.at
        assert (w2 - w1, c2 - c1, w3 - w2, c3 - c2) == (1, 1, 1, 1), (storage, logger.at)
    ev = EvaluatorHoldout(test, [5, 10, 20, 50])
    ev.block_rows = lambda: 64
    for call, want in ((lambda: ev.evaluateRecommender(model), 2),
                       (lambda: model.recommend(7, cutoff=20), 3),
                       (lambda: model.recommend(np.arange(5), cutoff=20), 3)):
        call()  # the one-time uploads
        before = _host_syncs()
        with _sync_warnings() as caught:
            call()
        assert _syncs_in(caught) == _host_syncs() - before == want


def test_span_holds_its_kernel_on_the_profilers_clock(cuda):
    """A span around a kernel's launch and a synchronize holds that kernel's
    interval in a profile of the host and the card, within 20 us."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    with profiling.recording():
        with profiling.span("sleep"):
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
    prof.stop()
    (s,), _ = profiling.drain()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    k = max(kernels, key=lambda e: e.end_ns() - e.start_ns())
    assert k.end_ns() - k.start_ns() > 100_000
    assert s.start_ns - 20_000 <= k.start_ns() and k.end_ns() <= s.end_ns + 20_000, \
        (k.start_ns() - s.start_ns, s.end_ns - k.end_ns())
