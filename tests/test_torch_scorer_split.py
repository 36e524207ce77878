"""K1's fused kernel as it is decomposed on the card: the top-k of each item
split, then the merge pass, against the JAX kernel; and its launch plan.

The CUDA kernel ranks each split's items on its own (``fused_plan`` lays
out the splits) and a second kernel merges the S lists of each row by rank.
Here the same decomposition runs in plain torch on CPU tensors: the plain
top-k of each contiguous item range (ids shifted to the catalog, tails past
a short range filled with -inf keys whose ids lie past the catalog and
differ across splits, as the kernel's start keys do) and
``merge_partial_topk_reference`` over them. It is held against the JAX
Pallas kernel run in interpret mode, as tests/test_torch_scorer.py does.

Tolerances: finite values within rtol 1e-6 / atol 1e-6 (float32 dot
products summed in another order); ids equal at every finite slot (the
inputs leave no near-ties, and exact ties must go to the lowest id).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganmf_tpu.ops.pallas_scorer import masked_topk_scores as jax_masked_topk_scores
from ganmf_tpu_torch.ops import scorer
from ganmf_tpu_torch.ops.scorer import (
    fused_plan,
    masked_topk_scores_reference,
    merge_partial_topk_reference,
)

torch.set_num_threads(1)

#: dynamic shared memory one H100 block may use
H100_BLOCK_SMEM = 232448


def _inputs(case, B, I, K, seed=0):
    rng = np.random.RandomState(seed)
    if case == "ties":
        # duplicated item rows on a grid of eighths: every dot product is
        # exact in float32, so duplicates tie bitwise in any summation order
        U = rng.randint(-4, 5, (B, K)).astype(np.float32) / 8
        base = rng.randint(-4, 5, (I // 4, K)).astype(np.float32) / 8
        V = base[rng.randint(0, len(base), I)]
    else:
        U = rng.randn(B, K).astype(np.float32)
        V = rng.randn(I, K).astype(np.float32)
    mask = rng.rand(B, I) < 0.2
    if case == "masked_rows":
        mask[1] = True  # fully masked
        mask[5] = True
        mask[6] = True
        mask[6, ::9] = False  # fewer unmasked items than k=50
    return U, V, mask


@functools.lru_cache(maxsize=None)
def _jax_topk(case, I, k):
    U, V, mask = _inputs(case, 8, I, 16)
    vals, ids = jax_masked_topk_scores(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(mask.astype(np.int8)), k=k, tile=32, interpret=True
    )
    return np.asarray(vals), np.asarray(ids)


def _split_then_merge(U, V, mask, k, S):
    """Plain top-k of S contiguous item ranges, merged by rank."""
    I = V.shape[0]
    bounds = np.linspace(0, I, S + 1).astype(int)
    part_vals, part_ids = [], []
    for s in range(S):
        a, b = bounds[s], bounds[s + 1]
        width = min(k, b - a)
        vals, ids = masked_topk_scores_reference(U, V[a:b], mask[:, a:b], width)
        ids = ids + a
        if width < k:  # start keys: -inf, ids past the catalog, distinct per split
            pad = k - width
            vals = torch.cat([vals, torch.full((U.shape[0], pad), float("-inf"))], 1)
            start = torch.arange(I + s * k, I + s * k + pad).expand(U.shape[0], pad)
            ids = torch.cat([ids, start], 1)
        part_vals.append(vals)
        part_ids.append(ids)
    return merge_partial_topk_reference(torch.stack(part_vals), torch.stack(part_ids), k)


@pytest.mark.parametrize("case", ["random", "ties", "masked_rows"])
@pytest.mark.parametrize("S", [1, 2, 3, 7])
@pytest.mark.parametrize("I", [96, 257])
@pytest.mark.parametrize("k", [1, 5, 50])
def test_split_then_merge_matches_jax_kernel(case, S, I, k):
    U, V, mask = _inputs(case, 8, I, 16)
    jv, ji = _jax_topk(case, I, k)
    vals, ids = _split_then_merge(torch.from_numpy(U), torch.from_numpy(V), torch.from_numpy(mask), k, S)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int64
    assert tuple(vals.shape) == (8, k) and tuple(ids.shape) == (8, k)
    vals, ids = vals.numpy(), ids.numpy()
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(vals), fin)
    np.testing.assert_allclose(vals[fin], jv[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ids[fin], ji[fin])
    # masked items never rank, and -inf tails keep ids inside the catalog
    assert not np.take_along_axis(mask, ids, axis=1)[fin].any()
    assert ids.min() >= 0 and ids.max() < I


def test_merge_reference_orders_by_value_then_id():
    inf = float("-inf")
    part_vals = torch.tensor([[[3.0, 1.0, inf]], [[3.0, 2.0, 0.0]]])
    part_ids = torch.tensor([[[7, 2, 11]], [[4, 9, 5]]])
    vals, ids = merge_partial_topk_reference(part_vals, part_ids, 5)
    assert ids.tolist() == [[4, 7, 9, 2, 5]]  # the tie at 3.0 goes to id 4
    assert vals.tolist() == [[3.0, 3.0, 2.0, 1.0, 0.0]]


@pytest.mark.parametrize("B,I,k", [
    (3024, 3706, 50),  # an evaluation block, user mode
    (3016, 3706, 50),
    (2048, 3706, 20),  # serve_all blocks
    (1944, 3706, 20),
    (3706, 6040, 50),  # item mode
    (1, 3706, 20),  # recommend for one user
    (5, 3706, 64),
    (37, 96, 5),  # a single tile
])
def test_fused_plan_covers_the_work(B, I, k):
    plan = fused_plan(B, I, k)
    row_blocks, S = plan.grid
    # the blocks cover all rows and items, and every split holds a tile
    BM, BN = plan.rows_per_block, plan.items_per_tile
    assert row_blocks * BM >= B > (row_blocks - 1) * BM
    n_tiles = -(-I // BN)
    assert S == plan.splits and 1 <= S <= scorer.MAX_SPLITS
    assert S * plan.tiles_per_split >= n_tiles > (S - 1) * plan.tiles_per_split
    assert plan.smem_bytes == scorer.fused_smem_bytes() < H100_BLOCK_SMEM
    # two blocks (each with its 1 KB reserve) fit an SM's 228 KB
    assert scorer.BLOCKS_PER_SM * (plan.smem_bytes + 1024) <= 233472
    assert plan.scratch_bytes == (S * B * k * 8 if S > 1 else 0)


def test_fused_plan_splits_the_evaluation_block():
    """At the evaluation's shape the row blocks alone leave most SMs idle,
    so the plan splits the items; at a small batch it splits them more."""
    plan = fused_plan(3024, 3706, 50)
    assert plan.splits > 1
    assert plan.grid[0] * plan.splits >= scorer.H100_SMS
    assert fused_plan(1, 3706, 20).splits >= plan.splits


@pytest.mark.parametrize("B,I,k", [
    (3648, 26744, 50),  # ML-20M's evaluation block
    (3517, 26744, 50),  # its last block
    (3024, 3706, 50),
    (1000, 1001, 64),
    (64, 3706, 1),
    (3000, 250, 50),  # a single tile
])
def test_aligned_plan_covers_the_work(B, I, k):
    """The aligned main loop's plan: its own tiling (its slices, its shared
    memory) covers all rows and items, every split holds a tile, and two
    blocks fit an SM."""
    plan = fused_plan(B, I, k, aligned=True)
    tiling = scorer.FUSED_TILINGS[True]
    assert plan.aligned and (plan.rows_per_block, plan.items_per_tile) == (tiling.rows, tiling.items) == (64, 128)
    row_blocks, S = plan.grid
    assert row_blocks * 64 >= B > (row_blocks - 1) * 64
    n_tiles = -(-I // 128)
    assert S == plan.splits and 1 <= S <= scorer.MAX_SPLITS
    assert S * plan.tiles_per_split >= n_tiles > (S - 1) * plan.tiles_per_split
    assert plan.smem_bytes == scorer.fused_smem_bytes(True) < H100_BLOCK_SMEM
    assert scorer.BLOCKS_PER_SM * (plan.smem_bytes + 1024) <= 233472
    assert plan.scratch_bytes == (S * B * k * 8 if S > 1 else 0)


def test_route_tilings_as_the_kernel_fixes_them():
    """Each route's shared memory from its tiling: the running lists and
    candidates, and the ring of K-slices (three of 16 factors, factor-major
    rows padded by 4 floats, in the other loop; two of 32, row-major, in the
    aligned one)."""
    assert scorer.fused_smem_bytes(False) == 64 * (64 + 64) * 8 + 3 * 16 * (68 + 132) * 4
    assert scorer.fused_smem_bytes(True) == 64 * (64 + 64) * 8 + 2 * 32 * (64 + 128) * 4
    assert scorer.fused_smem_bytes() == scorer.fused_smem_bytes(False)


def test_eval_shape_takes_the_aligned_route():
    """ML-20M's evaluation block (K=128, factors 16-byte aligned) takes the
    aligned loop, whose plan splits the items so that the grid fills the
    card and its last wave is nearly full."""
    U, V = torch.zeros(3648, 128), torch.zeros(26744, 128)
    assert scorer.aligned_route(U, V)
    plan = fused_plan(3648, 26744, 50, aligned=True)
    blocks = plan.grid[0] * plan.splits
    slots = scorer.H100_SMS * scorer.BLOCKS_PER_SM
    assert plan.splits > 1 and blocks >= slots
    assert blocks % slots == 0 or blocks % slots >= 0.9 * slots
    # a mesh rank's item slice is aligned too at K % 4 == 0
    assert scorer.aligned_route(U, V[1237:6001])


@pytest.mark.parametrize("B,K,offset", [(1, 128, 0), (63, 128, 0), (3648, 250, 0), (3024, 250, 0),
                                        (3648, 130, 0), (3648, 128, 1), (1, 250, 0)])
def test_other_shapes_keep_todays_route(B, K, offset):
    """A batch under a row block (serving's B=1), K % 4 != 0 (the ML-1M
    cells' K=250) and factors off a 16-byte boundary keep the other main
    loop and its plan."""
    U = torch.zeros(B * K + offset)[offset:].view(B, K)
    assert not scorer.aligned_route(U, torch.zeros(3706, K))
    plan = fused_plan(B, 3706, 20)
    assert not plan.aligned and plan.items_per_tile == 128 and plan.smem_bytes == scorer.fused_smem_bytes(False)
