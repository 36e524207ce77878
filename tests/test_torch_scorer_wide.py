"""K1's wide pair (k > 64) as it is decomposed on the card, against the JAX
kernel; and its launch plan.

The CUDA pair sorts each row's items in tiles of ``tile`` (pad items past
the catalog last), keeps each sorted tile's first min(k, tile) keys, and
places every kept key at its index in its tile plus the kept keys below it
in the row's other tiles; a key placed below k is written out. Here the same
decomposition runs in plain torch on CPU tensors, over a total order of the
keys (value descending, ties to the lowest id, as the kernel's 64-bit keys
order them), and is held against the JAX Pallas kernel in interpret mode.

Tolerances: finite values within rtol 1e-6 / atol 1e-6 (float32 dot products
summed in another order); ids equal at every finite slot (the inputs leave
no near-ties, and exact ties must go to the lowest id).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganmf_tpu.ops.pallas_scorer import masked_topk_scores as jax_masked_topk_scores
from ganmf_tpu_torch.ops import scorer
from ganmf_tpu_torch.ops.scorer import wide_plan

torch.set_num_threads(1)


def _inputs(case, B, I, K, seed=0):
    rng = np.random.RandomState(seed)
    if case == "ties":
        # duplicated item rows on a grid of eighths: duplicates tie bitwise
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
        mask[5, ::9] = False  # fewer unmasked items than k
    return U, V, mask


@functools.lru_cache(maxsize=None)
def _jax_topk(case, I, k):
    U, V, mask = _inputs(case, 8, I, 16)
    vals, ids = jax_masked_topk_scores(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(mask.astype(np.int8)), k=k, tile=32, interpret=True
    )
    return np.asarray(vals), np.asarray(ids)


def _tiles_then_rank(U, V, mask, k, tile):
    """The wide pair's decomposition: sorted tiles, kept prefixes, places by
    rank across the row's tiles."""
    B, I = mask.shape
    scores = (U @ V.T).masked_fill(mask, float("-inf"))
    # the keys' total order: position in a stable descending sort; pad items
    # past the catalog come after every item
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    T = -(-I // tile)
    L = min(k, tile)
    key = torch.arange(T * tile).repeat(B, 1)
    key[:, :I] = torch.empty_like(order).scatter_(1, order, torch.arange(I).expand(B, I))
    item_of_key = torch.cat([order, torch.arange(I, T * tile).expand(B, -1)], 1)
    kept = torch.sort(key.view(B, T, tile), dim=2).values[:, :, :L]  # [B, T, L]
    place = torch.arange(L).expand(B, T, L).clone()
    for t in range(T):
        for o in range(T):
            if o != t:
                place[:, t] += torch.searchsorted(kept[:, o].contiguous(), kept[:, t].contiguous())
    vals = torch.full((B, k), float("nan"))
    ids = torch.full((B, k), -1, dtype=torch.int64)
    for b in range(B):
        sel = place[b] < k
        items = item_of_key[b, kept[b][sel]]
        ids[b, place[b][sel]] = items
        vals[b, place[b][sel]] = scores[b, items]
    return vals, ids


@pytest.mark.parametrize("case", ["random", "ties", "masked_rows"])
@pytest.mark.parametrize("tile", [8, 32, 128])
@pytest.mark.parametrize("I,k", [(96, 65), (257, 100), (130, 129)])
def test_tiles_then_rank_matches_jax_kernel(case, tile, I, k):
    U, V, mask = _inputs(case, 8, I, 16)
    jv, ji = _jax_topk(case, I, k)
    vals, ids = _tiles_then_rank(torch.from_numpy(U), torch.from_numpy(V), torch.from_numpy(mask), k, tile)
    vals, ids = vals.numpy(), ids.numpy()
    assert not np.isnan(vals).any() and (ids >= 0).all()  # every place below k is written once
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(vals), fin)
    np.testing.assert_allclose(vals[fin], jv[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ids[fin], ji[fin])
    # masked items never rank, and -inf tails keep ids inside the catalog
    assert not np.take_along_axis(mask, ids, axis=1)[fin].any()
    assert ids.max() < I


@pytest.mark.parametrize("B,I,k", [
    (5, 3706, 3705),  # recommend's default cutoff
    (1, 3706, 3705),
    (3024, 3706, 100),  # an evaluation above cutoff 64
    (64, 17632, 100),  # LastFM's catalog
    (37, 9000, 500),
    (1, 131072, 131071),
    (1, 97, 65),  # a single tile
    (70000, 200, 100),  # more rows than a grid's y extent
])
def test_wide_plan_covers_the_work(B, I, k):
    plan = wide_plan(B, I, k)
    assert plan.tile in scorer.WIDE_TILES
    assert plan.tiles * plan.tile >= I > (plan.tiles - 1) * plan.tile
    assert plan.kept == min(k, plan.tile)
    assert 1 <= plan.chunk_rows <= min(B, scorer.WIDE_MAX_CHUNK_ROWS)
    row_bytes = 8 * plan.tiles * plan.kept
    assert plan.scratch_bytes == plan.chunk_rows * row_bytes
    assert plan.scratch_bytes <= max(scorer.WIDE_SCRATCH_BYTES, row_bytes)


def test_wide_plan_spreads_small_batches():
    """A few rows take the narrow tile when it keeps a row to 32 tiles, so
    they spread over many SMs; once the row blocks fill the card, or a row
    is longer, the wide one."""
    assert wide_plan(5, 3706, 3705).tile == 128
    assert wide_plan(5, 3706, 3705).tiles == 29
    assert wide_plan(1, 4096, 100).tile == 128 and wide_plan(1, 4097, 100).tile == 512
    assert wide_plan(3024, 3706, 100).tile == 512
    assert wide_plan(1, 17632, 17631).tile == 512
    assert wide_plan(5, 3706, 3705, tile=512).tiles == 8
    with pytest.raises(ValueError):
        wide_plan(5, 3706, 3705, tile=256)


def test_small_scratch_is_kept_per_stream():
    dev = torch.device("cpu")
    a = scorer._scratch(dev, 7, 4096)
    assert scorer._scratch(dev, 7, 8192) is a and a.numel() * 8 >= scorer.KEEP_SCRATCH_BYTES
    assert scorer._scratch(dev, 8, 4096) is not a  # another stream, another buffer
    big = scorer._scratch(dev, 7, scorer.KEEP_SCRATCH_BYTES + 8)
    assert big is not a and big.numel() * 8 >= scorer.KEEP_SCRATCH_BYTES + 8
    scorer._KEPT_SCRATCH.clear()
