"""Scoring and masked top-k (K1).

Port of ``masked_topk_scores`` (ganmf_tpu/ops/pallas_scorer.py:173-234). The
serving path of every factor model is ``top_k(mask(U_b @ V^T))``, at any k
in [1, I]. On a CUDA tensor the wrapper launches the hand-written Hopper
kernels of csrc/masked_topk.cu, chosen from k alone: for k <= ``MAX_K`` the
fused kernel, which never writes the [B, I] score matrix, over a grid of
row blocks x item splits that ``fused_plan`` lays out, then, with more than
one split, a merge pass over the splits' lists. The fused kernel has two
main loops, one tiling each (``FUSED_TILINGS``), with the same arithmetic
and so the same bits; ``aligned_route`` picks the aligned one from what the
call shows (K, the factors' alignment, the batch). Above ``MAX_K`` the wide
pair, which ``wide_plan`` lays out: its first kernel scores and sorts tiles
of 128 or 512 items per row and keeps each tile's first min(k, tile) keys
in a scratch buffer of at most ``WIDE_SCRATCH_BYTES`` (rows go in chunks
that fit), its second ranks those keys across the row's tiles. On a CPU
tensor it takes the plain version, ``masked_topk_scores_reference``: that
is the tests' case, and the kernels are compared with it on the card. The
merge pass's plain version is ``merge_partial_topk_reference``.

``masked_topk_matmul`` is plain XLA in the JAX package (docstring :83-93);
its port, plain torch, is ops/simscore.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from ganmf_tpu_torch.ops._build import check, load_library, on_device, stream_handle
from ganmf_tpu_torch.utils.profiling import count

#: Item splits (the plan's S) of the last launch of the fused kernel; 0
#: before the first.
LAST_SPLITS = 0

#: Largest k of the fused kernel (the largest ranking cutoff is 50).
MAX_K = 64

#: Largest scratch buffer of the wide pair; rows are ranked in chunks that fit.
WIDE_SCRATCH_BYTES = 256 << 20

#: Scratch buffers up to this size (recommend's, a few rows) are kept, one
#: per device and stream, and reused by the next launch on that stream, which
#: saves the host an allocation on the latency-bound calls.
KEEP_SCRATCH_BYTES = 1 << 20
_KEPT_SCRATCH = {}

#: The wide pair's tile widths (items; csrc/masked_topk.cu instantiates
#: these), its user rows per tile block, the most tiles a row takes at a
#: width below the widest, and the most rows one chunk takes (a grid's y
#: extent).
WIDE_TILES = (128, 512)
WIDE_ROWS = 8
WIDE_MAX_TILES = 32
WIDE_MAX_CHUNK_ROWS = 65535

#: The most item splits the merge pass takes.
MAX_SPLITS = 16
#: Fused-kernel blocks an SM holds at once, on either route (its launch
#: bounds; both tilings keep two blocks' shared memory within an H100's 228 KB).
BLOCKS_PER_SM = 2
#: Streaming multiprocessors of an H100 SXM.
H100_SMS = 132
#: The least batch that takes the fused kernel's aligned main loop: one full
#: block of rows. On an H100 the aligned loop was as fast or faster at every
#: batch timed, down to B=1 (PERF.md section 6); below a full block the
#: calls are single-user serving, which keeps the loop it had.
ALIGNED_MIN_ROWS = 64


@dataclass(frozen=True)
class FusedTiling:
    """One of the fused kernel's two tilings, as csrc/masked_topk.cu fixes
    it (``FusedTile``): user rows per block, items per tile, factors per
    staged K-slice, K-slices in flight, candidate keys per row, and the
    floats each staged row is padded by."""

    rows: int
    items: int
    slice: int
    stages: int
    candidates: int
    pad: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block: each row's running top-k
        (MAX_K keys) and candidate buffer, and the ring of K-slices of U and
        V."""
        lists = self.rows * (MAX_K + self.candidates) * 8
        slices = self.stages * self.slice * ((self.rows + self.pad) + (self.items + self.pad)) * 4
        return lists + slices


#: The tiling of each route, keyed by ``aligned``: 4-byte copies into
#: factor-major slices of 16 factors for any K; 16-byte copies into row-major
#: slices of 32 factors where K % 4 == 0 and the factors are 16-byte aligned.
FUSED_TILINGS = {
    False: FusedTiling(rows=64, items=128, slice=16, stages=3, candidates=64, pad=4),
    True: FusedTiling(rows=64, items=128, slice=32, stages=2, candidates=64, pad=0),
}


@dataclass(frozen=True)
class FusedPlan:
    """Launch plan of K1's fused kernel for one call."""

    aligned: bool  # the main loop: the aligned one (FUSED_TILINGS[True]) or the other
    rows_per_block: int  # BM
    items_per_tile: int  # BN
    splits: int  # S: item splits, each of tiles_per_split tiles (the last may be shorter)
    tiles_per_split: int
    grid: tuple  # (row blocks, S)
    smem_bytes: int  # dynamic shared memory per block
    scratch_bytes: int  # the [S, B, k] uint64 key lists the merge pass reads, 0 when S = 1


def fused_smem_bytes(aligned: bool = False) -> int:
    """Dynamic shared memory of one fused block of the route's tiling."""
    return FUSED_TILINGS[aligned].smem_bytes


def aligned_route(user_factors, item_factors) -> bool:
    """Whether K1's fused kernel takes its aligned main loop: K % 4 == 0 (rows
    of a multiple of 16 bytes), both factor matrices 16-byte aligned (a
    mesh rank's item slice ``V[i0:i1]`` is, at such K), and at least
    ALIGNED_MIN_ROWS users."""
    B, K = user_factors.shape
    return (K % 4 == 0 and B >= ALIGNED_MIN_ROWS and user_factors.data_ptr() % 16 == 0
            and item_factors.data_ptr() % 16 == 0)


@lru_cache(maxsize=256)
def fused_plan(B: int, I: int, k: int, num_sms: int = H100_SMS, aligned: bool = False) -> FusedPlan:
    """Splits the route's item tiles so that the (row blocks x splits) grid
    fills ``num_sms`` SMs at BLOCKS_PER_SM each: of the split sizes that
    keep at most MAX_SPLITS splits, the one with the fewest tiles per block
    times waves of blocks, and of those the fewest splits.

    ``aligned`` picks the tiling: the wrapper passes ``aligned_route``'s
    answer, which needs K % 4 == 0, 16-byte aligned factors and at least
    ALIGNED_MIN_ROWS (64) users, one full block of rows. Both tilings hold
    two blocks an SM and tiles of 128 items, so the split search is the
    same; at ML-20M's evaluation block it gives S = 9, which on an H100 tied
    the best count timed for the aligned loop (S = 4) and beat the others
    by 9-30%."""
    tiling = FUSED_TILINGS[aligned]
    row_blocks = -(-B // tiling.rows)
    n_tiles = -(-I // tiling.items)
    slots = num_sms * BLOCKS_PER_SM
    best = None
    for tiles in range(n_tiles, -(-n_tiles // MAX_SPLITS) - 1, -1):
        S = -(-n_tiles // tiles)
        cost = -(-row_blocks * S // slots) * tiles
        if best is None or cost < best[0]:
            best = (cost, tiles, S)
    _, tiles, S = best
    return FusedPlan(
        aligned=aligned, rows_per_block=tiling.rows, items_per_tile=tiling.items, splits=S,
        tiles_per_split=tiles, grid=(row_blocks, S), smem_bytes=tiling.smem_bytes,
        scratch_bytes=S * B * k * 8 if S > 1 else 0)


@dataclass(frozen=True)
class WidePlan:
    """Launch plan of K1's wide pair for one call."""

    tile: int  # TW: items per tile, one of WIDE_TILES
    tiles: int  # T: item tiles per row
    kept: int  # L: keys each sorted tile keeps, min(k, TW)
    chunk_rows: int  # rows per launch pair; the scratch holds one chunk
    scratch_bytes: int  # the [chunk_rows, T, L] uint64 kept keys


def wide_plan(B: int, I: int, k: int, num_sms: int = H100_SMS, tile: int | None = None) -> WidePlan:
    """The tile width: the widest once the row blocks alone fill ``num_sms``
    SMs, else the narrowest that keeps a row to WIDE_MAX_TILES tiles (so a
    small batch spreads over many SMs; the rank kernel's searches grow with
    the tile count), else the widest; ``tile`` sets it instead (the
    measurement scripts and tests compare the widths). Each sorted tile
    keeps its first min(k, tile) keys (a key past that place in its tile is
    never among the row's first k); as many rows a chunk as
    WIDE_SCRATCH_BYTES holds, at least one."""
    if tile is None:
        widest = WIDE_TILES[-1]
        tile = widest
        if -(-B // WIDE_ROWS) * -(-I // widest) < num_sms:
            tile = next((t for t in WIDE_TILES if -(-I // t) <= WIDE_MAX_TILES), widest)
    if tile not in WIDE_TILES:
        raise ValueError(f"the wide pair's tile is one of {WIDE_TILES}, not {tile}")
    tiles = -(-I // tile)
    kept = min(k, tile)
    row_bytes = 8 * tiles * kept
    chunk_rows = max(1, min(B, WIDE_MAX_CHUNK_ROWS, WIDE_SCRATCH_BYTES // row_bytes))
    return WidePlan(tile=tile, tiles=tiles, kept=kept, chunk_rows=chunk_rows,
                    scratch_bytes=chunk_rows * row_bytes)


def _scratch(device: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """An int64 scratch buffer of at least ``nbytes`` for a launch on
    ``stream``. One of at most KEEP_SCRATCH_BYTES is the one kept for that
    device and stream: launches on one stream run in order, so the next
    launch that reuses it starts after this one is done with it."""
    if nbytes > KEEP_SCRATCH_BYTES:
        return torch.empty(nbytes // 8, dtype=torch.int64, device=device)
    key = (device.index, stream)
    if key not in _KEPT_SCRATCH:
        _KEPT_SCRATCH[key] = torch.empty(KEEP_SCRATCH_BYTES // 8, dtype=torch.int64, device=device)
    return _KEPT_SCRATCH[key]


def masked_topk_scores_reference(user_factors, item_factors, seen_mask, k: int):
    """The plain version: full f32 matmul, masked entries to -inf, then a
    top-k with ties to the lowest item id. Scores are compared as floats, as
    the TPU kernel and this one compare them (+0.0 and -0.0 tie), not by
    ``lax.top_k``'s total order."""
    scores = torch.matmul(user_factors, item_factors.T)
    scores = scores.masked_fill(seen_mask, float("-inf"))
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def merge_partial_topk_reference(part_vals, part_ids, k: int):
    """The plain version of the merge pass: each row's S lists (part_vals
    [S, B, k'] f32, part_ids [S, B, k'] int64, any order) ranked together,
    value descending and ties to the lowest id; returns the first k as
    (vals [B, k], ids [B, k])."""
    S, B, width = part_vals.shape
    vals = part_vals.permute(1, 0, 2).reshape(B, S * width)
    ids = part_ids.permute(1, 0, 2).reshape(B, S * width)
    by_id = torch.sort(ids, dim=1, stable=True).indices
    vals, ids = vals.gather(1, by_id), ids.gather(1, by_id)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    return vals.gather(1, order), ids.gather(1, order)


def _check(user_factors, item_factors, seen_mask, k: int):
    if user_factors.dim() != 2 or item_factors.dim() != 2 or seen_mask.dim() != 2:
        raise ValueError("user_factors, item_factors and seen_mask must be 2-D")
    B, K = user_factors.shape
    I, K2 = item_factors.shape
    if K2 != K or tuple(seen_mask.shape) != (B, I):
        raise ValueError(
            f"shapes do not agree: user_factors {tuple(user_factors.shape)}, "
            f"item_factors {tuple(item_factors.shape)}, seen_mask {tuple(seen_mask.shape)}")
    if user_factors.dtype != torch.float32 or item_factors.dtype != torch.float32:
        raise TypeError("user_factors and item_factors must be float32")
    if seen_mask.dtype != torch.bool:
        raise TypeError("seen_mask must be bool")
    if not user_factors.device == item_factors.device == seen_mask.device:
        raise ValueError("user_factors, item_factors and seen_mask must share a device")
    if not 1 <= k <= I:
        raise ValueError(f"k must lie in [1, {I}], got {k}")


def masked_topk_scores(user_factors, item_factors, seen_mask, k: int, id_offset: int = 0):
    """Top-k of ``U @ V^T`` with ``seen_mask`` entries excluded.

    user_factors [B, K] f32, item_factors [I, K] f32, seen_mask [B, I] bool
    (True = exclude), 1 <= k <= I. Returns (vals [B, k] f32, ids [B, k]
    int64), best first, ties to the lowest item id. A row with fewer than k
    unmasked items has -inf in its tail; the ids there are real items but
    unspecified.

    ``id_offset`` ranks one item shard: item_factors and seen_mask are the
    items [id_offset, id_offset + I) of a larger catalog (a mesh rank's
    slice), and the ids returned are global, the offset added after the
    launch."""
    vals, ids = _masked_topk(user_factors, item_factors, seen_mask, k)
    if id_offset:
        ids += id_offset
    return vals, ids


def _masked_topk(user_factors, item_factors, seen_mask, k: int):
    global LAST_SPLITS
    _check(user_factors, item_factors, seen_mask, k)
    device = user_factors.device
    if device.type == "cpu":
        return masked_topk_scores_reference(user_factors, item_factors, seen_mask, k)
    if device.type != "cuda":
        raise ValueError(f"masked_topk_scores runs on CPU or CUDA tensors, not {device}")
    if item_factors.shape[0] > 1 << 30:
        raise ValueError("the K1 kernel takes at most 2**30 items")
    for name, t in (("user_factors", user_factors), ("item_factors", item_factors),
                    ("seen_mask", seen_mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    lib = load_library()
    B, K = user_factors.shape
    I = item_factors.shape[0]
    vals = torch.empty((B, k), dtype=torch.float32, device=device)
    ids = torch.empty((B, k), dtype=torch.int64, device=device)
    if B == 0:
        return vals, ids
    wide = k > MAX_K
    sms = _sm_count(device.index)
    if wide:
        plan = wide_plan(B, I, k, sms)
    else:
        plan = fused_plan(B, I, k, sms, aligned_route(user_factors, item_factors))
    stream = stream_handle(device)
    part = _scratch(device, stream, plan.scratch_bytes) if plan.scratch_bytes else None
    with on_device(device):
        if wide:
            code = lib.ganmf_masked_topk_wide(
                user_factors.data_ptr(), item_factors.data_ptr(), seen_mask.data_ptr(),
                vals.data_ptr(), ids.data_ptr(), part.data_ptr(), B, I, K, k, plan.tile,
                plan.chunk_rows, stream)
        else:
            code = lib.ganmf_masked_topk(
                user_factors.data_ptr(), item_factors.data_ptr(), seen_mask.data_ptr(),
                vals.data_ptr(), ids.data_ptr(), part.data_ptr() if part is not None else None,
                B, I, K, k, plan.tiles_per_split, plan.splits, int(plan.aligned), stream)
    check(lib, code, "K1 masked_topk wide launch" if wide else "K1 masked_topk launch")
    count("k1.launches")
    if wide:
        count("k1.wide_launches")
    else:
        LAST_SPLITS = plan.splits
        if plan.aligned:
            count("k1.aligned_launches")
        if plan.splits > 1:
            count("k1.merge_launches")
    return vals, ids
