"""Scoring and masked top-k (K1).

Port of ``masked_topk_scores`` (ganmf_tpu/ops/pallas_scorer.py:173-234). The
serving path of every factor model is ``top_k(mask(U_b @ V^T))``, at any k
in [1, I]. On a CUDA tensor the wrapper launches the hand-written Hopper
kernels of csrc/masked_topk.cu, chosen from k alone: for k <= ``MAX_K`` the
fused kernel, which streams item tiles through shared memory and never
writes the [B, I] score matrix; above it the wide pair, which writes each
row's scores as sort keys into a scratch buffer of at most
``WIDE_SCRATCH_BYTES`` and sorts them. On a CPU tensor it takes the plain
version, ``masked_topk_scores_reference``: that is the tests' case, and the
kernels are compared with it on the card.

``masked_topk_matmul`` and ``split_bf16_planes`` are plain XLA in the JAX
package (docstring :83-93); they belong to the similarity family and are not
ported yet.
"""

from __future__ import annotations

import torch

from ganmf_tpu_torch.ops.topk import topk_lowest_index

#: Kernel launches since the last reset; incremented only where the wrapper
#: launches K1 (either form), so a run can show that its main path went
#: through the kernel.
LAUNCHES = 0

#: Launches of K1's wide pair (k > MAX_K) since the last reset.
WIDE_LAUNCHES = 0

#: Largest k of the fused kernel (the largest ranking cutoff is 50).
MAX_K = 64

#: Largest scratch buffer of the wide pair; rows are ranked in chunks that fit.
WIDE_SCRATCH_BYTES = 256 << 20

#: Largest factor width the kernel takes (its rows stay in shared memory).
MAX_FACTORS = 4096


def masked_topk_scores_reference(user_factors, item_factors, seen_mask, k: int):
    """The plain version: full f32 matmul, masked entries to -inf, then a
    top-k with ties to the lowest item id."""
    scores = torch.matmul(user_factors, item_factors.T)
    scores = scores.masked_fill(seen_mask, float("-inf"))
    return topk_lowest_index(scores, k)


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


def masked_topk_scores(user_factors, item_factors, seen_mask, k: int):
    """Top-k of ``U @ V^T`` with ``seen_mask`` entries excluded.

    user_factors [B, K] f32, item_factors [I, K] f32, seen_mask [B, I] bool
    (True = exclude), 1 <= k <= I. Returns (vals [B, k] f32, ids [B, k]
    int64), best first, ties to the lowest item id. A row with fewer than k
    unmasked items has -inf in its tail; the ids there are real items but
    unspecified."""
    global LAUNCHES, WIDE_LAUNCHES
    _check(user_factors, item_factors, seen_mask, k)
    device = user_factors.device
    if device.type == "cpu":
        return masked_topk_scores_reference(user_factors, item_factors, seen_mask, k)
    if device.type != "cuda":
        raise ValueError(f"masked_topk_scores runs on CPU or CUDA tensors, not {device}")
    if user_factors.shape[1] > MAX_FACTORS:
        raise ValueError(f"the K1 kernel takes at most {MAX_FACTORS} factors")
    if item_factors.shape[0] > 1 << 30:
        raise ValueError("the K1 kernel takes at most 2**30 items")
    for name, t in (("user_factors", user_factors), ("item_factors", item_factors),
                    ("seen_mask", seen_mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    from ganmf_tpu_torch.ops._build import check, load_library

    lib = load_library()
    B, K = user_factors.shape
    I = item_factors.shape[0]
    vals = torch.empty((B, k), dtype=torch.float32, device=device)
    ids = torch.empty((B, k), dtype=torch.int64, device=device)
    if B == 0:
        return vals, ids
    wide = k > MAX_K
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if wide:
            N = 1 << (I - 1).bit_length()  # the row's keys, padded to a power of two
            chunk_rows = max(1, min(B, WIDE_SCRATCH_BYTES // (8 * N)))
            scratch = torch.empty((chunk_rows, N), dtype=torch.int64, device=device)
            code = lib.ganmf_masked_topk_wide(
                user_factors.data_ptr(), item_factors.data_ptr(), seen_mask.data_ptr(),
                vals.data_ptr(), ids.data_ptr(), scratch.data_ptr(), B, I, K, k, N,
                chunk_rows, stream)
        else:
            code = lib.ganmf_masked_topk(
                user_factors.data_ptr(), item_factors.data_ptr(), seen_mask.data_ptr(),
                vals.data_ptr(), ids.data_ptr(), B, I, K, k, stream)
    check(lib, code, "K1 masked_topk wide launch" if wide else "K1 masked_topk launch")
    LAUNCHES += 1
    if wide:
        WIDE_LAUNCHES += 1
    return vals, ids
