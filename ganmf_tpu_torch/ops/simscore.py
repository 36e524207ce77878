"""Scoring and masked top-k for the similarity family.

Port of ``masked_topk_matmul`` (ganmf_tpu/ops/pallas_scorer.py:64-154).
The JAX package keeps it plain XLA on purpose (docstring :83-93: at a
catalog-sized contraction the matmul is the whole cost), so here it is a
float32 ``torch.matmul`` with TF32 off, the seen mask, and ``tiled_topk``. No
kernel of this repo is launched.

Not ported: JAX's bf16-plane form of the product (``split_bf16_planes``,
:157-170), which its models take from 20000 items on, a threshold set from a
TPU's matrix-unit rates; it waits for an H100 measurement (ROADMAP).
"""

from __future__ import annotations

import torch

from ganmf_tpu_torch.ops.topk import tiled_topk


def masked_topk_matmul(
    rows: torch.Tensor,  # [B, C] left operand (profile rows, or user-user W rows)
    W: torch.Tensor,  # [C, I] right operand (item-item W, or the dense URM)
    seen_mask,  # [B, I] bool, True = exclude; None with mask_from_rows
    pair_ids: torch.Tensor,  # [B, P] test item ids per row (0-padded)
    k: int,
    mask_from_rows: bool = False,
    use_approx: bool = False,
):
    """``top_k(mask(rows @ W))`` plus a test-pair probe (JAX :64-154).
    Returns (values [B, k], ids [B, k], pair_scores [B, P], pair_finite
    [B, P]): each row's masked score at its test items (0 where masked) and
    whether that score was finite, for the evaluator's RMSE.

    ``mask_from_rows`` masks the entries where the left operand, a user's
    training profile, is nonzero: the item-based seen set, without a second
    scatter. ``use_approx`` (JAX's ``approx_max_k``, which the evaluator never
    sets) is not ported and raises."""
    if use_approx:
        raise NotImplementedError("use_approx (approx_max_k ranking) is not ported")
    s = rows @ W
    if mask_from_rows:
        s = s.masked_fill(rows != 0, float("-inf"))
    if seen_mask is not None:
        s = s.masked_fill(seen_mask, float("-inf"))
    vals, idx = tiled_topk(s, k)
    ps = torch.gather(s, 1, pair_ids)
    fin = torch.isfinite(ps)
    return vals, idx, torch.where(fin, ps, 0.0), fin.float()
