"""Plain top-k with the reference's tie order.

``lax.top_k`` and ``tiled_topk`` (ganmf_tpu/ops/topk.py:25-44) give ties to
the lowest index, and the ranked lists depend on that. ``torch.topk``
promises no tie order, so the plain paths rank with a stable descending sort.
"""

from __future__ import annotations

import torch


def topk_lowest_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, ties to
    the lowest index; indices are int64."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()
