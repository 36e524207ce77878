"""Plain top-k with the reference's tie order, and exact-k row selection.

``lax.top_k`` and ``tiled_topk`` (ganmf_tpu/ops/topk.py:25-44) give ties to
the lowest index, and the ranked lists depend on that. ``torch.topk``
promises no tie order, so the plain paths rank with a stable descending sort.

``smallest_k_mask`` (ganmf_tpu/ops/topk.py:62-104) selects each row's k[r]
smallest keys, ties to the lowest column: CFGAN's negative-mask draws run it
over the whole training matrix every epoch.
"""

from __future__ import annotations

import torch

from ganmf_tpu_torch.ops.select import check_select_args, smallest_k_mask_cuda


def topk_lowest_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, ties to
    the lowest index; indices are int64."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def monotone_key_image(keys: torch.Tensor) -> torch.Tensor:
    """int64 image of float32 keys that orders as the JAX package's monotone
    uint32 map of the key bits (ganmf_tpu/ops/topk.py:88-89): +inf above every
    finite key, -0.0 below +0.0. Comparing the floats would tie the zeros."""
    bits = keys.contiguous().view(torch.int32).to(torch.int64)
    unsigned = bits & 0xFFFFFFFF
    return torch.where(bits < 0, 0xFFFFFFFF - unsigned, unsigned | 0x80000000)


def smallest_k_mask_reference(keys: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The plain version: the stable rank table ``rank(image) < k[r]``, where
    the rank is taken by a stable sort of the monotone image."""
    order = torch.sort(monotone_key_image(keys), dim=1, stable=True).indices
    cols = torch.arange(keys.shape[1], device=keys.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(1, order, cols)
    return rank < k.to(torch.int64)[:, None]


def smallest_k_mask(keys: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Bool mask of each row's ``k[r]`` smallest keys, ties to the lowest
    column; rows with k = 0 are all false. keys [R, I] float32, k [R] int32
    or int64. On CUDA tensors it launches K2 (ops/select.py) at every width;
    on CPU tensors it takes the plain version."""
    if keys.device.type == "cpu":
        check_select_args(keys, k)
        return smallest_k_mask_reference(keys, k)
    return smallest_k_mask_cuda(keys, k)
