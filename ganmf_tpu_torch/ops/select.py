"""Exact-k row selection (K2).

Port of ``smallest_k_mask_pallas`` (ganmf_tpu/ops/pallas_select.py:80-112):
per row, a bool mask of the ``k[r]`` smallest float32 keys, ties to the lowest
column. ``smallest_k_mask_cuda`` launches the hand-written Hopper kernel
(csrc/select.cu), a radix select over the monotone uint32 image of the key
bits. Any k is taken, as the JAX function takes it: a row with k[r] <= 0 is
all false, one with k[r] >= I all true. The wrapper never synchronizes the
host. The dispatching entry point and the plain version are
``ops.topk.smallest_k_mask`` and ``ops.topk.smallest_k_mask_reference``.
"""

from __future__ import annotations

import torch

from ganmf_tpu_torch.ops._build import check, load_library, on_device, stream_handle
from ganmf_tpu_torch.utils.profiling import count

#: Widest row the kernel takes (its histograms hold 16-bit counts, 8 per bin).
MAX_COLS = 8 * 0xFFFF


def check_select_args(keys: torch.Tensor, k: torch.Tensor) -> None:
    """Raise unless keys is [R, I] float32 and k is [R] int32 or int64 on the
    same device. Only shapes, types and devices are checked, on the host:
    the values of k are not read."""
    if keys.dim() != 2 or k.dim() != 1 or k.shape[0] != keys.shape[0]:
        raise ValueError(f"keys must be [R, I] and k [R], got {tuple(keys.shape)} and {tuple(k.shape)}")
    if keys.dtype != torch.float32:
        raise TypeError(f"keys must be float32, got {keys.dtype}")
    if k.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"k must be int32 or int64, got {k.dtype}")
    if keys.device != k.device:
        raise ValueError(f"keys on {keys.device}, k on {k.device}")


def smallest_k_mask_cuda(keys: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Launch K2 on CUDA tensors: keys [R, I] float32 (contiguous), k [R]
    int32 or int64 (any values: clamped to [0, I] per row). Returns a bool
    [R, I] mask. Raises on anything else, and when the launch fails."""
    check_select_args(keys, k)
    if keys.device.type != "cuda":
        raise ValueError(f"smallest_k_mask_cuda takes CUDA tensors, not {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if keys.shape[1] > MAX_COLS:
        raise ValueError(f"the K2 kernel takes rows of at most {MAX_COLS} keys")
    R, I = keys.shape
    out = torch.empty((R, I), dtype=torch.bool, device=keys.device)
    if R == 0 or I == 0:
        return out
    k = k.contiguous()  # the kernel reads int32 or int64 k as it is

    lib = load_library()
    with on_device(keys.device):
        stream = stream_handle(keys.device)
        code = lib.ganmf_smallest_k_mask(keys.data_ptr(), k.data_ptr(), k.dtype == torch.int64,
                                         out.data_ptr(), R, I, stream)
    check(lib, code, "K2 smallest_k_mask launch")
    count("k2.launches")
    return out
