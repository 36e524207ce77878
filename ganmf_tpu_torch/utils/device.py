"""Device choice and float32 matmul precision for the whole port.

The reference scores and ranks at ``Precision.HIGHEST``
(ganmf_tpu/models/ganmf.py:358, ganmf_tpu/eval/evaluator.py:39). On an H100 a
float32 matmul may run in TF32, which keeps about three decimal digits, and a
float32 convolution does so by default. Both are switched off here, when the
package is imported, so that no TF32 reaches scoring or ranking. So is the
reduced-precision reduction of bf16 products, which cuBLAS may otherwise sum
in bf16: a bf16 product's partial sums stay float32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def as_device(device=None) -> torch.device:
    """``device`` as a torch.device with its index filled in, so that it
    compares equal to the ``.device`` of the tensors placed on it. None means
    the card (``cuda_device``), which raises when there is none: the entry
    points run on the CPU only when the caller asks for it."""
    if device is None:
        return cuda_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def cuda_device() -> torch.device:
    """The current CUDA device. Raises when there is none: the device path
    never goes on on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", torch.cuda.current_device())
