"""The plain reference: GANMF's training epoch, ranking and the holdout
metrics in plain PyTorch and NumPy, written from the model's and the
metrics' formulas. It imports nothing of the program, and works out again
whatever the program derives from the inputs (initial tensors, shuffles)."""

import torch


def set_tf32(on: bool) -> None:
    """Float32 products in TF32 (``on``) or in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    torch.backends.cudnn.allow_tf32 = bool(on)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to the nearest and
    ties to even: what a TF32 product does to its operands."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32).view(x.shape)
