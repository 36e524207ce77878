"""Opt-in NaN checks (port of ganmf_tpu/utils/debug.py).

``GANMF_TPU_DEBUG=1`` makes the GAN epochs (GANMF, DisGANMF, CFGAN, CAAE)
check every step's loss and updated tensors and the evaluator check every
block's scores: a NaN raises ``FloatingPointError`` at the step that produced
it, naming the step and the tensors, where the JAX package re-runs its jitted
epochs under checkify's float checks. The flag is read at call time, so it
can be flipped between calls. With it off the checks are skipped and cost no
host read.
"""

from __future__ import annotations

import os

import torch


def debug_enabled() -> bool:
    """True when ``GANMF_TPU_DEBUG`` is set to anything but 0, false or off."""
    return os.environ.get("GANMF_TPU_DEBUG", "0").lower() not in ("0", "", "false", "off")


def raise_on_nan(what: str, **tensors: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` when any of ``tensors`` holds a NaN,
    naming ``what`` and the tensors at fault. One host read."""
    flags = torch.stack([torch.isnan(t.detach()).any() for t in tensors.values()]).cpu()
    bad = [name for name, flag in zip(tensors, flags.tolist()) if flag]
    if bad:
        raise FloatingPointError(f"NaN in {what}: {', '.join(bad)} (GANMF_TPU_DEBUG=1)")
