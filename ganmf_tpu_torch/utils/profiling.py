"""Profiling hooks (port of ganmf_tpu/utils/profiling.py).

``device_trace`` records a ``torch.profiler`` trace of the CPU and, where
there is one, the CUDA card, and writes it as a Chrome trace (viewable in
Perfetto or chrome://tracing); ``EpochTimer`` times epochs on the host clock
after synchronizing the card, so that a time is the work's and not its
enqueue's; ``annotate`` names a region of a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Trace the block into ``logdir``/trace.json (nothing for a falsy
    ``logdir``). Yields the profiler, or None."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class EpochTimer:
    """Per-epoch wall times, each taken after the card has finished."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        """The epoch's seconds. ``sync_on`` is taken for the JAX package's
        signature; the whole card is synchronized."""
        self._sync()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0


def annotate(name: str):
    """A named region of a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
