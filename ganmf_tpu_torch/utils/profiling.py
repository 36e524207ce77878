"""Spans, counters and traces of the port (port of ganmf_tpu/utils/profiling.py).

``span(name)`` marks one part of the work. With recording off, the default,
it returns one shared no-op context after a single flag check. Inside
``recording()`` each span is kept in memory: its name, its start and end on
the clock of the profiler's events (``time.time_ns``, the Unix clock that
kineto's ``start_ns`` reads, on the CPU and the card alike), its parent and
its root, one call of a layer, whose id every span under it shares.
``recording(annotate=True)`` also enters each span as a
``torch.profiler.record_function``, so that it nests over its kernels in a
Chrome trace; ``device_trace`` writes such a trace. ``drain()`` hands back
the spans and the counters' changes since recording began. Spans are kept
for one thread: the port runs its paths on one.

Counters are always on (a dict add): ``count(name, n)`` adds, ``counters()``
reads them all. Their names:

- ``k1.launches``: K1 launches, either form (ops/scorer.py), so that a run
  shows that its main path went through the kernel; ``k1.wide_launches``,
  those of the wide pair (k > ``MAX_K``); ``k1.merge_launches``, the fused
  kernel's merge passes (a launch with more than one item split);
- ``k2.launches`` (ops/select.py) and ``keyed.launches`` (ops/keyed.py);
- ``cfgan.minibatches``: CFGAN's D and G minibatches run (models/cfgan.py);
- ``kernels.nvcc_builds``: the kernel library built by nvcc rather than
  loaded from its cache (ops/_build.py);
- ``<root>.calls``: the calls of each root span that ``root`` opens
  (``train.epoch``, ``eval.evaluate``, ``serve.recommend``);
- ``eval.plan.builds``, ``eval.plan.hits``: evaluations that built their
  block plan and those that found it kept from an earlier evaluation of the
  same training matrix (eval/evaluator.py);
- ``host_sync.<site>``: each point of those paths where the host waits on
  the card, a blocking copy to the device (``to_device``) or a read back to
  the host (``to_host``). They count on any device, the CPU included, and
  leave out the one-time uploads of a fit's or an evaluator's set-up; the
  uploads of an evaluation's block plan count (``host_sync.eval.plan``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


class Span(NamedTuple):
    """One recorded span; ``parent`` and ``root`` index the list ``drain``
    returns (``parent`` is -1 for a root, whose ``root`` is itself)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int


_COUNTS: Dict[str, int] = {}
_RECORDING = False
_ANNOTATE = False
_SPANS: List[list] = []  # [name, start_ns, end_ns, parent, root] of each span entered
_OPEN: List[int] = []  # indices of the open spans, innermost last
_BASE: Dict[str, int] = {}  # the counters when recording began


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "i", "fn")

    def __init__(self, name: str):
        self.name = name
        self.fn = torch.profiler.record_function(name) if _ANNOTATE else None

    def __enter__(self):
        if self.fn is not None:
            self.fn.__enter__()
        self.i = i = len(_SPANS)
        parent = _OPEN[-1] if _OPEN else -1
        _SPANS.append([self.name, time.time_ns(), 0, parent, _SPANS[parent][4] if parent >= 0 else i])
        _OPEN.append(i)
        return self

    def __exit__(self, *exc):
        _SPANS[self.i][2] = time.time_ns()
        _OPEN.pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def span(name: str):
    """A context that records ``name`` while recording is on, else the
    shared no-op."""
    if not _RECORDING:
        return _NO_SPAN
    return _Span(name)


def root(name: str):
    """``span(name)`` for one call of a layer, its calls counted under
    ``<name>.calls`` whether recording is on or not."""
    count(name + ".calls")
    return span(name)


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


def to_device(array, device: torch.device, site: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``array`` (a numpy array or a CPU tensor) as a tensor on ``device``, of
    ``dtype`` if given: a blocking copy, counted under ``host_sync.<site>``."""
    count("host_sync." + site)
    return torch.as_tensor(array).to(device, dtype)


def to_host(tensor: torch.Tensor, site: str) -> torch.Tensor:
    """``tensor`` on the CPU: a read that waits for the card, counted under
    ``host_sync.<site>``."""
    count("host_sync." + site)
    return tensor.cpu()


@contextlib.contextmanager
def recording(annotate: bool = False):
    """Record spans in memory for the block (also as ``record_function``
    with ``annotate``); ``drain`` hands them back."""
    global _RECORDING, _ANNOTATE, _BASE
    if _RECORDING:
        raise RuntimeError("spans are being recorded already")
    _SPANS.clear()
    _OPEN.clear()
    _BASE = dict(_COUNTS)
    _RECORDING, _ANNOTATE = True, bool(annotate)
    try:
        yield
    finally:
        _RECORDING = _ANNOTATE = False


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """(the spans of the last recording in the order they were entered, each
    counter's change since it began); both are handed back once. Called once
    the recording has ended."""
    global _BASE
    if _RECORDING:
        raise RuntimeError("drain() is called once the recording has ended")
    spans = [Span(*s) for s in _SPANS]
    _SPANS.clear()
    changed = {k: v - _BASE.get(k, 0) for k, v in _COUNTS.items() if v != _BASE.get(k, 0)}
    _BASE = dict(_COUNTS)
    return spans, changed


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Trace the block into ``logdir``/trace.json (nothing for a falsy
    ``logdir``): the CPU's operations, the card's where there is one, and the
    program's spans over them. Yields the profiler, or None."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, recording(annotate=True):
        yield prof
    drain()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
