"""The traced window: ``torch.profiler`` over CPU and CUDA, and what the
per-layer readers and the breakdown take from it.

The harness names its calls into the program with ``record_function`` spans
(``bench.<call>``) while a trace runs; without a trace no profiler is
attached and ``span`` costs nothing. ``Summary`` holds the window's device
intervals (kernels, copies and sets), the kernel count and time by name,
and the device's idle gaps, each named by the harness span and the
outermost host operation that were running when the gap began.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10


@dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: int = 0
    device_ops: Dict[str, float] = field(default_factory=dict)  # seconds by name
    idle_gaps: Dict[str, float] = field(default_factory=dict)  # seconds by what the host was doing

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose names contain any of ``names``."""
        return sum(s for n, s in self.device_ops.items() if any(k in n for k in names))

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}


class Tracer:
    """Starts and stops the profiler around the traced windows; inert when
    ``enabled`` is false.

    A traced run has two phases of the same length. The ``device`` phase
    records the card's activity alone, so that the host runs at its
    untraced pace and the busy share, the kernels and their times are the
    program's; its window is the host clock's, synchronized at both ends.
    The ``host`` phase records the host's operations and the harness's spans
    too, which slows the host, and only names the device's idle gaps."""

    PHASES = ("device", "host")

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled, self.device = bool(enabled), device
        self.active = None  # the phase being traced
        self.summary: Optional[Summary] = None
        self._prof = self._window = None
        self._edges = None

    def phases(self):
        return self.PHASES if self.enabled else ()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, phase: str) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU] if phase == "host" or self.device.type != "cuda" else []
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._sync()
        if phase == "host":
            self._window = torch.profiler.record_function(WINDOW_SPAN)
            self._window.__enter__()
        self._edges = [time.time_ns()]
        self.active = phase

    def stop(self) -> None:
        self._sync()
        self._edges.append(time.time_ns())
        if self.active == "host":
            self._window.__exit__(None, None, None)
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        if self.active == "device":
            self.summary = summarize(events, tuple(self._edges))
        else:
            self.summary.idle_gaps = summarize(events).idle_gaps
        self.active = self._prof = None

    def span(self, name: str):
        """A ``bench.<name>`` span in the host phase, else nothing."""
        return torch.profiler.record_function(f"bench.{name}") if self.active == "host" else contextlib.nullcontext()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _outermost(intervals: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """The intervals that no earlier one contains, by start."""
    out = []
    for s, e, n in sorted(intervals):
        if out and e <= out[-1][1]:
            continue
        out.append((s, e, n))
    return out


def _kind(ev) -> str:
    """The event's kind, told from its device and its name (the installed
    PyTorch's kineto events do not name their activity type)."""
    name = ev.name()
    annotation = getattr(ev, "is_user_annotation", lambda: False)() or name.startswith("bench.")
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        if annotation:
            return "gpu_user_annotation"
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    return "user_annotation" if annotation else "cpu_op"


def summarize(events, edges: Optional[Tuple[int, int]] = None) -> Summary:
    """The summary of a window: between ``edges`` (host clock, ns), or
    within the harness's ``bench.window`` span."""
    ws, we = edges if edges else (None, None)
    device, host, spans = [], [], []
    for ev in events:
        kind = _kind(ev)
        s, e = ev.start_ns(), ev.end_ns()
        if kind == "user_annotation":
            if ev.name() == WINDOW_SPAN and not edges:
                ws, we = s, e
            elif ev.name().startswith("bench."):
                spans.append((s, e, ev.name()))
        elif kind in DEVICE_ACTIVITIES:
            device.append((s, e, ev.name(), kind))
        elif kind in HOST_OPS:
            host.append((s, e, ev.name()))
    if ws is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    sm = Summary(window_s=(we - ws) / 1e9)
    ops: Dict[str, float] = defaultdict(float)
    clipped = []
    for s, e, name, kind in device:
        s, e = max(s, ws), min(e, we)
        if e <= s:
            continue
        clipped.append((s, e))
        ops[name[:120]] += (e - s) / 1e9
        sm.kernels += kind == "kernel"
    busy = _union(clipped)
    sm.busy_s = sum(e - s for s, e in busy) / 1e9
    sm.device_ops = dict(ops)

    tops = _outermost([h for h in host if h[1] > ws and h[0] < we])
    top_starts = [t[0] for t in tops]
    inner_spans = sorted(spans)
    span_starts = [t[0] for t in inner_spans]
    gaps: Dict[str, float] = defaultdict(float)
    cuts = [ws] + [x for iv in busy for x in iv] + [we]
    for i in range(0, len(cuts), 2):
        g0, g1 = cuts[i], cuts[i + 1]
        if g1 <= g0:
            continue
        span = _span_at(inner_spans, span_starts, g0) or "bench.window"
        op = _op_at(tops, top_starts, g0) or "python"
        gaps[f"{span} / {op}"] += (g1 - g0) / 1e9
    sm.idle_gaps = dict(gaps)
    return sm


def _op_at(tops, starts, t) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and tops[i][0] <= t < tops[i][1]:
        return tops[i][2]
    return None


def _span_at(spans, starts, t) -> Optional[str]:
    """The ``bench.`` span that covers ``t`` (the harness's spans follow one
    another and do not nest)."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t < spans[i][1]:
        return spans[i][2]
    return None
