"""A third traced phase, ``program``: the card's idle time named by the
program's own spans.

    python3 benchmark/program_trace.py --workload <cell> --seed <n> --seconds <s>

runs a cell as ``run.py --trace 1`` does, with a phase between ``device``
and ``host`` that traces the same units again: the profiler records the
card's activity alone, and the program's recorder
(``ganmf_tpu_torch.utils.profiling.recording``) keeps its spans in memory on
the same clock. The ``device`` and ``host`` phases run as they do in
``run.py``, with the recorder off. The sweep gives each idle nanosecond of
the window to the innermost program span open at that instant ("outside"
where none is), split at span edges. The result line gains ``program``: the
idle by span, the share of the idle under a named span, the host syncs per
unit, and the readings of the idle metrics that a reader of this phase would
give. Standard error gets a table: for each span name its count, median
wall, self time (wall less its children's) and the idle under it; and each
counter's change per unit.
"""

from __future__ import annotations

import bisect
import statistics
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, run  # noqa: E402
from benchmark.trace import DEVICE_ACTIVITIES, Tracer, _kind, _union  # noqa: E402

OUTSIDE = "outside"
#: the root span of each cell's unit of work
ROOTS = ("train.epoch", "eval.evaluate", "serve.recommend")
#: the idle readings this phase gives: name -> (root, spans whose idle counts)
IDLE_SHARES = {
    "train.idle_in_grad": ("train.epoch", ("train.grad",)),
    "train.idle_in_update": ("train.epoch", ("train.update",)),
    "eval.idle_in_prep": ("eval.evaluate", ("eval.order", "eval.prep")),
    "eval.idle_in_metrics": ("eval.evaluate", ("eval.metrics",)),
}


@dataclass
class ProgramSummary:
    """The ``program`` phase of a traced run. Times in ns on the clock of the
    profiler's events; ``spans`` as ``profiling.drain`` returns them."""

    window: Tuple[int, int]
    busy: List[Tuple[int, int]]  # the union of the card's intervals, in the window
    spans: list
    counters: Dict[str, int]
    idle_by_span: Dict[str, float] = field(init=False)  # seconds, by the innermost span

    def __post_init__(self):
        self.idle_by_span = sweep(self.window, self.busy, self.spans)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def idle_s(self) -> float:
        return sum(self.idle_by_span.values())

    def root(self) -> Optional[str]:
        """The root span of the phase's units, or None without one."""
        names = {s.name for s in self.spans if s.parent == -1}
        return next((r for r in ROOTS if r in names), None)

    def units(self) -> int:
        root = self.root()
        return sum(1 for s in self.spans if s.parent == -1 and s.name == root)

    def named_share(self) -> Optional[float]:
        """The share of the idle time under a program span, %."""
        idle = self.idle_s
        return 100.0 * (1.0 - self.idle_by_span.get(OUTSIDE, 0.0) / idle) if idle > 0 else None

    def idle_share(self, names) -> Optional[float]:
        """The idle under ``names`` (innermost), % of the window."""
        if not self.spans or self.window_s <= 0:
            return None
        return 100.0 * sum(self.idle_by_span.get(n, 0.0) for n in names) / self.window_s

    def idle_in_call_us(self, root: str) -> Optional[float]:
        """The median over the ``root`` spans of the card's idle time inside
        each, us."""
        idle = _complement(self.window, self.busy)
        starts = [a for a, _ in idle]
        per = [_overlap(idle, starts, s.start_ns, s.end_ns) / 1e3
               for s in self.spans if s.parent == -1 and s.name == root]
        return statistics.median(per) if per else None

    def per_unit(self) -> Dict[str, float]:
        """Each counter's change over the phase, per unit."""
        n = self.units()
        return {k: v / n for k, v in sorted(self.counters.items())} if n else {}

    def host_syncs_per_unit(self) -> Optional[float]:
        n = self.units()
        if not n:
            return None
        return sum(v for k, v in self.counters.items() if k.startswith("host_sync.")) / n

    def readings(self) -> dict:
        """What readers of this phase would give, by metric name, and the
        idle by span."""
        root = self.root()
        out = {"units": self.units(), "window_s": self.window_s, "idle_s": self.idle_s,
               "idle_named_share": self.named_share(), "host_syncs_per_unit": self.host_syncs_per_unit(),
               "idle_by_span": dict(sorted(self.idle_by_span.items(), key=lambda kv: -kv[1]))}
        for name, (r, names) in IDLE_SHARES.items():
            if r == root:
                out[name] = self.idle_share(names)
        if root == "serve.recommend":
            out["serve.idle_in_call_us"] = self.idle_in_call_us(root)
        return out

    def table(self) -> List[str]:
        """For each span name: count, median wall, self time, idle under it
        (innermost); then each counter per unit."""
        walls, selfs = defaultdict(list), defaultdict(float)
        child = defaultdict(int)
        for s in self.spans:
            if s.parent >= 0:
                child[s.parent] += s.end_ns - s.start_ns
        for i, s in enumerate(self.spans):
            walls[s.name].append(s.end_ns - s.start_ns)
            selfs[s.name] += s.end_ns - s.start_ns - child[i]
        lines = [f"program phase: {self.units()} units, window {self.window_s:.6f} s, idle {self.idle_s:.6f} s, "
                 f"{self.named_share()}% of it under a named span",
                 f"{'span':<20} {'count':>8} {'median wall us':>15} {'self s':>12} {'idle s':>12}"]
        for name in sorted(walls, key=lambda n: -selfs[n]):
            lines.append(f"{name:<20} {len(walls[name]):>8} {statistics.median(walls[name]) / 1e3:>15.3f} "
                         f"{selfs[name] / 1e9:>12.6f} {self.idle_by_span.get(name, 0.0):>12.6f}")
        lines.append(f"{OUTSIDE:<20} {'':>8} {'':>15} {'':>12} {self.idle_by_span.get(OUTSIDE, 0.0):>12.6f}")
        lines += [f"counter {k}: {v!r} per unit" for k, v in self.per_unit().items()]
        return lines


def _complement(window, busy) -> List[Tuple[int, int]]:
    """The idle intervals: the window less the (sorted, disjoint) busy ones."""
    out, t = [], window[0]
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < window[1]:
        out.append((t, window[1]))
    return out


def _overlap(intervals, starts, a: int, b: int) -> int:
    """ns of the sorted, disjoint ``intervals`` inside [a, b)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0
    while i < len(intervals) and intervals[i][0] < b:
        lo, hi = max(intervals[i][0], a), min(intervals[i][1], b)
        total += max(0, hi - lo)
        i += 1
    return total


def sweep(window, busy, spans) -> Dict[str, float]:
    """Seconds of the window's idle time by the innermost span open at each
    instant (``OUTSIDE`` where none is), split at span edges. The spans nest
    as one thread's do."""
    ws, we = window
    edges = []  # (time, 0 = end | 1 = start, order, index): ends before starts, children closed first
    for i, s in enumerate(spans):
        a, b = max(s.start_ns, ws), min(s.end_ns, we)
        if b > a:
            edges.append((a, 1, i, i))
            edges.append((b, 0, -i, i))
    edges.sort()
    idle = _complement(window, busy)
    out: Dict[str, float] = defaultdict(float)
    open_: List[int] = []
    t, k = ws, 0
    for when, kind, _, i in edges + [(we, 0, 0, -1)]:
        if when > t:
            name = spans[open_[-1]].name if open_ else OUTSIDE
            # the idle of [t, when): walk the idle intervals that reach into it
            while k < len(idle) and idle[k][1] <= t:
                k += 1
            j = k
            while j < len(idle) and idle[j][0] < when:
                out[name] += max(0, min(idle[j][1], when) - max(idle[j][0], t))
                j += 1
            t = when
        if i < 0:
            break
        if kind == 1:
            open_.append(i)
        elif i in open_:
            open_.remove(i)
    return {n: v / 1e9 for n, v in out.items() if v > 0}


class ProgramTracer(Tracer):
    """The harness's tracer with the ``program`` phase between its two."""

    PHASES = ("device", "program", "host")

    def __init__(self, enabled: bool, device: torch.device):
        super().__init__(enabled, device)
        self._recording = None

    def start(self, phase: str) -> None:
        super().start(phase)
        if phase == "program":
            from ganmf_tpu_torch.utils import profiling

            self._recording = profiling.recording()
            self._recording.__enter__()

    def stop(self) -> None:
        if self.active != "program":
            super().stop()
            return
        from ganmf_tpu_torch.utils import profiling

        self._sync()
        self._edges.append(time.time_ns())
        self._recording.__exit__(None, None, None)
        self._prof.stop()
        spans, changed = profiling.drain()
        ws, we = self._edges
        device = []
        for ev in self._prof.profiler.kineto_results.events():
            if _kind(ev) in DEVICE_ACTIVITIES:
                a, b = max(ev.start_ns(), ws), min(ev.end_ns(), we)
                if b > a:
                    device.append((a, b))
        self.summary.program = ProgramSummary((ws, we), _union(device), spans, changed)
        self.active = self._prof = self._recording = None


def run_cell(reg, name: str, seed: int, seconds: float, device: torch.device, t0: float, **kwargs):
    """(the result of a traced run of the cell with the ``program`` phase,
    its ``ProgramSummary``)."""
    made = []

    def tracer(enabled, dev):
        made.append(ProgramTracer(enabled, dev))
        return made[-1]

    saved = harness.Tracer
    harness.Tracer = tracer
    try:
        result = harness.run_cell(reg, name, seed, seconds, True, device, t0, **kwargs)
    finally:
        harness.Tracer = saved
    program = made[0].summary.program
    result["program"] = program.readings()
    return result, program


def main(argv=None) -> int:
    import argparse

    from benchmark.registry import Registry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("the program phase traces a CUDA device; found none")
        return 2
    run._caches()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, program = run_cell(Registry(), args.workload, args.seed, args.seconds, device, run.T0)
    bad = run.forbidden_modules()
    if bad:
        harness.log(f"the run loaded {', '.join(bad)}; the benchmark measures the port alone")
        return 3
    from ganmf_tpu_torch.utils import profiling

    for line in program.table():
        harness.log(line)
    harness.log(f"kernels.nvcc_builds over the run: {profiling.counters().get('kernels.nvcc_builds', 0)}")
    print(harness.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
