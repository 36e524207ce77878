"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, and the result line.

``run_cell`` is what ``run.py`` calls on the card; the tests call it on the
CPU at small sizes (``overrides``), with a planted fault or the control.
"""

from __future__ import annotations

import gc
import json
import math
import resource
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from benchmark import judge
from benchmark.registry import Cell, Registry
from benchmark.trace import Tracer

#: the precision one step below the one a configuration states: float32
#: with TF32 off becomes TF32
CONTROL_PRECISION = {"f32": "tf32"}


@dataclass
class Outcome:
    """What a driver hands back after its window."""

    e2e: Dict[str, float]  # end-to-end metric values by name, setup_s aside
    attempted: int
    failed: int
    numbers: Dict[str, float]  # the compared numbers, by name
    layer: Dict[str, float] = field(default_factory=dict)  # what the per-layer readers read


class HostWatch:
    """What the host did for this process from the window's start: wall,
    process and thread CPU seconds, context switches (involuntary ones mean
    the host took the core away) and the seconds in Python's collector, by
    generation. For reading on standard error only."""

    def __init__(self):
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]
        self._t = None
        self.wall, self.cpu, self.thread = time.perf_counter(), time.process_time(), time.thread_time()
        self.ru = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._gc)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._t
            self.gc_n[g] += 1
            self._t = None

    def close(self) -> str:
        gc.callbacks.remove(self._gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return (f"host since the window opened: wall {time.perf_counter() - self.wall:.3f} s, "
                f"process CPU {time.process_time() - self.cpu:.3f} s, thread CPU {time.thread_time() - self.thread:.3f} s, "
                f"switches {ru.ru_nvcsw - self.ru.ru_nvcsw} voluntary / {ru.ru_nivcsw - self.ru.ru_nivcsw} involuntary, "
                f"collector {sum(self.gc_s):.3f} s in {self.gc_n} runs by generation "
                f"({', '.join(f'{x:.3f}' for x in self.gc_s)} s)")


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    device: torch.device
    tracer: Tracer
    t0: float
    control: bool = False
    setup_s: Optional[float] = None
    memory_peak_bytes: int = 0
    _host: Optional[HostWatch] = None

    @property
    def model_seed(self) -> int:
        """The seed handed to the program's model (its shuffle and its
        initial tensors), inside 31 bits as numpy's RandomState needs."""
        return self.seed % (1 << 31)

    @property
    def precision(self) -> str:
        p = self.cell.config["precision"]
        return CONTROL_PRECISION[p] if self.control else p

    def mark(self, what: str) -> None:
        """A line on standard error with the seconds since the run began."""
        log(f"[{time.perf_counter() - self.t0:9.3f} s @ {time.time():.3f}] {what}")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        """Called once the benchmark's own inputs are made, so that the peak
        is the program's."""
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def setup_done(self) -> None:
        """Called just before the window's first timed operation."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t0
        self.mark("set-up done; the window opens")
        self._host = HostWatch()

    def window_closed(self) -> None:
        self.sync()
        self.mark("the window closed")
        if self._host is not None:
            self.mark(self._host.close())
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(reg: Registry, name: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float, control: bool = False, overrides: Optional[dict] = None) -> dict:
    cell = reg.cell(name)
    if overrides:
        cell.config = _merge(cell.config, overrides.get("config", {}))
        cell.traffic = _merge(cell.traffic, overrides.get("traffic", {}))
        cell.limits = dict(cell.limits, **overrides.get("limits", {}))
    run = Run(cell, int(seed), float(seconds), device, Tracer(trace, device), t0, control)
    run.mark(f"{name} seed {seed}: started on {device}")
    out: Outcome = reg.driver(cell).run(run)
    run.mark("the comparison ended")
    correct = judge.verdict(out.numbers, cell.limits, out.failed)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": {}, "device": dev}
    if trace:
        summary = run.tracer.summary
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        ctx = dict(out.layer, trace=summary)
        for m in cell.per_layer:
            value = reg.reader(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = summary.breakdown()
    else:
        values = dict(out.e2e, setup_s=run.setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["check"] = {k: {"value": out.numbers.get(k, math.nan), "limit": lim} for k, lim in cell.limits.items()}
    return result


def check_lines(result: dict):
    """The compared numbers beside their limits, one line each."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in result["check"].items()]


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def dumps(result: dict) -> str:
    """The result as one JSON line; a number that is not finite is null."""
    return json.dumps(_finite(result), allow_nan=False)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
