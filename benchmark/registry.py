"""Finds everything of a cell by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names a module of
``drivers/``); the cell's own limits sit in ``workloads/<cell>.json``; each
per-layer metric is read by ``layer_metrics/<metric>.py`` in the cells its
``workloads`` lists. Adding a cell or a metric adds files and an entry;
nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the cell's entries of end_to_end
    per_layer: List[dict]  # the cell's entries of per_layer


class Registry:
    def __init__(self, bench_json: Optional[Path] = None, base: Path = HERE):
        self.base = Path(base)
        self.spec = _load(Path(bench_json) if bench_json else ROOT / "BENCHMARK.json")

    def _config_entry(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> Cell:
        w = self.workload(name)
        c = self._config_entry(w["config"])
        config = _load(self.base.parent / c["file"])
        traffic = _load(self.base / "traffic" / f"{w['traffic']}.json")
        limits = _load(self.base / "workloads" / f"{name}.json")["limits"]
        e2e = [m for m in self.spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]
        layer = [m for m in self.spec["per_layer"] if name in m["workloads"]]
        return Cell(name, int(w["chips"]), w["config"], config, w["traffic"], traffic, limits, e2e, layer)

    def driver(self, cell: Cell):
        return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")

    def reader(self, metric: str):
        """The module of ``layer_metrics/<metric>.py``; it defines
        ``read(ctx)``, which returns the value or None."""
        path = self.base / "layer_metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark.layer_metrics.{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
