"""Structured experiment logging.

A copy of ganmf_tpu/utils/logging.py, which is framework-free.

The reference logs with bare prints and ad-hoc results.txt appends
(SURVEY §5.5). Here every training run can attach a MetricsLogger that
writes one JSON record per event to a .jsonl sink (epoch losses, eval
results, timings), while the reference-compatible text artifacts are still
produced by the CLIs.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, run_name: str = "", echo: bool = False):
        self.path = path
        self.run_name = run_name
        self.echo = echo
        self._start = time.time()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        record = {
            "t": round(time.time() - self._start, 4),
            "run": self.run_name,
            "event": event,
            **fields,
        }
        if self.path:
            with open(self.path, "a") as fh:
                fh.write(json.dumps(record, default=float) + "\n")
        if self.echo:
            print(json.dumps(record, default=float))
        return record

    def log_epoch(self, epoch: int, **losses):
        return self.log("epoch", epoch=epoch, **losses)

    def log_eval(self, epoch: int, results_dict: Dict[int, Dict[str, float]]):
        flat = {f"{m}@{c}": v for c, row in results_dict.items() for m, v in row.items()}
        return self.log("eval", epoch=epoch, **flat)


def read_jsonl(path: str):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]
