"""Runs cells several times, one process a run, and reports the spreads.

    python3 benchmark/measure.py --out <file.jsonl> RUN [RUN ...]

Each RUN is ``cell:seed:seconds[:trace[:control[:fault]]]``. Every run's
result line (or its failure, with the end of its standard error) is appended to
``--out`` as it ends; at the end, for each cell and metric, the median and
the spread (the distance between the first and the third quartile of
``statistics.quantiles(values, n=4)``, as a share of the median) are
printed. This is how the bounds in BENCHMARK.json were measured.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(cell: str, seed: str, seconds: str, trace: str = "0", control: str = "0", fault: str = "") -> dict:
    cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", cell, "--seed", seed,
           "--seconds", seconds, "--trace", trace, "--control", control, "--fault", fault]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    rec = {"cell": cell, "seed": int(seed), "seconds": float(seconds), "trace": int(trace),
           "control": int(control), "fault": fault, "rc": p.returncode, "wall_s": time.perf_counter() - t}
    lines = p.stdout.strip().splitlines()
    try:
        rec["result"] = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        rec["result"] = None
    rec["stderr_tail"] = p.stderr[-3000:]
    return rec


def fault_of(spec: str) -> str:
    parts = spec.split(":")
    return parts[5] if len(parts) > 5 else ""


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    by = defaultdict(list)
    for spec in args.runs:
        rec = one(*spec.split(":"))
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        res = rec["result"]
        short = {k: v["value"] for k, v in (res or {}).get("metrics", {}).items()}
        chk = {k: v["value"] for k, v in (res or {}).get("check", {}).items()}
        print(f"{spec} rc={rec['rc']} wall={rec['wall_s']:.1f}s correct={(res or {}).get('correct')} "
              f"{short} check={chk}", flush=True)
        if res is None:
            print(rec["stderr_tail"][-1500:], flush=True)
        else:
            for k, v in short.items():
                if v is not None:
                    by[(rec["cell"], rec["trace"], rec["control"], fault_of(spec), k)].append(v)
    for (cell, trace, control, fault, k), vals in sorted(by.items()):
        print(f"{cell} trace={trace} control={control} fault={fault} {k}: n={len(vals)} "
              f"median={statistics.median(vals)!r} spread={spread(vals):.5f} values={vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
