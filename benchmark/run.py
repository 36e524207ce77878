"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (data and weights from the seed, the
program's model, warm-up) counts from the first line of this file; the
window measures for ``--seconds``; ``--trace 1`` adds a traced window and
prints the per-layer metrics in place of the end-to-end ones. The last line
of standard output is the result, and the compared numbers with their
limits end standard error. ``--control 1`` runs the cell's control (the
precision one step below the configuration's) for its readings; the
benchmark's own runs never do.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ganmf_tpu"}


def _caches() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a non-negative whole number")
    _caches()
    sys.path.insert(0, str(ROOT))

    import contextlib

    import torch

    from benchmark import faults, harness
    from benchmark.registry import Registry

    reg = Registry()
    cell = reg.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import ganmf_tpu_torch

    if ROOT not in Path(ganmf_tpu_torch.__file__).resolve().parents:
        harness.log(f"ganmf_tpu_torch comes from {ganmf_tpu_torch.__file__}, outside the checkout {ROOT}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    with faults.plant(args.fault) if args.fault else contextlib.nullcontext():
        result = harness.run_cell(reg, args.workload, args.seed, args.seconds, bool(args.trace), device, T0,
                                  control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        harness.log(f"the run loaded {', '.join(bad)}; the benchmark measures the port alone")
        return 3
    for line in harness.check_lines(result):
        harness.log(line)
    print(harness.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
