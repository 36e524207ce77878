#!/usr/bin/env python3
"""Times K1's wide pair and K2 of one checkout of the port on one CUDA card.

    python3 scripts/compare_kernels.py [--root DIR] [--label NAME]

Imports ``ganmf_tpu_torch`` from DIR (default: this checkout), builds its
kernels there and times, on the same seeded inputs whatever the checkout:

- K1's wide pair through its wrapper at recommend's default cutoff (B=5 and
  B=1, K=250, I=3706, k=3705), at B=64 (I=17632) and B=3024 (I=3706) with
  k=100, and for one row of 131072 items at k=I-1, beside the library
  composition (matmul + masked_fill_ + topk);
- K2 at [1884, 17632], [17632, 1884] and [2048, 17632], through its wrapper
  and as the launch alone.

Two checkouts are compared by running it once for each in one chip call,
in turns (parent, change, change, parent): unpack the parent with ``git
archive`` into a directory that .gitignore lists and pass it as --root.
CUDA-event medians of 20 runs; the last line is a JSON object of the times.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402

WIDE_SHAPES = ((5, 3706, 3705), (1, 3706, 3705), (64, 17632, 100), (3024, 3706, 100),
               (1, 131072, 131071))
K2_SHAPES = ((1884, 17632), (17632, 1884), (2048, 17632))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT, help="checkout whose ganmf_tpu_torch is timed")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from ganmf_tpu_torch.ops import _build
    from ganmf_tpu_torch.ops.scorer import masked_topk_scores
    from ganmf_tpu_torch.ops.select import smallest_k_mask_cuda

    lib = _build.load_library()
    card = chip_smoke.card_line()
    dev = torch.device("cuda", 0)
    print(f"{args.label}: ganmf_tpu_torch from {os.path.dirname(_build.CSRC)}  [{card}]")
    result = {"label": args.label, "card": card, "wide": {}, "k2": {}}
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    K = chip_smoke.NUM_FACTORS
    for B, I, k in WIDE_SHAPES:
        U = ((torch.rand(B, K, generator=g) * 2 - 1) * 0.05).to(dev)
        V = ((torch.rand(I, K, generator=g) * 2 - 1) * 0.05).to(dev)
        M = (torch.rand(B, I, generator=g) < 0.0446 * 0.8).to(dev)
        ms = chip_smoke.cuda_ms(lambda: masked_topk_scores(U, V, M, k))
        library_ms = chip_smoke.cuda_ms(
            lambda: torch.topk(torch.matmul(U, V.T).masked_fill_(M, float("-inf")), k))
        name = f"B={B} K={K} I={I} k={k}"
        result["wide"][name] = {"ms": ms, "library_ms": library_ms}
        print(f"  K1 wide pair at {name}: {ms:.4f} ms; library composition {library_ms:.4f} ms",
              flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    int64_k = len(lib.ganmf_smallest_k_mask.argtypes) == 7  # the C signature with k's type
    for R, I in K2_SHAPES:
        keys, k = (t.to(dev) for t in chip_smoke.select_case("uniform", R, I, g))
        out = torch.empty(R, I, dtype=torch.bool, device=dev)
        args_k = (k.data_ptr(), 0) if int64_k else (k.data_ptr(),)

        def launch():
            code = lib.ganmf_smallest_k_mask(keys.data_ptr(), *args_k, out.data_ptr(), R, I, stream)
            _build.check(lib, code, "compare_kernels: K2")

        ms = chip_smoke.cuda_ms(lambda: smallest_k_mask_cuda(keys, k))
        alone = chip_smoke.cuda_ms(launch)
        if not torch.equal(out, smallest_k_mask_cuda(keys, k)):
            raise SystemExit("compare_kernels: the launch alone and the wrapper disagree")
        bound_ms, _ = chip_smoke.bound(0, keys.numel() * 5 + k.numel() * 4)
        name = f"[{R}, {I}]"
        result["k2"][name] = {"ms": ms, "launch_ms": alone, "bound_ms": bound_ms}
        print(f"  K2 at {name}: {ms:.4f} ms through the wrapper, {alone:.4f} ms the launch alone; "
              f"bound {bound_ms:.4f} ms", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
