#!/usr/bin/env python3
"""Where K2 (exact-k selection) spends its time on one CUDA card.

    python3 scripts/k2_breakdown.py

Builds the kernel library three times through ganmf_tpu_torch/ops/_build.py
(side by side), each with its own K2_BREAKDOWN define (see
ganmf_tpu_torch/csrc/select.cu), and times the launch alone at CFGAN's mask
shapes on LastFM (user mode [1884, 17632], item mode [17632, 1884]) and at
[2048, 17632], on chip_smoke.py's inputs (uniform keys, +inf at the
interactions, k = int(n_zeros * zr_ratio)):

- as is;
- no radix (K2_BREAKDOWN=1): the reads and the mask write alone;
- one histogram (K2_BREAKDOWN=2): every lane counts into one histogram,
  not 8 sub-histograms.

"one histogram" gives the same mask; "no radix" does not. Beside them: the
wrapper call, its host time a call (calls enqueued back to back), and the
bound (5 bytes a key over 3.35 TB/s, the k read once). CUDA-event medians
of 20 runs.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from k1_breakdown import host_ms  # noqa: E402

VARIANTS = {
    "as is": (),
    "no radix (reads and writes)": ("-DK2_BREAKDOWN=1",),
    "one histogram": ("-DK2_BREAKDOWN=2",),
}
SHAPES = ((1884, 17632), (17632, 1884), (2048, 17632))


def main():
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from ganmf_tpu_torch.ops import _build
    from ganmf_tpu_torch.ops.select import smallest_k_mask_cuda

    card = chip_smoke.card_line()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(_build.load_library, VARIANTS.values())))
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for R, I in SHAPES:
        keys, k = (t.to(dev) for t in chip_smoke.select_case("uniform", R, I, g))
        out = torch.empty(R, I, dtype=torch.bool, device=dev)
        bound_ms, _ = chip_smoke.bound(0, keys.numel() * 5 + k.numel() * 4)
        print(f"K2 at [{R}, {I}], launch alone; bound {bound_ms:.4f} ms  [{card}]")
        want = smallest_k_mask_cuda(keys, k)
        for name, lib in libs.items():
            def launch(lib=lib, name=name):
                code = lib.ganmf_smallest_k_mask(keys.data_ptr(), k.data_ptr(), 0, out.data_ptr(),
                                                 R, I, stream)
                _build.check(lib, code, f"k2_breakdown: {name}")

            ms = chip_smoke.cuda_ms(launch)
            same = "same mask" if torch.equal(out, want) else "mask differs"
            print(f"  {name}: {ms:.4f} ms ({100 * bound_ms / ms:.1f}% of the bound; {same}; "
                  f"{lib.ganmf_smallest_k_mask_blocks_per_sm(I)} blocks per SM)", flush=True)
        wrapped = chip_smoke.cuda_ms(lambda: smallest_k_mask_cuda(keys, k))
        host = host_ms(lambda: smallest_k_mask_cuda(keys, k))
        print(f"  through the wrapper: {wrapped:.4f} ms; wrapper host time {host:.4f} ms a call",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
