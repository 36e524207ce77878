#!/usr/bin/env python3
"""Where K1's fused kernel and its wide pair spend their time on one CUDA card.

    python3 scripts/k1_breakdown.py

Builds the kernel library three times through ganmf_tpu_torch/ops/_build.py
(the variants side by side), each with its own K1_BREAKDOWN define (see
ganmf_tpu_torch/csrc/masked_topk.cu), and times their fused launch at the
evaluation block's shape (B=3024 K=250 I=3706 k=50, factors and mask as in
chip_smoke.py) over several item-split counts S:

- as is: scoring, selection and the merge pass;
- no merge (K1_BREAKDOWN=1): each later tile's candidates are compacted but
  never merged into the running lists (the first tile's sort stays);
- scoring only (K1_BREAKDOWN=2): no selection at all; every accumulator
  still feeds a checksum, so no FMA is dropped as dead code.

The variants' outputs are wrong by design; only their times mean anything.
It also prints the occupancy (resident blocks per SM) and times cuBLAS's
bare matmul and the library composition (matmul + masked_fill_ + topk)
beside them. Last, at recommend's shapes (B=5 and B=1, k=20), it times the
launch alone at the plan's S beside the whole wrapper call, which adds its
checks, allocations and device guard. CUDA-event medians of 20 runs.

The wide pair (k > 64) is split the same way, at recommend's default cutoff
(B=5 and B=1, K=250, I=3706, k=3705) and at B=3024 (I=3706) and B=64
(I=17632) with k=100, all with the launch alone:

- tile kernel only, no sort (K1_BREAKDOWN=3): scoring, the mask and the
  kept keys' write;
- tile kernel only (K1_BREAKDOWN=4): the same plus each row's tile sort;
- as is: the same plus the rank launch, at the plan's tile width and, for
  the rows below the card's width, at each of the others.

Beside them: the whole wrapper call, and the wrapper's host time (its
calls enqueued back to back, host clock per call, with no synchronization
until the end), and the library composition's host time likewise.
"""

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402

VARIANTS = {
    "as is": (),
    "no merge": ("-DK1_BREAKDOWN=1",),
    "scoring only": ("-DK1_BREAKDOWN=2",),
}
WIDE_VARIANTS = {
    "tile kernel, no sort": ("-DK1_BREAKDOWN=3",),
    "tile kernel with sort": ("-DK1_BREAKDOWN=4",),
    "as is (tiles + rank)": (),
}


def host_ms(fn, calls=200):
    """Host milliseconds per call of fn() enqueued back to back (the device
    is synchronized only before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls


def host_parts(U, V, M, k):
    """Host time a call of each part of the wide pair's wrapper."""
    from ganmf_tpu_torch.ops import _build, scorer

    dev = U.device
    B, K = U.shape
    I = V.shape[0]
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = scorer.wide_plan(B, I, k, sms)
    vals = torch.empty(B, k, device=dev)
    ids = torch.empty(B, k, dtype=torch.int64, device=dev)
    part = torch.empty(plan.scratch_bytes // 8, dtype=torch.int64, device=dev)
    stream = _build.stream_handle(dev)
    parts = {
        "argument checks": lambda: scorer._check(U, V, M, k),
        "two allocations and the kept scratch": lambda: (
            torch.empty((B, k), dtype=torch.float32, device=dev),
            torch.empty((B, k), dtype=torch.int64, device=dev),
            scorer._scratch(dev, stream, plan.scratch_bytes)),
        "launch plan": lambda: scorer.wide_plan(B, I, k, sms),
        "device guard and stream": lambda: (_build.on_device(dev), _build.stream_handle(dev)),
        "C call (two launches)": lambda: lib.ganmf_masked_topk_wide(
            U.data_ptr(), V.data_ptr(), M.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            part.data_ptr(), B, I, K, k, plan.tile, plan.chunk_rows, stream),
        "whole wrapper": lambda: scorer.masked_topk_scores(U, V, M, k),
    }
    for name, fn in parts.items():
        print(f"    host time of {name}: {host_ms(fn, 1000):.4f} ms", flush=True)


def wide_breakdown(libs, card):
    from ganmf_tpu_torch.ops import _build, scorer

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    K = chip_smoke.NUM_FACTORS
    stream = torch.cuda.current_stream().cuda_stream
    for B, I, k in ((5, 3706, 3705), (1, 3706, 3705), (3024, 3706, 100), (64, 17632, 100)):
        U = ((torch.rand(B, K, generator=g) * 2 - 1) * 0.05).to(dev)
        V = ((torch.rand(I, K, generator=g) * 2 - 1) * 0.05).to(dev)
        M = (torch.rand(B, I, generator=g) < 0.0446 * 0.8).to(dev)
        plan = scorer.wide_plan(B, I, k)
        vals = torch.empty(B, k, device=dev)
        ids = torch.empty(B, k, dtype=torch.int64, device=dev)
        print(f"K1 wide pair at B={B} K={K} I={I} k={k} (the plan: {plan.tiles} tiles of "
              f"{plan.tile}, {plan.kept} kept keys each), launch alone  [{card}]")

        def launch(lib, name, plan):
            part = torch.empty(plan.scratch_bytes // 8, dtype=torch.int64, device=dev)

            def run():
                code = lib.ganmf_masked_topk_wide(U.data_ptr(), V.data_ptr(), M.data_ptr(),
                                                  vals.data_ptr(), ids.data_ptr(), part.data_ptr(),
                                                  B, I, K, k, plan.tile, plan.chunk_rows, stream)
                _build.check(lib, code, f"k1_breakdown: {name}")
            return chip_smoke.cuda_ms(run)

        for name, lib in libs.items():
            print(f"  {name}: {launch(lib, name, plan):.4f} ms", flush=True)
        if B < 64:
            for tile in scorer.WIDE_TILES:
                if tile != plan.tile:
                    other = scorer.wide_plan(B, I, k, tile=tile)
                    ms = launch(libs["as is (tiles + rank)"], "as is", other)
                    print(f"  as is at tiles of {tile} ({other.tiles} tiles): {ms:.4f} ms", flush=True)
        wrapped = chip_smoke.cuda_ms(lambda: scorer.masked_topk_scores(U, V, M, k))
        host = host_ms(lambda: scorer.masked_topk_scores(U, V, M, k))
        library = lambda: torch.topk(torch.matmul(U, V.T).masked_fill_(M, float("-inf")), k)  # noqa: E731
        print(f"  through the wrapper: {wrapped:.4f} ms; wrapper host time {host:.4f} ms a call; "
              f"library composition {chip_smoke.cuda_ms(library):.4f} ms, host time "
              f"{host_ms(library):.4f} ms a call", flush=True)
        if B == 5:
            host_parts(U, V, M, k)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from ganmf_tpu_torch.ops import _build, scorer

    card = chip_smoke.card_line()
    every = {**VARIANTS, **WIDE_VARIANTS}
    with ThreadPoolExecutor(len(every)) as pool:
        built = dict(zip(every, pool.map(_build.load_library, every.values())))
    libs = {name: built[name] for name in VARIANTS}

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    B, I, K, k = 3024, 3706, chip_smoke.NUM_FACTORS, 50
    U = ((torch.rand(B, K, generator=g) * 2 - 1) * 0.05).to(dev)
    V = ((torch.rand(I, K, generator=g) * 2 - 1) * 0.05).to(dev)
    M = (torch.rand(B, I, generator=g) < 0.0446 * 0.8).to(dev)
    vals = torch.empty(B, k, device=dev)
    ids = torch.empty(B, k, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    n_tiles = -(-I // scorer.FUSED_ITEMS)
    print(f"K1 fused at B={B} K={K} I={I} k={k}  [{card}]")
    for name, lib in libs.items():
        print(f"  {name}: {lib.ganmf_masked_topk_blocks_per_sm()} blocks per SM")
        for S in (1, 2, 5, 10, 15):
            tiles = -(-n_tiles // S)
            S = -(-n_tiles // tiles)
            part = torch.empty(S * B * k, dtype=torch.int64, device=dev)

            def launch():
                code = lib.ganmf_masked_topk(U.data_ptr(), V.data_ptr(), M.data_ptr(),
                                             vals.data_ptr(), ids.data_ptr(), part.data_ptr(),
                                             B, I, K, k, tiles, S, stream)
                _build.check(lib, code, f"k1_breakdown: {name}")

            ms = chip_smoke.cuda_ms(launch)
            print(f"    S={S:2d} ({tiles} tiles per split): {ms:.4f} ms", flush=True)
    print(f"  cuBLAS matmul alone: {chip_smoke.cuda_ms(lambda: torch.matmul(U, V.T)):.4f} ms")
    lib_ms = chip_smoke.cuda_ms(
        lambda: torch.topk(torch.matmul(U, V.T).masked_fill_(M, float("-inf")), k))
    print(f"  library composition (matmul + masked_fill_ + topk): {lib_ms:.4f} ms")

    lib = libs["as is"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, kk in ((5, 20), (1, 20)):
        Ub, Mb = U[:b].contiguous(), M[:b].contiguous()
        plan = scorer.fused_plan(b, I, kk, sms)
        part = torch.empty(plan.scratch_bytes // 8, dtype=torch.int64, device=dev)
        vb = torch.empty(b, kk, device=dev)
        ib = torch.empty(b, kk, dtype=torch.int64, device=dev)

        def launch():
            code = lib.ganmf_masked_topk(Ub.data_ptr(), V.data_ptr(), Mb.data_ptr(), vb.data_ptr(),
                                         ib.data_ptr(), part.data_ptr(), b, I, K, kk,
                                         plan.tiles_per_split, plan.splits, stream)
            _build.check(lib, code, "k1_breakdown: as is")

        alone = chip_smoke.cuda_ms(launch)
        wrapped = chip_smoke.cuda_ms(lambda: scorer.masked_topk_scores(Ub, V, Mb, kk))
        print(f"  B={b} k={kk}, S={plan.splits}: launch alone {alone:.4f} ms, "
              f"through the wrapper {wrapped:.4f} ms")
    wide_breakdown({name: built[name] for name in WIDE_VARIANTS}, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
