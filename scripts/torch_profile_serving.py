#!/usr/bin/env python3
"""Where the time goes in the port's serving slice on one CUDA card.

    python3 scripts/torch_profile_serving.py [--out chiprun_out/profile]

Builds the same model and split as chip_smoke.py (GANMF at num_factors=250,
emb_dim=992, random weights from seed 1337, the ML-1M-shaped synthetic split,
user mode), warms up, then traces one holdout evaluation and one
serve_all(cutoff=20) with torch.profiler. For each it prints the wall time,
the device time summed by kernel name and by class (GEMMs, optimizer,
reductions, ...), and the device busy share (union of the intervals of
kernels, copies and fills over the wall time). The chrome traces go to --out.
``profile`` is shared with scripts/torch_profile_cfgan.py.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def busy_us(events):
    """Length of the union of the device kernel intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


KERNEL_CLASSES = (  # (class, substrings of the kernel names in it), first match wins
    ("K1/K2", ("masked_topk", "merge_splits", "wide_tiles", "rank_tiles", "select_block")),
    ("GEMM", ("gemm", "Kernel2<cutlass", "splitKreduce", "gemv")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("sort/top-k", ("Sort", "sort", "mbtopk")),
    ("reduction", ("reduce_kernel",)),
    ("copy/fill", ("Memcpy", "Memset", "copy_kernel", "fill")),
    ("index/scatter/gather", ("index", "scatter", "gather")),
)


def kernel_class(name):
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "elementwise/other"


def profile(name, fn, out_dir, card, host_ops=0):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels, copies and fills: a record_function span (torch.optim's
    # "Optimizer.step#Adam.step") also has a device-side range, which covers
    # the idle gaps between its kernels and is no device work
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy = busy_us(kernels)
    print(f"== {name}: wall {wall_us / 1e3:.4f} ms, device busy {busy / 1e3:.4f} ms "
          f"({100 * busy / wall_us:.1f}% of wall, idle {100 - 100 * busy / wall_us:.1f}%), "
          f"{len(kernels)} device ops  [{card}]")
    by_class = {}
    for kname, us in by_name.items():
        by_class[kernel_class(kname)] = by_class.get(kernel_class(kname), 0.0) + us
    print("   device time by class: " + "; ".join(
        f"{cls} {us / 1e3:.4f} ms" for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1])))
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"   {us / 1e3:9.4f} ms  {100 * us / max(busy, 1e-9):5.1f}%  {kname[:100]}")
    if host_ops:
        print(f"   host operators by self CPU time (top {host_ops}):")
        for a in sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:host_ops]:
            print(f"   {a.self_cpu_time_total / 1e3:9.4f} ms  x{a.count:<5d} {a.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.json"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import GANMF, init_params
    from ganmf_tpu_torch.utils.device import cuda_device

    card = chip_smoke.card_line()
    dev = cuda_device()
    train, test = chip_smoke.ml1m_split()
    model = GANMF(train, mode="user", seed=chip_smoke.SEED, device=dev)
    model.params = init_params(*train.shape, chip_smoke.NUM_FACTORS, chip_smoke.EMB_DIM,
                               torch.Generator().manual_seed(chip_smoke.SEED), dev)
    ev = EvaluatorHoldout(test, chip_smoke.CUTOFFS, device=dev)
    profile("evaluate", lambda: ev.evaluateRecommender(model), args.out, card)
    profile("serve_all", lambda: model.serve_all(cutoff=20), args.out, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
