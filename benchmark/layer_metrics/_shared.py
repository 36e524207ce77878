"""What the per-layer readers share. A reader returns None where its run
gives it nothing to read, and the harness then leaves the metric out."""

from benchmark import counters

#: K1's kernels in ganmf_tpu_torch/csrc/masked_topk.cu: the fused kernel and
#: its merge pass, and the wide pair
K1_KERNELS = ("masked_topk_kernel", "merge_splits_kernel", "wide_tiles_kernel", "rank_tiles_kernel")


def device_idle(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(ctx):
    """The unit's counted FLOPs over its wall in the untraced window, as a
    share of the float32 peak."""
    wall, flops = ctx.get("unit_wall_s"), ctx.get("flops_per_unit")
    if not wall or not flops:
        return None
    return 100.0 * flops / wall / counters.F32_FLOPS


def k1_roofline(ctx):
    """K1's least time over the traced units, over the device time of K1's
    kernels in the trace."""
    t, bound, units = ctx["trace"], ctx.get("k1_bound_s_per_unit"), ctx.get("units_traced")
    if t is None or not bound or not units:
        return None
    spent = t.kernel_seconds(K1_KERNELS)
    if spent <= 0:
        return None
    return 100.0 * bound * units / spent
