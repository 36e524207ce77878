"""What the readers of CFGAN's cell share: a mask kernel's share of its
roofline over the traced epochs."""

#: the kernels' names (ganmf_tpu_torch/csrc/select.cu, csrc/keyed.cu)
K2_KERNELS = ("select_block_kernel",)
KEYED_KERNELS = ("keyed_uniforms_kernel",)


def kernel_roofline(ctx, bound_key: str, kernels) -> float:
    """The kernels' least time over the traced epochs (``ctx[bound_key]``
    an epoch) over their device time in the trace; None where the trace
    holds none of them."""
    t, bound, units = ctx["trace"], ctx.get(bound_key), ctx.get("units_traced")
    if t is None or not bound or not units:
        return None
    spent = t.kernel_seconds(kernels)
    if spent <= 0:
        return None
    return 100.0 * bound * units / spent
