"""K2's least time for the traced epochs' ZR masks (a float32 key read and a
bool written an entry, at the HBM rate) over its kernel's device time."""

from benchmark.layer_metrics._cfgan import K2_KERNELS, kernel_roofline

NAME = "cfgan.k2_roofline"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "K2, the exact-k selection (ops/select.py, csrc/select.cu)"
MOVES = "epoch_s"
WORKLOADS = ["cfgan-ml20m.train-csr"]


def read(ctx):
    return kernel_roofline(ctx, "k2_bound_s_per_unit", K2_KERNELS)
