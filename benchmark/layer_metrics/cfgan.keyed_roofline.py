"""The keyed draw's least time for the traced epochs' ZR keys (a float32
uniform written an entry, at the HBM rate) over its kernel's device time."""

from benchmark.layer_metrics._cfgan import KEYED_KERNELS, kernel_roofline

NAME = "cfgan.keyed_roofline"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "the keyed draw (ops/keyed.py, csrc/keyed.cu)"
MOVES = "epoch_s"
WORKLOADS = ["cfgan-ml20m.train-csr"]


def read(ctx):
    return kernel_roofline(ctx, "keyed_bound_s_per_unit", KEYED_KERNELS)
