"""An epoch's GEMM FLOPs (G's and D's products and their gradients over the
valid rows, benchmark/cfgan_counters.py) over its wall in the window, as a
share of the float32 peak."""

from benchmark.layer_metrics._shared import mfu

NAME = "cfgan.mfu"
UNIT = "%"
SOURCE = "host_clock"
LAYER = "CFGAN's model step (models/cfgan.py)"
MOVES = "epoch_s"
WORKLOADS = ["cfgan-ml20m.train-csr"]


def read(ctx):
    return mfu(ctx)
