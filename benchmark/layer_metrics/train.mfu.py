"""An epoch's GEMM FLOPs (30 B I E + 8 B K I a D and G minibatch pair over
the valid rows) over its wall in the window, as a share of the float32 peak."""

from benchmark.layer_metrics._shared import mfu

NAME = "train.mfu"
UNIT = "%"
SOURCE = "host_clock"
LAYER = "model step (models/ganmf.py)"
MOVES = "epoch_s"
WORKLOADS = ["ganmf-ml20m.train"]


def read(ctx):
    return mfu(ctx)
