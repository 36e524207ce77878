"""A call's score product (2 K I) over its mean wall in the window, as a share of the float32 peak."""

from benchmark.layer_metrics._shared import mfu

NAME = "serve.mfu"
UNIT = "%"
SOURCE = "host_clock"
LAYER = "serving (models/base.py recommend)"
MOVES = "recommend_p99_ms"
WORKLOADS = ["ganmf-ml1m.serve"]


def read(ctx):
    return mfu(ctx)
