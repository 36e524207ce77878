"""An evaluation's score product (2 U_eval K I) over its wall in the window, as a share of the float32 peak."""

from benchmark.layer_metrics._shared import mfu

NAME = "eval.mfu"
UNIT = "%"
SOURCE = "host_clock"
LAYER = "evaluator (eval/evaluator.py, eval/metrics.py)"
MOVES = "eval_users_per_s"
WORKLOADS = ["ganmf-ml20m.eval"]


def read(ctx):
    return mfu(ctx)
