"""K1's least time for the evaluation's blocks over its kernels' device time in the traced evaluations."""

from benchmark.layer_metrics._shared import k1_roofline

NAME = "eval.k1_roofline"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "K1, the fused masked top-k scorer (ops/scorer.py, csrc/masked_topk.cu)"
MOVES = "eval_users_per_s"
WORKLOADS = ["ganmf-ml20m.eval"]


def read(ctx):
    return k1_roofline(ctx)
