"""K1's least time at B=1 over its kernels' device time in the traced calls."""

from benchmark.layer_metrics._shared import k1_roofline

NAME = "serve.k1_roofline"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "K1, the fused masked top-k scorer (ops/scorer.py, csrc/masked_topk.cu)"
MOVES = "recommend_p99_ms"
WORKLOADS = ["ganmf-ml1m.serve"]


def read(ctx):
    return k1_roofline(ctx)
