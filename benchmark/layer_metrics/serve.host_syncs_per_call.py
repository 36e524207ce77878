"""The program's host syncs (blocking copies to the card, reads back) per recommend call."""

from benchmark.layer_metrics._program import host_syncs_per_call

NAME = "serve.host_syncs_per_call"
UNIT = "syncs/call"
SOURCE = "program_counter"
LAYER = "serving (models/base.py recommend)"
MOVES = "recommend_p99_ms"
WORKLOADS = ["ganmf-ml1m.serve"]


def read(ctx):
    return host_syncs_per_call("serve.recommend")
