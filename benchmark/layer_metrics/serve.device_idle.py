"""The share of the traced recommend calls in which nothing ran on the device."""

from benchmark.layer_metrics._shared import device_idle

NAME = "serve.device_idle"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "recommend_p99_ms"
WORKLOADS = ["ganmf-ml1m.serve"]


def read(ctx):
    return device_idle(ctx)
