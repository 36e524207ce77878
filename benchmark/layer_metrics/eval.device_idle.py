"""The share of the traced evaluations in which nothing ran on the device."""

from benchmark.layer_metrics._shared import device_idle

NAME = "eval.device_idle"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "eval_users_per_s"
WORKLOADS = ["ganmf-ml20m.eval"]


def read(ctx):
    return device_idle(ctx)
