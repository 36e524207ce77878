"""The share of the traced epochs in which no kernel, copy or set ran on the device."""

from benchmark.layer_metrics._shared import device_idle

NAME = "cfgan.device_idle"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "epoch_s"
WORKLOADS = ["cfgan-ml20m.train-csr"]


def read(ctx):
    return device_idle(ctx)
