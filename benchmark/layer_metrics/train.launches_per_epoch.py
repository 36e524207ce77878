"""Kernels launched on the device in the traced epochs, per epoch."""

NAME = "train.launches_per_epoch"
UNIT = "launches/epoch"
SOURCE = "device_trace"
LAYER = "training loop, host (models/gan_base.py, models/ganmf.py mf_generator_epoch)"
MOVES = "epoch_s"
WORKLOADS = ["ganmf-ml20m.train"]


def read(ctx):
    t, units = ctx["trace"], ctx.get("units_traced")
    if t is None or not units or not t.kernels:
        return None
    return t.kernels / units
