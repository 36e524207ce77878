"""Launches of K2 and of the keyed draw per training epoch, over the run:
two a G minibatch while the draw and the selection are two kernels."""

NAME = "cfgan.mask_launches_per_epoch"
UNIT = "launches/epoch"
SOURCE = "program_counter"
LAYER = "CFGAN's csr epoch, host (models/cfgan.py cfgan_epoch)"
MOVES = "epoch_s"
WORKLOADS = ["cfgan-ml20m.train-csr"]


def read(ctx):
    from ganmf_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    counts = counters()
    epochs = counts.get("train.epoch.calls", 0)
    if not epochs:
        return None
    return (counts.get("k2.launches", 0) + counts.get("keyed.launches", 0)) / epochs
