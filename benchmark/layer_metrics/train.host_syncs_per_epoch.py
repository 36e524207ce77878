"""The program's host syncs (blocking copies to the card, reads back) per training epoch."""

from benchmark.layer_metrics._program import host_syncs_per_call

NAME = "train.host_syncs_per_epoch"
UNIT = "syncs/epoch"
SOURCE = "program_counter"
LAYER = "training loop, host (models/gan_base.py, models/ganmf.py mf_generator_epoch)"
MOVES = "epoch_s"
WORKLOADS = ["ganmf-ml20m.train"]


def read(ctx):
    return host_syncs_per_call("train.epoch")
