"""Shared sizes for the benchmark's CPU tests: every cell at a size a test
run holds, through the same harness the card runs."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.registry import Registry  # noqa: E402

TINY = {
    "config": {"data": {"n_users": 300, "n_items": 220, "n_ratings": 12000, "min_per_user": 20, "max_per_user": 120,
                        "n_clusters": 8},
               "fit": {"num_factors": 8, "emb_dim": 16, "batch_size": 32}},
    "traffic": {"warmup_calls": 5, "trace_calls": 10, "check_calls": 300, "warmup_evaluations": 1,
                "trace_evaluations": 2,
                "list_stride": 4},
}
SEED = (1 << 31) + 12345
#: at this size a training cell runs a tiny model, held to the limits set
#: for ML-1M's epochs, whose change numbers take their upper reading from a
#: fault (ganmf-ml20m.train's window_change_gap limit comes from its control
#: at its own size and lies under what the tiny model's user embeddings read)
TRAIN_LIMITS = json.loads((ROOT / "benchmark/workloads/ganmf-ml1m.train.json").read_text())["limits"]


def tiny_overrides(cell: str) -> dict:
    if cell.endswith(".train"):
        return dict(TINY, limits=TRAIN_LIMITS)
    return TINY


def run_tiny(cell: str, seed: int = SEED, trace: bool = False, control: bool = False, seconds: float = 0.3):
    return harness.run_cell(Registry(), cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                            control=control, overrides=tiny_overrides(cell))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
