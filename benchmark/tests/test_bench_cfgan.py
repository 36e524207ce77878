"""The cell ``cfgan-ml20m.train-csr`` at a size a test run holds, through the
same harness the card runs: a sound run is ``correct``, each fault planted
here is caught, and the TF32 control fails on the card. Then the cell's
counters: an epoch's GEMM FLOPs against those PyTorch counts in the
reference's epoch, and the mask kernels' bytes by hand.

The faults, planted under the timed path for the duration of a ``with``:

- ``unchanged``: no optimizer step is applied, so the state stays as it is;
- ``half_batch``: half of each minibatch left out of both losses, the means
  taken over the rest;
- ``flipped_mask``: one entry of each ZR mask flipped.
"""

import contextlib
import math
import time

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import cfgan_counters, counters, harness
from benchmark.reference import cfgan as ref_cfgan
from benchmark.registry import Registry
from benchmark.tests.tiny import SEED, TINY, cuda_device  # noqa: F401  (a fixture)

CELL = "cfgan-ml20m.train-csr"
#: ML-20M's shapes cut to a CPU run's (300 x 220, G 220 -> 32 -> 220, D 5 x
#: 4, batches of 32 and 64, both phases' last minibatch padded); the cell's
#: own limits
OVERRIDES = {"config": {"data": TINY["config"]["data"],
                        "fit": {"g_nodes": 32, "d_batch_size": 32, "g_batch_size": 64}},
             "traffic": {"mask_stride": 2}}
FAULTS = ("unchanged", "half_batch", "flipped_mask")


def _half(w: torch.Tensor) -> torch.Tensor:
    w = w.clone()
    w[w.shape[0] // 2:] = 0.0
    return w


@contextlib.contextmanager
def plant(name: str):
    from ganmf_tpu_torch.models import cfgan

    saved = []

    def patch(attr, value):
        saved.append((attr, getattr(cfgan, attr)))
        setattr(cfgan, attr, value)

    if name == "unchanged":
        patch("apply_grads", lambda opt, params, grads: None)
    elif name == "half_batch":
        d_loss, g_loss = cfgan.d_loss, cfgan.g_loss
        patch("d_loss", lambda D, G, cond, tmask, w, *a, **k: d_loss(D, G, cond, tmask, _half(w), *a, **k))
        patch("g_loss", lambda G, D, cond, tmask, zmask, w, *a, **k:
              g_loss(G, D, cond, tmask, zmask, _half(w), *a, **k))
    elif name == "flipped_mask":
        negative_mask = cfgan.negative_mask

        def flipped(block, u, ratio):
            mask = negative_mask(block, u, ratio).clone()
            mask[0, 0] = 1 - mask[0, 0]
            return mask

        patch("negative_mask", flipped)
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    try:
        yield
    finally:
        for attr, value in reversed(saved):
            setattr(cfgan, attr, value)


def run_tiny(seed: int = SEED, trace: bool = False, control: bool = False, device=torch.device("cpu")):
    return harness.run_cell(Registry(), CELL, seed, 0.3, trace, device, time.perf_counter(), control=control,
                            overrides=OVERRIDES)


def _numbers(result):
    return {k: v["value"] for k, v in result["check"].items()}


@pytest.mark.parametrize("seed", [SEED, 7])
def test_sound_run_is_correct(seed):
    result = run_tiny(seed)
    assert result["correct"], _numbers(result)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert _numbers(result)["mask_gap"] == 0.0
    assert set(result["metrics"]) == {"epoch_s", "setup_s"}


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_caught(fault):
    with plant(fault):
        result = run_tiny()
    assert not result["correct"], _numbers(result)
    if fault == "flipped_mask":  # the masks alone catch it
        assert 0 < _numbers(result)["mask_gap"] < 1e-3


def test_unchanged_state_reads_one():
    with plant("unchanged"):
        result = run_tiny()
    assert math.isclose(_numbers(result)["change_gap"], 1.0)
    assert math.isclose(_numbers(result)["window_change_gap"], 1.0)


def test_fault_from_the_window_on_is_caught(monkeypatch):
    stack = contextlib.ExitStack()
    setup_done = harness.Run.setup_done

    def late(self):
        setup_done(self)
        stack.enter_context(plant("unchanged"))

    monkeypatch.setattr(harness.Run, "setup_done", late)
    with stack:
        result = run_tiny()
    numbers, limits = _numbers(result), result["check"]
    assert not result["correct"], numbers
    assert all(numbers[k] <= limits[k]["limit"] for k in ("loss_gap", "moment_gap", "change_gap", "mask_gap"))
    assert numbers["window_change_gap"] > limits["window_change_gap"]["limit"], numbers


def test_traced_run_reads_the_cells_metrics():
    result = run_tiny(trace=True)
    assert result["correct"]
    # the CPU runs no kernel of the port: no roofline to read
    assert set(result["metrics"]) == {"cfgan.mfu", "cfgan.device_idle", "cfgan.mask_launches_per_epoch"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.cuda
def test_control_fails_on_the_card(cuda_device):
    result = run_tiny(control=True, device=cuda_device)
    assert not result["correct"], _numbers(result)


@pytest.mark.parametrize("rows,cols,g,d,db,gb", [(128, 40, (1, 16), (5, 4), 32, 64), (96, 50, (2, 8), (1, 3), 16, 48)])
def test_epoch_flops_match_the_reference_epoch(rows, cols, g, d, db, gb):
    urm = sps.random(rows, cols, density=0.2, format="csr", random_state=0, dtype=np.float32)
    urm.data[:] = 1.0
    fit = dict(g_layers=g[0], g_nodes=g[1], d_layers=d[0], d_nodes=d[1], g_hidden_act="tanh", d_hidden_act="linear",
               scheme="ZR", zr_ratio=0.4, zr_coefficient=0.05, d_batch_size=db, g_batch_size=gb, d_lr=1e-3,
               g_lr=1e-3, d_reg=1e-4, g_reg=1e-4)
    tr = ref_cfgan.Trainer(urm, fit, 3, torch.device("cpu"))
    with FlopCounterMode(display=False) as fc:
        tr.run_epoch()
    assert fc.get_total_flops() == cfgan_counters.cfgan_epoch_flops(rows, *ref_cfgan.layer_dims(cols, fit))


def test_counts_at_the_cells_shape_by_hand():
    I, H, U = 26744, 1024, 138493
    g_dims, d_dims = [I, H, I], [2 * I, 4, 4, 4, 4, 4, 1]
    d, g = cfgan_counters.cfgan_row_flops(g_dims, d_dims)
    small = 2 * 4 * (4 * 4 + 1)  # D's layers past its first
    assert d == 4 * I * H + 4 * (16 * I + small) + 2 * small
    assert g == 10 * I * H + 2 * (16 * I + small)
    assert cfgan_counters.cfgan_epoch_flops(U, g_dims, d_dims) == pytest.approx(5.35e13, rel=1e-2)
    entries = cfgan_counters.mask_entries_per_epoch(U, I, 1024)
    assert entries == 136 * 1024 * I
    # K2 reads a key and writes a bool, the keyed draw writes a uniform: ~5.6 ms and ~4.4 ms an epoch
    assert entries * 5 / counters.HBM_BYTES_PER_S == pytest.approx(5.56e-3, rel=1e-2)
