"""The FLOP and byte counters against hand counts and against the FLOPs
PyTorch counts in the reference's epoch."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counters
from benchmark.reference.ganmf import Trainer
from benchmark.tests import tiny  # noqa: F401


@pytest.mark.parametrize("rows,cols,K,E,B", [(64, 40, 8, 16, 32), (96, 50, 5, 12, 16)])
def test_epoch_flops_match_the_reference_epoch(rows, cols, K, E, B):
    urm = sps.random(rows, cols, density=0.2, format="csr", random_state=0, dtype=np.float32)
    urm.data[:] = 1.0
    fit = dict(num_factors=K, emb_dim=E, batch_size=B, m=2, d_lr=1e-3, g_lr=1e-3, d_reg=0.0, g_reg=0.0,
               recon_coefficient=0.1)
    tr = Trainer(urm, fit, 3, torch.device("cpu"))
    with FlopCounterMode(display=False) as fc:
        tr.run_epoch()
    assert fc.get_total_flops() == counters.ganmf_epoch_flops(rows, cols, fit)


def test_pair_flops_by_hand():
    B, I, K, E = 2, 3, 5, 7
    d = 20 * B * I * E + 2 * B * K * I
    g = 10 * B * I * E + 6 * B * K * I
    assert counters.ganmf_pair_flops(B, I, K, E) == d + g == 30 * B * I * E + 8 * B * K * I == 1500
    assert counters.ganmf_pair_flops(B, I, K, E, d_steps=2, g_steps=3) == 2 * d + 3 * g


def test_scoring_flops_by_hand():
    assert counters.scoring_flops(138493, 26744, 128) == 2 * 138493 * 26744 * 128


def test_k1_bound_by_hand():
    # recommend at ML-1M's shape: U's row, V and the mask row read, 20 (value, id) pairs written
    nbytes = 4 * (1 + 3706) * 250 + 3706 + 12 * 20
    assert counters.k1_bound_s(1, 3706, 250, 20) == pytest.approx(nbytes / counters.HBM_BYTES_PER_S, rel=1e-12)
    assert counters.k1_bound_s(1, 3706, 250, 20) == pytest.approx(1.1077e-6, rel=1e-4)
    # an evaluation block at ML-20M's shape is bound by its FMAs
    ops = 2 * 3648 * 26744 * 128 / counters.F32_FLOPS
    assert counters.k1_bound_s(3648, 26744, 128, 50) == pytest.approx(ops, rel=1e-12)
    assert ops == pytest.approx(0.3728e-3, rel=1e-3)


def test_k1_blocks():
    assert counters.k1_blocks(10, 4) == [4, 4, 2]
    assert counters.k1_blocks(8, 4) == [4, 4]
    assert counters.k1_blocks(0, 4) == []
