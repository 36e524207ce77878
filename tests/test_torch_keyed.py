"""The keyed per-row uniforms (ops/keyed.py), on the CPU: Philox4x32-10
against Random123's known-answer vectors, the draw's independence of the
batch it is drawn in, its range and its distribution. The kernel is held
bitwise against this plain version on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from scipy import stats

from ganmf_tpu_torch.ops import keyed

# Random123's kat_vectors for philox4x32_10: (counter, key, result)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = keyed.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in got) == want


def test_the_draw_is_word_c_mod_4_of_its_counter():
    seed = (5 << 32) | 17
    u = keyed.keyed_uniforms(seed, 3, 1, torch.tensor([9, 2]), 10)
    for r, row in enumerate((9, 2)):
        for c in range(10):
            words = keyed.philox4x32_10(*(torch.tensor([x], dtype=torch.int64) for x in (c // 4, row, 3, 1)),
                                        17, 5)
            assert float(u[r, c]) == (int(words[c % 4]) >> 8) * 2.0**-24


def test_a_rows_draw_does_not_depend_on_its_batch():
    rows = torch.arange(40)
    whole = keyed.keyed_uniforms(11, 2, 0, rows, 37)
    for lo, hi in ((0, 16), (16, 32), (32, 40)):
        assert torch.equal(keyed.keyed_uniforms(11, 2, 0, rows[lo:hi], 37), whole[lo:hi])
    perm = torch.randperm(40, generator=torch.Generator().manual_seed(0))
    assert torch.equal(keyed.keyed_uniforms(11, 2, 0, perm.to(torch.int32), 37), whole[perm])
    # a narrower draw is a prefix of a wider one
    assert torch.equal(keyed.keyed_uniforms(11, 2, 0, rows, 5), whole[:, :5])
    # another seed, epoch, stream or row gives other numbers
    for other in (keyed.keyed_uniforms(12, 2, 0, rows, 37), keyed.keyed_uniforms(11, 3, 0, rows, 37),
                  keyed.keyed_uniforms(11, 2, 1, rows, 37), keyed.keyed_uniforms(11, 2, 0, rows + 40, 37)):
        assert (other != whole).float().mean() > 0.99


def test_values_lie_in_the_unit_interval_and_are_uniform():
    u = keyed.keyed_uniforms(1234, 1, 0, torch.arange(256), 1000).numpy()
    assert u.dtype == np.float32 and u.min() >= 0.0 and u.max() < 1.0
    # 24-bit grid: every value times 2^24 is an integer
    assert np.array_equal(u * 2.0**24, np.floor(u * 2.0**24))
    counts, _ = np.histogram(u, bins=64, range=(0.0, 1.0))
    assert stats.chisquare(counts).pvalue > 1e-3
    assert stats.kstest(u.ravel()[:50000], "uniform").pvalue > 1e-3
    # neighbouring columns and rows are uncorrelated
    assert abs(np.corrcoef(u[:, :-1].ravel(), u[:, 1:].ravel())[0, 1]) < 0.01
    assert abs(np.corrcoef(u[:-1].ravel(), u[1:].ravel())[0, 1]) < 0.01


def test_rejections():
    with pytest.raises(ValueError):
        keyed.keyed_uniforms(1, 1, 0, torch.zeros((2, 2), dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        keyed.keyed_uniforms(1, 1, 0, torch.zeros(2), 4)
    with pytest.raises(ValueError):
        keyed.keyed_uniforms_cuda(1, 1, 0, torch.arange(3), 4)
    assert keyed.keyed_uniforms(1, 1, 0, torch.arange(3), 0).shape == (3, 0)
    assert keyed.key_halves((7 << 32) | 9) == (9, 7)
