"""K2's plain version against the JAX package's exact-k selection, bitwise.

On CPU tensors ``smallest_k_mask`` takes its plain version, the stable rank
table of the monotone image of the key bits. It must give the masks of the
Pallas kernel (``smallest_k_mask_pallas`` in interpret mode) and of the JAX
dispatching ``smallest_k_mask`` (the XLA bisection on the CPU) bit for bit,
on the cases of tests/test_pallas_select.py and tests/test_aux.py:377-400.
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ganmf_tpu.ops.pallas_select import smallest_k_mask_pallas
from ganmf_tpu.ops.topk import smallest_k_mask as jax_smallest_k_mask
from ganmf_tpu_torch.ops import select
from ganmf_tpu_torch.ops.topk import monotone_key_image, smallest_k_mask, smallest_k_mask_reference
from ganmf_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _counter(name: str) -> int:
    """A counter of the port (ganmf_tpu_torch/utils/profiling.py)."""
    return profiling.counters().get(name, 0)


def _both(keys: np.ndarray, k: np.ndarray):
    """(port mask, Pallas mask, XLA mask) as numpy bool arrays."""
    got = smallest_k_mask(torch.from_numpy(keys), torch.from_numpy(k)).numpy()
    pallas = np.asarray(smallest_k_mask_pallas(jnp.asarray(keys), jnp.asarray(k), interpret=True))
    xla = np.asarray(jax_smallest_k_mask(jnp.asarray(keys), jnp.asarray(k)))
    return got, pallas, xla


def _assert_same(keys, k):
    got, pallas, xla = _both(keys, k)
    assert got.dtype == np.bool_ and got.shape == keys.shape
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got.sum(1), k)
    return got


@pytest.mark.parametrize("ratio", [0.0, 0.3, 1.0])
def test_tied_low_resolution_keys(ratio):
    # low-resolution keys force many ties, some straddling the boundary
    keys = np.array(jnp.round(jax.random.uniform(jax.random.PRNGKey(7), (48, 97)) * 8.0))
    inter = np.asarray(jax.random.uniform(jax.random.PRNGKey(8), (48, 97)) < 0.3)
    keys[inter] = np.inf
    k = ((~inter).sum(1) * np.float32(ratio)).astype(np.int32)
    _assert_same(keys, k)


def test_negative_keys_with_row_and_column_padding():
    # negative keys take the sign branch of the monotone map; 97 columns and
    # 5 rows make the Pallas kernel pad both axes
    keys = np.array(-jnp.abs(jax.random.normal(jax.random.PRNGKey(9), (5, 97))))
    inter = np.asarray(jax.random.uniform(jax.random.PRNGKey(10), (5, 97)) < 0.2)
    keys[inter] = np.inf
    k = ((~inter).sum(1) * np.float32(0.4)).astype(np.int32)
    _assert_same(keys, k)


def test_infinite_keys_and_full_rows():
    rng = np.random.RandomState(2)
    keys = rng.rand(16, 130).astype(np.float32)
    keys[rng.rand(16, 130) < 0.5] = np.inf
    k = rng.randint(0, 131, 16).astype(np.int32)
    k[0], k[1], k[2] = 0, 130, (np.isfinite(keys[2])).sum() + 3  # some +inf selected
    got = _assert_same(keys, k)
    assert not got[0].any() and got[1].all()
    # the lowest-indexed +inf keys are taken first
    inf_cols = np.flatnonzero(~np.isfinite(keys[2]))
    np.testing.assert_array_equal(got[2, inf_cols], np.arange(len(inf_cols)) < 3)


def test_signed_zeros_order_below_positive_zero():
    keys = np.array([[0.0, -0.0, 0.0, -0.0, 1.0, -1.0]], np.float32)
    for kk in range(7):
        got = _assert_same(keys, np.array([kk], np.int32))
        want = np.zeros(6, bool)
        want[[5, 1, 3, 0, 2, 4][:kk]] = True  # -1, the two -0.0, the two +0.0, 1
        np.testing.assert_array_equal(got[0], want)


def test_matches_the_stable_rank_table_at_random():
    rng = np.random.RandomState(4)
    keys = (rng.randn(32, 300) * 100).astype(np.float32)
    keys[rng.rand(32, 300) < 0.1] = np.inf
    keys[rng.rand(32, 300) < 0.05] = -np.inf
    k = rng.randint(0, 301, 32).astype(np.int64)  # int64 k is taken too
    got = smallest_k_mask(torch.from_numpy(keys), torch.from_numpy(k)).numpy()
    rank = np.argsort(np.argsort(keys, axis=1, kind="stable"), axis=1, kind="stable")
    np.testing.assert_array_equal(got, rank < k[:, None])


def test_monotone_image_orders_as_the_uint32_map():
    keys = np.array([-np.inf, -2.5, -1e-30, -0.0, 0.0, 1e-30, 3.0, np.inf], np.float32)
    img = monotone_key_image(torch.from_numpy(keys)).numpy()
    assert (np.diff(img) > 0).all()
    b = keys.view(np.uint32)
    want = np.where(b >> 31 == 1, ~b, b | np.uint32(0x80000000)).astype(np.int64)
    np.testing.assert_array_equal(img, want)


def test_wrappers_reject_what_they_do_not_take():
    keys = torch.rand(4, 10)
    k = torch.full((4,), 3, dtype=torch.int32)
    # k outside [0, I] is taken, as the JAX function takes it: the JAX masks
    for bad in (-1, 10 + 3):
        kk = np.full(4, bad, np.int32)
        got, pallas, xla = _both(keys.numpy(), kk)
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, xla)
        assert got.all() if bad > 0 else not got.any()
    with pytest.raises(TypeError):
        smallest_k_mask(keys.double(), k)
    with pytest.raises(TypeError):
        smallest_k_mask(keys, k.float())
    with pytest.raises(ValueError):
        smallest_k_mask(keys, k[:3])
    # the kernel wrapper launches on CUDA tensors only, and counts nothing else
    before = _counter("k2.launches")
    with pytest.raises(ValueError):
        select.smallest_k_mask_cuda(keys, k)
    assert _counter("k2.launches") == before
    assert torch.equal(smallest_k_mask(keys, k), smallest_k_mask_reference(keys, k))
    assert _counter("k2.launches") == before


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("I", [1, 97, 130])
def test_k_outside_its_range_is_clamped_as_in_jax(I, dtype):
    """k <= 0 selects nothing and k >= I every column, in the port as in the
    Pallas kernel and the XLA bisection; rows in between as usual."""
    rng = np.random.RandomState(I)
    keys = rng.rand(6, I).astype(np.float32)
    keys[rng.rand(6, I) < 0.3] = np.inf
    k = np.array([-1, I + 3, -7, 2 * I, 0, I // 2], dtype)
    got, pallas, xla = _both(keys, k)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got.sum(1), np.clip(k, 0, I))
