"""Device views of sparse matrices: the port against ganmf_tpu.data.device.

Both build the same float32 values by scattering the same stored entries,
so the results must be bitwise equal.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from ganmf_tpu.data import device as jax_device
from ganmf_tpu_torch.data import device as torch_device

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _matrix(seed=3):
    rng = np.random.RandomState(seed)
    m = sps.random(40, 60, density=0.1, random_state=rng, format="csr", dtype=np.float32)
    m = sps.lil_matrix(m)
    m[0, :50] = 1.0  # one heavy row makes the padded planes wide
    m[7, :] = 0.0  # an empty row
    return sps.csr_matrix(m)


@pytest.mark.parametrize("max_len", [None, 8, 16, 1000])
@pytest.mark.parametrize("which", ["dense", "mask"])
def test_padded_rows_match_jax(which, max_len):
    m = _matrix()
    lens = np.diff(m.indptr)
    # a crop is exact only for rows that fit it: pick those
    users = np.arange(m.shape[0]) if max_len is None else np.where(lens <= max_len)[0]
    users = np.concatenate([users[::-1], users[:3]])  # any order, repeats allowed
    jfn = getattr(jax_device, f"padded_rows_{which}")
    tfn = getattr(torch_device, f"padded_rows_{which}")
    want = np.asarray(jfn(jax_device.padded_csr_from_sparse(m, cache=False),
                          jnp.asarray(users, dtype=jnp.int32), m.shape[1], max_len=max_len))
    got = tfn(torch_device.padded_csr_from_sparse(m, CPU), torch.from_numpy(users),
              m.shape[1], max_len=max_len).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_padded_planes_keep_the_sentinel():
    m = _matrix()
    pc = torch_device.padded_csr_from_sparse(m, CPU)
    lens = np.diff(m.indptr)
    assert tuple(pc.idx.shape) == (m.shape[0], lens.max())
    for r in (0, 7, 12):
        assert (pc.idx[r, lens[r]:] == m.shape[1]).all()  # sentinel column
        assert (pc.val[r, lens[r]:] == 0).all()
        np.testing.assert_array_equal(pc.idx[r, :lens[r]].numpy(), m.indices[m.indptr[r]:m.indptr[r + 1]])


def test_device_urm_matches_jax():
    m = _matrix(5)
    m.data *= 3  # non-binary values
    want = jax_device.DeviceURM(m)
    got = torch_device.DeviceURM(m, CPU)
    np.testing.assert_array_equal(got.dense.numpy(), np.asarray(want.dense))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    uids = np.array([4, 0, 4, 39])
    np.testing.assert_array_equal(got.rows(torch.from_numpy(uids)).numpy(),
                                  np.asarray(want.rows(jnp.asarray(uids))))
