"""The column-blocked similarity build (ops/similarity.py), its int8 and
scatter forms, against the port's dense route and the JAX package's
column-blocked build, on the CPU.

The byte limits are monkeypatched down in both packages (module constants;
no file of the JAX package changes), so a 700-column matrix takes slabs of
512 target columns: two slabs, the second shifted left to end at the last
column. Tolerances: on 0/1 data the column-blocked W equals the dense
route's bitwise (every Gram entry is an integer below 2^24, and the
normalization and ranking are elementwise and per column); on real-valued
data within rtol 1e-6 (the columns' sums of squares come from the host);
against JAX within the rtols of tests/test_torch_similarity.py, with its
near-tie rule.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from ganmf_tpu.ops import similarity as jsim
from ganmf_tpu_torch.ops import similarity as psim
from tests.test_torch_similarity import BINARY_RTOL, REAL_RTOL, assert_topk_close, make_urm

CPU = torch.device("cpu")
N_ROWS, N_COLS = 90, 700


def _colblock(monkeypatch, int8=True):
    for mod in (psim, jsim):
        monkeypatch.setattr(mod, "_DENSE_A_BYTE_LIMIT", 1)
        monkeypatch.setattr(mod, "_GRAM_BYTE_LIMIT", 4 * N_COLS * N_COLS - 1)
        if not int8:
            monkeypatch.setattr(mod, "_INT8_A_BYTE_LIMIT", 0)


def _routes(monkeypatch, X, int8, forms, **kw):
    """(dense route's W, the column-blocked W, JAX's column-blocked W)."""
    dense = psim.compute_similarity(X, device=CPU, **kw)
    _colblock(monkeypatch, int8)
    calls = []
    for name in ("_slab_gram_int8", "_slab_gram_scatter"):
        orig = getattr(psim, name)
        monkeypatch.setattr(psim, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    blocked = psim.compute_similarity(X, device=CPU, **kw)
    assert calls == forms
    want = jsim.compute_similarity(X, **kw)
    return dense, blocked, want


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "scatter"])
@pytest.mark.parametrize("similarity,shrink", [("cosine", 0.0), ("cosine", 10.0), ("asymmetric", 2.0),
                                               ("jaccard", 0.0), ("tversky", 1.0), ("euclidean", 0.5)])
def test_binary_colblock_is_bitwise_the_dense_route(monkeypatch, int8, similarity, shrink):
    X = make_urm(N_ROWS, N_COLS, density=0.05, seed=3)
    form = "_slab_gram_int8" if int8 else "_slab_gram_scatter"
    dense, blocked, want = _routes(monkeypatch, X, int8, [form, form], similarity=similarity, topK=40,
                                   shrink=shrink)
    assert dense.nnz > 0 and (blocked != dense).nnz == 0
    np.testing.assert_array_equal(blocked.toarray(), dense.toarray())
    assert_topk_close(blocked, want, BINARY_RTOL)


@pytest.mark.parametrize("case", ["ratings", "row_weights", "euclidean_row_weights"])
def test_real_valued_colblock_takes_the_scatter_form(monkeypatch, case):
    rng = np.random.RandomState(4)
    if case == "euclidean_row_weights":  # the reference's weighting needs a square matrix
        X = make_urm(N_COLS, N_COLS, density=0.03, seed=5)
        kw = dict(similarity="euclidean", row_weights=rng.rand(N_COLS).astype(np.float32) + 0.5)
    else:
        X = make_urm(N_ROWS, N_COLS, density=0.05, seed=5, ratings=case == "ratings")
        kw = dict(similarity="cosine", shrink=3.0)
        if case == "row_weights":
            kw["row_weights"] = rng.rand(N_ROWS).astype(np.float32) + 0.5
    dense, blocked, want = _routes(monkeypatch, X, True, ["_slab_gram_scatter"] * 2, topK=30, **kw)
    assert_topk_close(blocked, dense, 1e-6)
    assert_topk_close(blocked, want, REAL_RTOL)


def test_slab_plan_follows_jax_and_the_devices_memory(monkeypatch):
    _colblock(monkeypatch)
    assert psim.colblock_plan(2048, N_COLS, True, CPU) == (512, True)
    assert psim.colblock_plan(2048, N_COLS, False, CPU) == (512, False)
    # no useful int8 slab fits beside A8: the scatter form
    monkeypatch.setattr(psim, "device_memory_bytes", lambda device: (1 << 30) + 2048 * N_COLS + 24 * N_COLS * 511)
    assert psim.colblock_plan(2048, N_COLS, True, CPU) == (512, False)
    # JAX's rule at its default limits: slabs of 12288 columns at 65536 items
    monkeypatch.undo()
    monkeypatch.setattr(psim, "device_memory_bytes", lambda device: 80 << 30)
    assert psim.colblock_plan(26624, 65536, True, CPU) == (12288, True)
    monkeypatch.setattr(psim, "device_memory_bytes", lambda device: int(15.5 * (1 << 30)))
    # a v5e's memory caps it as JAX's :622-625 does: (15.5 GiB - A8 - 1 GiB) // (24 x 65536)
    free = int(15.5 * (1 << 30)) - 26624 * 65536 - (1 << 30)
    assert psim.colblock_plan(26624, 65536, True, CPU) == (free // (24 * 65536) // 256 * 256, True) == (8704, True)


def test_int8_slab_is_the_exact_count(monkeypatch):
    X = make_urm(N_ROWS, N_COLS, density=0.1, seed=9)
    idx, val, _, _ = psim._padded_planes(sps.csr_matrix(X), torch.ones(N_ROWS), CPU)
    A8t = psim._dense_int8_t_from_padded(idx, val, N_COLS, psim._STREAM_CHUNK)
    A = X.toarray().astype(np.float64)
    np.testing.assert_array_equal(A8t[:, :N_ROWS].T.numpy(), A.astype(np.int8))
    assert not A8t[:, N_ROWS:].any()
    G = psim._slab_gram_int8(A8t, 100, 256)
    np.testing.assert_array_equal(G.numpy(), (A.T @ A[:, 100:356]).astype(np.float32))
    Gs = psim._slab_gram_scatter(idx, val, None, N_COLS, 100, 256, psim._STREAM_CHUNK, False)
    assert torch.equal(G, Gs)


def test_colblock_refuses_device_export(monkeypatch):
    _colblock(monkeypatch)
    X = make_urm(N_ROWS, N_COLS, density=0.05, seed=3)
    with pytest.raises(ValueError, match="column-blocked"):
        psim.compute_similarity(X, export="device", device=CPU)
    with pytest.raises(ValueError, match="column-blocked"):
        jsim.compute_similarity(X, export="device")
