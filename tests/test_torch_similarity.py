"""The port's similarity builds (ops/similarity.py), ``tiled_topk`` and the
similarity scoring op (ops/simscore.py) against the JAX package's, on the CPU.

Both packages get the same seeded numpy matrices (60-90 rows, 50-70 columns,
two cold columns). Tolerances:

- ``tiled_topk`` and ``scatter_col_topk_dense``: bitwise (values and ids),
  on rows full of exact ties, rows all -inf and rows half -inf, with tiles
  narrower than the row and rows ranked in several passes;
- the Gram on 0/1 data: bitwise, on both routes (dense, streamed; the byte
  limits monkeypatched down as tests/test_scale.py:31-62 does), against
  JAX's one-pass bf16 Gram and its streamed one. Every partial
  sum is an integer below 2^24, so float32 is exact in any order;
- ``compute_similarity`` for every family and distance mode, with and without
  shrink, row weights and ``normalize_avg_row``: on 0/1 data W within rtol
  1e-6, on real-valued data (adjusted, pearson, BM25 weights, ratings with
  row weights) within rtol 1e-5 (float32 products summed in another order;
  ``pow``, ``exp`` and ``log`` of another library). The kept entries of a
  column are the same except at near ties: an entry kept by one package only
  must lie within that tolerance of the other's smallest kept value in the
  column (``assert_topk_close``, the rule of chip_smoke.py's ``ids_agree``);
- ``masked_topk_matmul``: values within rtol 1e-6, ids equal but at near
  ties, the test-pair probe within rtol 1e-6.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from ganmf_tpu.data.device import padded_csr_from_sparse as jax_padded_csr
from ganmf_tpu.ops import pallas_scorer as jscore
from ganmf_tpu.ops import similarity as jsim
from ganmf_tpu.ops.topk import scatter_col_topk_dense as jax_scatter_col_topk_dense
from ganmf_tpu.ops.topk import tiled_topk as jax_tiled_topk
from ganmf_tpu.utils.weighting import okapi_BM_25
from ganmf_tpu_torch.ops import similarity as psim
from ganmf_tpu_torch.ops import simscore, topk
from ganmf_tpu_torch.ops.topk import scatter_col_topk_dense, tiled_topk, topk_lowest_index

CPU = torch.device("cpu")
BINARY_RTOL, REAL_RTOL = 1e-6, 1e-5
COLD_COLUMNS = [2, 7]


def make_urm(n_rows=60, n_cols=50, density=0.2, seed=0, ratings=False):
    """A seeded 0/1 (or 1-5 ratings) CSR matrix whose COLD_COLUMNS are empty."""
    rng = np.random.RandomState(seed)
    dense = (rng.rand(n_rows, n_cols) < density).astype(np.float32)
    if ratings:
        dense *= rng.randint(1, 6, dense.shape).astype(np.float32)
    dense[:, COLD_COLUMNS] = 0
    return sps.csr_matrix(dense)


def assert_topk_close(got, want, rtol, atol=1e-12):
    """Two per-column top-K similarity matrices agree: the entries both keep
    within rtol; each column keeps as many entries; an entry kept by one only
    lies within rtol of the other's smallest kept value in that column (a
    near tie that two summation orders may break either way)."""
    got, want = sps.csc_matrix(got), sps.csc_matrix(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.diff(got.indptr), np.diff(want.indptr))
    g, w = got.toarray(), want.toarray()
    both = (g != 0) & (w != 0)
    np.testing.assert_allclose(g[both], w[both], rtol=rtol, atol=atol)
    for a, b in ((g, w), (w, g)):
        for r, c in zip(*np.nonzero((a != 0) & (b == 0))):
            edge = b[:, c][b[:, c] != 0].min()
            assert abs(a[r, c] - edge) <= rtol * abs(edge) + atol, (r, c, a[r, c], edge)


# -- tiled_topk -----------------------------------------------------------------


def _tie_rows(n, seed):
    """Rows on a grid of 4 values (many exact ties), one row all -inf, one
    half -inf."""
    rng = np.random.RandomState(seed)
    w = np.floor(rng.rand(9, n) * 4).astype(np.float32) - 1.0
    w[2] = -np.inf
    w[3, : n // 2] = -np.inf
    w[4, 1::3] = -np.inf
    return w


@pytest.mark.parametrize("n,k,tile", [(300, 20, 64), (300, 100, 64), (256, 256, 64), (300, 7, 300),
                                      (1000, 50, 128), (130, 1, 64)])
def test_tiled_topk_matches_jax(n, k, tile):
    w = _tie_rows(n, seed=n + k)
    v, i = tiled_topk(torch.from_numpy(w), k, tile=tile)
    jv, ji = jax_tiled_topk(jnp.asarray(w), k, tile=tile)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # lax.top_k's order: the stable full-row sort's
    fv, fi = topk_lowest_index(torch.from_numpy(w), k)
    np.testing.assert_array_equal(v.numpy(), fv.numpy())
    np.testing.assert_array_equal(i.numpy(), fi.numpy())


def test_tiled_topk_ranks_rows_in_passes(monkeypatch):
    w = torch.from_numpy(_tie_rows(500, seed=3))
    want = tiled_topk(w, 30, tile=64)
    monkeypatch.setattr(topk, "TOPK_PASS_KEYS", 1200)  # 2 rows a pass
    got = tiled_topk(w, 30, tile=64)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_scatter_col_topk_dense_matches_jax():
    w = _tie_rows(40, seed=5)[:, :40]
    w = np.concatenate([w] * 5)[:40]
    v, i = tiled_topk(torch.from_numpy(w), 6, tile=16)
    v = torch.where(torch.isfinite(v), v, 0.0)
    got = scatter_col_topk_dense(v, i)
    want = jax_scatter_col_topk_dense(jnp.asarray(v.numpy()), jnp.asarray(i.numpy().astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the Gram ---------------------------------------------------------------------


def _jax_streamed_gram(X, chunk):
    pc = jax_padded_csr(X)
    pad = (-X.shape[0]) % chunk
    idx = jnp.concatenate([pc.idx, jnp.full((pad, pc.idx.shape[1]), X.shape[1], pc.idx.dtype)])
    val = jnp.concatenate([pc.val, jnp.zeros((pad, pc.val.shape[1]), pc.val.dtype)])
    w = jnp.ones(X.shape[0] + pad, jnp.float32)
    return np.asarray(jsim._gram_streamed(idx, val, w, n_cols=X.shape[1], chunk=chunk, use_row_weights=False,
                                          bf16_ok=True))


def test_gram_is_bitwise_on_binary_data(monkeypatch):
    X = make_urm(90, 70, density=0.3, seed=1)
    rw = torch.ones(X.shape[0])
    G_dense, ss2, route = psim.build_gram(X, rw, False, CPU)
    assert route == "dense"
    exact = (X.T @ X).toarray().astype(np.float64)
    np.testing.assert_array_equal(G_dense.numpy(), exact)
    np.testing.assert_array_equal(ss2.numpy(), np.diag(exact))
    # JAX's one-pass bf16 Gram (ganmf_tpu/ops/similarity.py:155-156)
    Ab = jnp.asarray(X.toarray()).astype(jnp.bfloat16)
    np.testing.assert_array_equal(G_dense.numpy(), np.asarray(jnp.dot(Ab.T, Ab, preferred_element_type=jnp.float32)))

    monkeypatch.setattr(psim, "_DENSE_A_BYTE_LIMIT", 1)
    monkeypatch.setattr(psim, "_STREAM_CHUNK", 16)  # 90 rows: 6 chunks, the last one padded
    G_str, ss2_str, route = psim.build_gram(X, rw, False, CPU)
    assert route == "streamed"
    assert torch.equal(G_str, G_dense) and torch.equal(ss2_str, ss2)
    np.testing.assert_array_equal(G_str.numpy(), _jax_streamed_gram(X, 16))


# -- compute_similarity -------------------------------------------------------------

CASES = [
    # (similarity, data, options)
    ("cosine", "binary", {}),
    ("cosine", "binary", dict(shrink=10)),
    ("cosine", "binary", dict(shrink=3, row_weights=True)),
    ("cosine", "ratings", dict(shrink=3)),
    ("cosine", "bm25", dict(shrink=5)),
    ("adjusted", "ratings", {}),
    ("adjusted", "ratings", dict(shrink=10)),
    ("asymmetric", "binary", dict(asymmetric_alpha=0.3)),
    ("asymmetric", "binary", dict(asymmetric_alpha=1.7, shrink=5)),
    ("pearson", "ratings", {}),
    ("pearson", "ratings", dict(shrink=10, row_weights=True)),
    ("jaccard", "binary", {}),
    ("jaccard", "ratings", dict(shrink=5)),
    ("tanimoto", "binary", dict(shrink=2)),
    ("dice", "binary", {}),
    ("dice", "binary", dict(shrink=4)),
    ("tversky", "binary", {}),
    ("tversky", "binary", dict(tversky_alpha=0.3, tversky_beta=1.6, shrink=1)),
    ("euclidean", "binary", {}),
    ("euclidean", "binary", dict(similarity_from_distance_mode="exp", shrink=1)),
    ("euclidean", "binary", dict(similarity_from_distance_mode="log")),
    ("euclidean", "binary", dict(normalize=False, normalize_avg_row=True)),
    ("euclidean", "ratings", dict(normalize_avg_row=True, shrink=2)),
    ("euclidean", "square", dict(row_weights=True)),
    ("cosine", "binary", dict(normalize_avg_row=True, shrink=1)),
]


def _case_data(data):
    if data == "binary":
        return make_urm(60, 50, seed=2)
    if data == "ratings":
        return make_urm(60, 50, seed=3, ratings=True)
    if data == "bm25":
        return okapi_BM_25(make_urm(60, 50, seed=4).T).T.tocsr().astype(np.float32)
    return make_urm(50, 50, density=0.25, seed=5)  # square, for euclidean's row weights


@pytest.mark.parametrize("similarity,data,options", CASES,
                         ids=[f"{s}-{d}-{'-'.join(o)}" for s, d, o in CASES])
def test_compute_similarity_matches_jax(similarity, data, options):
    X = _case_data(data)
    options = dict(options)
    if options.pop("row_weights", False):
        options["row_weights"] = np.random.RandomState(9).rand(X.shape[0]).astype(np.float32) + 0.5
    got = psim.compute_similarity(X, similarity, topK=12, device=CPU, **options)
    want = jsim.compute_similarity(X, similarity, topK=12, **options)
    assert got.nnz > 0
    binary = data in ("binary", "square") and "row_weights" not in options
    assert_topk_close(got, want, BINARY_RTOL if binary else REAL_RTOL)
    # the cold columns have no neighbours and are no one's neighbour
    dense = got.toarray()
    assert not dense[:, COLD_COLUMNS].any() and not dense[COLD_COLUMNS].any() or similarity == "euclidean"


def test_export_device_equals_the_csr_export():
    X = make_urm(seed=6)
    dense = psim.compute_similarity(X, "cosine", topK=8, shrink=2, export="device", device=CPU)
    csr = psim.compute_similarity(X, "cosine", topK=8, shrink=2, device=CPU)
    np.testing.assert_array_equal(dense.numpy(), csr.toarray())
    want = np.asarray(jsim.compute_similarity(X, "cosine", topK=8, shrink=2, export="device"))
    assert_topk_close(sps.csr_matrix(dense.numpy()), sps.csr_matrix(want), BINARY_RTOL)


@pytest.mark.parametrize("similarity,row_weights", [("cosine", False), ("jaccard", False), ("euclidean", False),
                                                    ("cosine", True)])
def test_streamed_routes_match_dense(similarity, row_weights, monkeypatch):
    X = make_urm(70, 40, density=0.2, seed=7)
    rw = np.random.RandomState(1).rand(70).astype(np.float32) + 0.5 if row_weights else None
    dense = psim.compute_similarity(X, similarity, topK=10, shrink=1.0, row_weights=rw, device=CPU)
    monkeypatch.setattr(psim, "_DENSE_A_BYTE_LIMIT", 1)
    monkeypatch.setattr(psim, "_STREAM_CHUNK", 32)
    streamed = psim.compute_similarity(X, similarity, topK=10, shrink=1.0, row_weights=rw, device=CPU)
    if row_weights:
        # another summation order of real-valued products
        assert_topk_close(streamed, dense, REAL_RTOL)
    else:
        # the same Gram bitwise on both routes: the same W
        assert (streamed != dense).nnz == 0
    monkeypatch.setattr(jsim, "_DENSE_A_BYTE_LIMIT", 1)
    want = jsim.compute_similarity(X, similarity, topK=10, shrink=1.0, row_weights=rw)
    assert_topk_close(streamed, want, REAL_RTOL if row_weights else BINARY_RTOL)


def test_unported_routes_and_bad_arguments_raise(monkeypatch):
    X = make_urm(seed=8)
    # an object that is no plan fails as it fails JAX's build; the 1 x 1
    # plan takes the one-device route (the sharded build on 4 ranks:
    # tests/test_torch_parallel_linalg.py)
    from ganmf_tpu_torch.parallel import make_mesh

    with pytest.raises(AttributeError):
        jsim.compute_similarity(X, mesh_plan=object())
    with pytest.raises(AttributeError):
        psim.compute_similarity(X, mesh_plan=object(), device=CPU)
    one = psim.compute_similarity(X, mesh_plan=make_mesh(device="cpu"), device=CPU)
    assert (one != psim.compute_similarity(X, device=CPU)).nnz == 0
    monkeypatch.setattr(psim, "_DENSE_A_BYTE_LIMIT", 1)
    monkeypatch.setattr(psim, "_GRAM_BYTE_LIMIT", 1)
    # the column-blocked build is ported (tests/test_torch_similarity_colblock.py);
    # it refuses the dense export, as JAX's does
    with pytest.raises(ValueError, match="column-blocked"):
        psim.compute_similarity(X, export="device", device=CPU)
    with pytest.raises(ValueError, match="similarity must be one of"):
        psim.compute_similarity(X, "manhattan", device=CPU)
    with pytest.raises(ValueError, match="export"):
        psim.compute_similarity(X, export="host", device=CPU)
    with pytest.raises(ValueError, match="square"):
        psim.compute_similarity(X, "euclidean", row_weights=np.ones(X.shape[0], np.float32), device=CPU)


def test_unnormalized_cosine_divides_by_the_shrink():
    # the JAX package cannot trace this branch (it tests a traced shrink);
    # the port divides the Gram by the shrink term
    X = make_urm(seed=10)
    raw = psim.compute_similarity(X, "cosine", topK=10, normalize=False, device=CPU)
    shrunk = psim.compute_similarity(X, "cosine", topK=10, normalize=False, shrink=4, device=CPU)
    np.testing.assert_array_equal(shrunk.toarray(), (raw / np.float32(4)).toarray())


def test_csc_from_col_topk_drops_zeros_and_sentinels():
    vals = np.array([[3.0, 0.0, -np.inf], [1.0, -2.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    idx = np.array([[1, 0, 2], [2, 0, 1], [0, 1, 2]])
    W = psim.csc_from_col_topk(vals, idx, 3).toarray()
    np.testing.assert_array_equal(W, [[0, -2, 0], [3, 0, 0], [0, 1, 0]])


# -- masked_topk_matmul -------------------------------------------------------------


def _scoring_inputs(seed=0, B=12, C=80, I=80):
    rng = np.random.RandomState(seed)
    rows = (rng.rand(B, C) < 0.15).astype(np.float32)
    W = (rng.rand(C, I) * (rng.rand(C, I) < 0.3)).astype(np.float32)
    seen = rng.rand(B, I) < 0.1
    seen[3] = True  # a row with every item seen
    pair_ids = rng.randint(0, I, (B, 4))
    return rows, W, seen, pair_ids


def _assert_ranked_close(got, want, scores):
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_allclose(gv, wv, rtol=BINARY_RTOL)
    fin = np.isfinite(wv)
    assert np.array_equal(np.isfinite(gv), fin)
    diff = (gi != wi) & fin
    sa = np.take_along_axis(scores, gi, 1)[diff]
    sb = np.take_along_axis(scores, wi, 1)[diff]
    assert np.all(np.abs(sa - sb) <= BINARY_RTOL * np.abs(sb)), (sa, sb)


@pytest.mark.parametrize("form", ["f32", "mask_from_rows", "user_based", "k_past_finite"])
def test_masked_topk_matmul_matches_jax(form):
    rows, W, seen, pair_ids = _scoring_inputs(seed=len(form))
    k = W.shape[1] if form == "k_past_finite" else 20  # past a row's finite scores: -inf slots rank last
    kw = dict(mask_from_rows=form == "mask_from_rows")
    if form == "user_based":
        # W's rows against the 0/1 URM, the user-based model's operands
        rows, W = W[: rows.shape[0]], (W != 0).astype(np.float32)
    p_seen = None if kw["mask_from_rows"] else torch.from_numpy(seen)
    j_seen = None if kw["mask_from_rows"] else jnp.asarray(seen)
    p_rows, p_W = torch.from_numpy(rows), torch.from_numpy(W)
    gv, gi, gps, gpf = simscore.masked_topk_matmul(p_rows, p_W, p_seen, torch.from_numpy(pair_ids), k, **kw)
    wv, wi, wps, wpf = jscore.masked_topk_matmul(jnp.asarray(rows), jnp.asarray(W), j_seen,
                                                 jnp.asarray(pair_ids.astype(np.int32)), k=k, **kw)
    scores = (p_rows @ p_W).numpy()
    _assert_ranked_close((gv.numpy(), gi.numpy()), (np.asarray(wv), np.asarray(wi)), scores)
    np.testing.assert_array_equal(gpf.numpy(), np.asarray(wpf))
    np.testing.assert_allclose(gps.numpy(), np.asarray(wps), rtol=BINARY_RTOL)


def test_masked_topk_matmul_use_approx_raises():
    rows, W, seen, pair_ids = _scoring_inputs()
    with pytest.raises(NotImplementedError, match="use_approx"):
        simscore.masked_topk_matmul(torch.from_numpy(rows), torch.from_numpy(W), torch.from_numpy(seen),
                                    torch.from_numpy(pair_ids), 5, use_approx=True)
