"""The JAX package's bf16 similarity routes in the port, on the CPU against
the JAX package.

- ``split_bf16_planes`` for 1-3 passes: every plane bitwise JAX's (both
  round to nearest even);
- the split-plane scoring product (``masked_topk_matmul`` on planes), item-
  and user-based: every masked score (read through the test-pair probe over
  the whole catalog) and every top value within 2e-7 of the row's largest
  |score| of JAX's, the ids' JAX scores equal to the port's values within
  that bound (a near tie may rank either way); the float32 product misses
  that bound on the same input, so the bound tells the routes apart;
- ItemKNN and UserKNN with ``_SIM_SPLIT_MIN_ITEMS`` lowered in both
  packages: the evaluator and ``recommend_fused`` take the planes, every
  metric within 1e-5 of JAX's and the lists equal to JAX's; at the threshold
  plus one neither package splits and ``recommend_fused`` gives
  ``recommend``'s lists;
- the Gram of 0/1 data on each of the five routes (dense, resident,
  streamed, the column-blocked scatter slab, the sharded block on a
  one-rank plan), reached by lowering the limits: bitwise JAX's bf16 Gram,
  through bf16 products; ``build_route`` picks the route JAX's build takes
  under the same limits and memory, resident included, and the built W
  agrees with JAX's within rtol 1e-6;
- ratings, row-weighted and centered data take no bf16 product on any
  route, and their W agrees with JAX's within rtol 1e-5.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import ganmf_tpu.models as jm
from ganmf_tpu.data.device import dense_bf16_from_padded as jax_dense_bf16
from ganmf_tpu.data.device import padded_csr_from_sparse as jax_padded_csr
from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
from ganmf_tpu.models import base as jbase
from ganmf_tpu.ops import pallas_scorer as jscore
from ganmf_tpu.ops import similarity as jsim
import ganmf_tpu_torch.models as pm
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import base as pbase
from ganmf_tpu_torch.ops import similarity as psim
from ganmf_tpu_torch.ops import simscore
from test_torch_itemknn import assert_metrics_close
from test_torch_parallel import one_rank_gloo
from test_torch_similarity import _jax_streamed_gram, assert_topk_close, make_urm

CPU = torch.device("cpu")
SCORE_GAP = 2e-7  # of the row's largest |score|
CUTOFFS = [5, 10, 20, 50]
CHUNK = 16


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


# -- the planes ---------------------------------------------------------------------

@pytest.mark.parametrize("passes", [1, 2, 3])
def test_planes_bitwise_jax(passes):
    rng = np.random.RandomState(passes)
    W = (rng.randn(300, 200) * 10.0 ** rng.uniform(-4, 4, (300, 200))).astype(np.float32)
    W[rng.rand(300, 200) < 0.3] = 0
    got = simscore.split_bf16_planes(torch.from_numpy(W), passes)
    want = jscore.split_bf16_planes(jnp.asarray(W), passes)
    assert len(got) == len(want) == passes
    for p, q in zip(got, want):
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(p.float().numpy()), _bits(np.asarray(q.astype(jnp.float32))))


# -- the plane product --------------------------------------------------------------

def _sparse_w(rng, n, m, density=0.05):
    return (rng.rand(n, m) * (rng.rand(n, m) < density)).astype(np.float32)


def _both_scores(rows, right, seen, k=20, mask_from_rows=False, jax_rows=None, jax_right=None):
    """(port, JAX) results of masked_topk_matmul with the whole catalog as the
    probe: (values, ids, scores [B, I], finite)."""
    B = (rows[0] if isinstance(rows, tuple) else rows).shape[0]
    I = (right[0] if isinstance(right, tuple) else right).shape[1]
    pair_ids = np.tile(np.arange(I), (B, 1))
    got = simscore.masked_topk_matmul(rows, right, None if seen is None else torch.from_numpy(seen),
                                      torch.from_numpy(pair_ids), k, mask_from_rows=mask_from_rows)
    want = jscore.masked_topk_matmul(jax_rows, jax_right, None if seen is None else jnp.asarray(seen),
                                     jnp.asarray(pair_ids, jnp.int32), k, mask_from_rows=mask_from_rows)
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


def _assert_scores_close(got, want):
    (gv, gi, gs, gf), (wv, wi, ws, wf) = got, want
    np.testing.assert_array_equal(gf, wf)
    scale = np.abs(ws).max(axis=1, keepdims=True)
    assert np.all(np.abs(gs - ws) <= SCORE_GAP * scale)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    assert np.all(np.abs(np.where(fin, gv - wv, 0)) <= SCORE_GAP * scale)
    # each id the port ranks has JAX's score of the port's value
    jax_at = np.take_along_axis(ws, gi, 1)
    assert np.all(np.abs(np.where(fin, jax_at - gv, 0)) <= SCORE_GAP * scale)
    return scale


def _item_inputs(seed=0, B=64, C=2000):
    rng = np.random.RandomState(seed)
    rows = (rng.rand(B, C) < 0.02).astype(np.float32)
    return rows, _sparse_w(rng, C, C)


def test_item_based_plane_scores_match_jax():
    rows, W = _item_inputs()
    planes = simscore.split_bf16_planes(torch.from_numpy(W), 2)
    jplanes = jscore.split_bf16_planes(jnp.asarray(W), 2)
    got, want = _both_scores(torch.from_numpy(rows).to(torch.bfloat16), planes, None, mask_from_rows=True,
                             jax_rows=jnp.asarray(rows).astype(jnp.bfloat16), jax_right=jplanes)
    _assert_scores_close(got, want)
    assert (got[3][rows[:, : W.shape[1]] != 0] == 0).all()  # the profile's items are masked


def test_user_based_plane_scores_match_jax():
    rng = np.random.RandomState(1)
    Wrows = _sparse_w(rng, 48, 1500, density=0.1)  # rows of a user-user W
    urm = (rng.rand(1500, 900) < 0.03).astype(np.float32)
    seen = rng.rand(48, 900) < 0.05
    planes = simscore.split_bf16_planes(torch.from_numpy(Wrows), 2)
    jplanes = jscore.split_bf16_planes(jnp.asarray(Wrows), 2)
    got, want = _both_scores(planes, torch.from_numpy(urm).to(torch.bfloat16), seen,
                             jax_rows=jplanes, jax_right=jnp.asarray(urm).astype(jnp.bfloat16))
    _assert_scores_close(got, want)


def test_float32_product_misses_the_plane_bound():
    """The float32 route is another computation than JAX's planes: on the
    same input its scores leave the 2e-7 bound."""
    rows, W = _item_inputs()
    jplanes = jscore.split_bf16_planes(jnp.asarray(W), 2)
    got, want = _both_scores(torch.from_numpy(rows), torch.from_numpy(W), None, mask_from_rows=True,
                             jax_rows=jnp.asarray(rows).astype(jnp.bfloat16), jax_right=jplanes)
    scale = np.abs(want[2]).max(axis=1, keepdims=True)
    assert (np.abs(got[2] - want[2]) > SCORE_GAP * scale).any()


def test_planes_keep_float32_outputs():
    a = torch.ones((3, 601), dtype=torch.bfloat16)
    s = simscore.bf16_mm(a, a.T)
    assert s.dtype == torch.float32 and (s == 601.0).all()  # 601 is no bf16 value
    G = torch.ones((3, 3))
    simscore.bf16_mm(a, a.T, out=G)
    assert (G == 602.0).all()


# -- the models -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def split():
    rng = np.random.RandomState(5)
    full = (rng.rand(80, 120) < 0.12).astype(np.float32)
    held = rng.rand(80, 120) < 0.2
    train, test = full * ~held, full * held
    return sps.csr_matrix(train), sps.csr_matrix(test)


MODELS = [("ItemKNNCFRecommender", dict(topK=20, shrink=10)), ("UserKNNCFRecommender", dict(topK=15, shrink=5))]


@pytest.mark.parametrize("split_planes", [True, False], ids=["planes", "float32"])
@pytest.mark.parametrize("cls,params", MODELS, ids=[c for c, _ in MODELS])
def test_knn_models_score_like_jax(cls, params, split_planes, split, monkeypatch):
    train, test = split
    limit = train.shape[1] if split_planes else train.shape[1] + 1  # the threshold counts: n_items >= limit
    for mod in (pbase, jbase):
        monkeypatch.setattr(mod, "_SIM_SPLIT_MIN_ITEMS", limit)
    products = []
    plane_product = simscore.plane_product
    monkeypatch.setattr(simscore, "plane_product", lambda *a: products.append(1) or plane_product(*a))
    model = getattr(pm, cls)(train, device=CPU)
    model.fit(**params)
    jax_model = getattr(jm, cls)(train)
    jax_model.fit(**params)
    uids = torch.arange(5)
    rows, right = model._fused_serving_operands(uids)
    jrows, jright = jax_model._fused_serving_operands(jnp.arange(5))
    assert isinstance(rows, tuple) == isinstance(jrows, tuple) and isinstance(right, tuple) == isinstance(jright, tuple)
    assert (isinstance(rows, tuple) or isinstance(right, tuple)) == split_planes
    got, _ = EvaluatorHoldout(test, CUTOFFS, device=CPU).evaluateRecommender(model)
    want, _ = JaxEvaluatorHoldout(test, CUTOFFS).evaluateRecommender(jax_model)
    assert_metrics_close(got, want, tol=1e-5)
    users = np.arange(train.shape[0])
    lists = model.recommend_fused(users, cutoff=10)
    assert lists == jax_model.recommend_fused(users, cutoff=10)
    assert bool(products) == split_planes
    if not split_planes:
        assert lists == model.recommend(users, cutoff=10)


# -- the Gram on every route ------------------------------------------------------------

def _jax_gram(X):
    Ab = jnp.asarray(X.toarray()).astype(jnp.bfloat16)
    return np.asarray(jnp.dot(Ab.T, Ab, preferred_element_type=jnp.float32))


def _jax_resident_gram(X):
    pc = jax_padded_csr(X)
    pad = (-X.shape[0]) % CHUNK
    idx = jnp.concatenate([pc.idx, jnp.full((pad, pc.idx.shape[1]), X.shape[1], pc.idx.dtype)])
    val = jnp.concatenate([pc.val, jnp.zeros((pad, pc.val.shape[1]), pc.val.dtype)])
    Ab = jax_dense_bf16(idx, val, n_cols=X.shape[1], chunk=CHUNK)
    return np.asarray(jsim._gram_resident_bf16(Ab, chunk=CHUNK))


@pytest.fixture
def limits(monkeypatch):
    """Both packages' chunk and memory made equal; returns a setter for the
    byte limits and the memory."""
    monkeypatch.setattr(psim, "_STREAM_CHUNK", CHUNK)

    def set_limits(dense=6 << 30, gram=6 << 30, int8=9 << 30, memory=int(15.5 * (1 << 30))):
        for mod in (psim, jsim):
            monkeypatch.setattr(mod, "_DENSE_A_BYTE_LIMIT", dense)
            monkeypatch.setattr(mod, "_GRAM_BYTE_LIMIT", gram)
            monkeypatch.setattr(mod, "_INT8_A_BYTE_LIMIT", int8)
        monkeypatch.setattr(jsim, "_CHIP_HBM_BYTES", memory)
        monkeypatch.setattr(psim, "device_memory_bytes", lambda device: memory)

    return set_limits


@pytest.fixture
def bf16_calls(monkeypatch):
    calls = []
    bf16_mm = psim.bf16_mm
    monkeypatch.setattr(psim, "bf16_mm", lambda *a, **k: calls.append(a[0].dtype) or bf16_mm(*a, **k))
    return calls


def _captured_grams(monkeypatch):
    """The Gram blocks ``_w_block`` normalizes, with their target offsets."""
    grams = []
    w_block = psim._w_block
    monkeypatch.setattr(psim, "_w_block", lambda G, s1, s2, off, *a, **k: grams.append((G.clone(), off))
                        or w_block(G, s1, s2, off, *a, **k))
    return grams


#: route: limits that send a 90 x 70 binary matrix there
ROUTE_LIMITS = {
    "dense": dict(),
    "resident": dict(dense=1),
    "streamed": dict(dense=1, memory=(1 << 30) + 1),  # 1 GiB of headroom and nothing else
    "colblock": dict(dense=1, gram=4 * 70 * 70 - 1, int8=0),
}


@pytest.mark.parametrize("route", list(ROUTE_LIMITS) + ["sharded"])
def test_gram_bitwise_jax_on_every_route(route, limits, bf16_calls, monkeypatch):
    X = make_urm(90, 70, density=0.3, seed=1)
    limits(**ROUTE_LIMITS.get(route, {}))
    want = _jax_gram(X)
    ones = torch.ones(X.shape[0])
    if route in ("dense", "resident", "streamed"):
        G, ss2, got = psim.build_gram(X, ones, False, CPU, binary=True)
        assert got == route
        np.testing.assert_array_equal(_bits(G.numpy()), _bits(want))
        np.testing.assert_array_equal(ss2.numpy(), np.diag(want))
        if route == "resident":
            np.testing.assert_array_equal(_bits(G.numpy()), _bits(_jax_resident_gram(X)))
        if route == "streamed":
            np.testing.assert_array_equal(_bits(G.numpy()), _bits(_jax_streamed_gram(X, CHUNK)))
    elif route == "colblock":
        grams = _captured_grams(monkeypatch)
        W = psim.compute_similarity(X, "cosine", topK=10, device=CPU)
        assert len(grams) == 1 and grams[0][0].shape == (70, 70)  # one slab: at least 512 columns wide
        for G, off in grams:
            np.testing.assert_array_equal(_bits(G.numpy()), _bits(want[:, off : off + G.shape[1]]))
        assert_topk_close(W, jsim.compute_similarity(X, "cosine", topK=10), 1e-6)
    else:
        grams = _captured_grams(monkeypatch)
        kw = dict(mode="cosine", topk=10, shrink=0.0, normalize=True, asymmetric_alpha=0.5, tversky_alpha=1.0,
                  tversky_beta=1.0, normalize_avg_row=False, distance_mode="lin", use_row_weights=False)
        with one_rank_gloo() as plan:
            psim.similarity_topk_sharded(torch.from_numpy(X.toarray()), ones, False, X.shape[0], plan,
                                         binary=True, **kw)
        (G, off), = grams
        np.testing.assert_array_equal(_bits(G.numpy()), _bits(want))
    assert bf16_calls and set(bf16_calls) == {torch.bfloat16}  # every product a bf16 one


def _jax_route(monkeypatch, X, similarity="cosine", **kw):
    """The route JAX's compute_similarity takes, read from the functions it
    calls, and its W."""
    seen = []
    for name, route in (("_similarity_topk", "dense"), ("_gram_resident_bf16", "resident"),
                        ("_gram_streamed", "streamed"), ("_similarity_topk_colblock", "colblock"),
                        ("_similarity_topk_colblock_int8", "colblock")):
        fn = getattr(jsim, name)
        monkeypatch.setattr(jsim, name, lambda *a, _fn=fn, _route=route, **k: seen.append(_route) or _fn(*a, **k))
    W = jsim.compute_similarity(X, similarity, topK=10, **kw)
    return seen[0], W


@pytest.mark.parametrize("route", list(ROUTE_LIMITS))
def test_build_route_is_jax_route(route, limits, monkeypatch):
    X = make_urm(90, 70, density=0.3, seed=2)
    limits(**ROUTE_LIMITS[route])
    want, jW = _jax_route(monkeypatch, X)
    row_len = int(np.ediff1d(X.indptr).max())
    assert psim.build_route(*X.shape, binary=True, row_len=row_len, device=CPU) == want == route
    assert_topk_close(psim.compute_similarity(X, "cosine", topK=10, device=CPU), jW, 1e-6)


# -- float32 where the data is not binary -----------------------------------------------

FLOAT32_CASES = [
    ("cosine", "ratings", False),
    ("cosine", "binary", True),  # row weights
    ("adjusted", "ratings", False),
    ("pearson", "binary", False),
]


@pytest.mark.parametrize("route", ["dense", "streamed"])
@pytest.mark.parametrize("similarity,data,weighted", FLOAT32_CASES,
                         ids=[f"{s}-{d}{'-weighted' if w else ''}" for s, d, w in FLOAT32_CASES])
def test_non_binary_data_stays_float32(similarity, data, weighted, route, limits, bf16_calls, monkeypatch):
    """Past the dense limit, with room for the resident route, JAX and the
    port stream these inputs in float32."""
    X = make_urm(90, 70, density=0.3, seed=3, ratings=data == "ratings")
    limits(**ROUTE_LIMITS["dense" if route == "dense" else "resident"])
    kw = dict(shrink=2.0)
    if weighted:
        kw["row_weights"] = np.random.RandomState(4).rand(X.shape[0]).astype(np.float32) + 0.5
    want, jW = _jax_route(monkeypatch, X, similarity, **kw)
    assert want == route
    W = psim.compute_similarity(X, similarity, topK=10, device=CPU, **kw)
    assert not bf16_calls
    assert_topk_close(W, jW, 1e-5)
