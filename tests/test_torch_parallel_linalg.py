"""The distributed Cholesky (ops/distchol.py), EASE-R and the sharded
similarity build on gloo processes against numpy and JAX's mesh builds, on
the CPU.

One spawn of 4 ranks (tests/test_torch_parallel.py's ``spawn``) runs every
case below on the (data 1, model 4) mesh and, where marked, on (data 2,
model 2); the pytest process runs the JAX package's builds on its 8-device
virtual mesh (``make_mesh`` of the same shape) from the same inputs, made
with numpy from a seed, and compares.

Cases and tolerances (JAX's own, tests/test_parallel.py:343-497):
- the column-distributed blocked Cholesky of a 64 x 64 SPD matrix in
  panels of 4 (16 columns, 4 panels a rank) and the forward and backward
  substitutions against a [64, 5] right-hand side: L within rtol 2e-4 /
  atol 2e-4 of ``numpy.linalg.cholesky``, the solve within rtol 2e-3 / atol
  2e-4 of ``numpy.linalg.solve``, and both within the same bounds of JAX's
  ``_cholesky_local`` / ``_solve_*_local`` on the same mesh;
- EASE-R ``fit(topK=10, mesh_plan=...)`` with 70 items (padded to 72 on
  model 4, panels of 18) and 80 items on (2, 2): W within rtol 1e-4 / atol
  1e-6 of JAX's mesh fit;
- ``compute_similarity(mesh_plan=...)``: cosine, tversky and euclidean with
  80 items (model 4 divides them) and 78 (it does not: 2 padded target and
  candidate columns), and Pearson on mean-centered ratings with topK 77 (its
  negative similarities must outrank the padded candidates): the same
  sparsity as JAX's mesh build and the values within rtol 1e-5 / atol 1e-6;
  every rank returns the same matrix;
- ItemKNN cosine ``fit(mesh_plan=...)`` on (2, 2): its W as JAX's mesh
  fit's, at the same bounds.
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import RANK_ENV, csr_arrays, csr_from, spawn, urm_split, worker_main  # noqa: E402

MESHES = {"1x4": dict(n_data=1, n_model=4), "2x2": dict(n_data=2, n_model=2)}
CHOL_N, CHOL_W, CHOL_RHS = 64, 4, 5
SIMILARITIES = ("cosine", "tversky", "euclidean")
SIM_KW = dict(topK=10, shrink=1.0)
PEARSON_KW = dict(topK=77, shrink=0.0)
EASE_KW = dict(topK=10, l2_norm=50.0)
KNN_KW = dict(topK=10, shrink=10.0, similarity="cosine")
#: (mesh, data) of each EASE-R case
EASE_CASES = {"padded": ("1x4", "ease70"), "2x2": ("2x2", "urm80")}


# -- the rank's side ---------------------------------------------------------------

def _case_linalg(inputs, workdir):
    from ganmf_tpu_torch.models import EASE_R_Recommender, ItemKNNCFRecommender
    from ganmf_tpu_torch.ops import distchol
    from ganmf_tpu_torch.ops.similarity import compute_similarity
    from ganmf_tpu_torch.parallel import comm, make_mesh
    from ganmf_tpu_torch.parallel.mesh import MODEL_AXIS

    cpu = torch.device("cpu")
    plans = {name: make_mesh(**kw, device="cpu") for name, kw in MESHES.items()}
    out = {}

    plan = plans["1x4"]
    G, R = torch.from_numpy(inputs["G"]), torch.from_numpy(inputs["R"])
    W = CHOL_N // plan.n_model
    me = plan.coords[MODEL_AXIS]
    Ll = distchol._cholesky_local(G[:, me * W : (me + 1) * W].contiguous(), w=CHOL_W, plan=plan)
    Y = distchol._solve_lower_local(Ll, R.clone(), w=CHOL_W, plan=plan)
    out["chol/L"] = comm.all_gather(Ll, plan, MODEL_AXIS, tiled_axis=1)
    out["chol/X"] = distchol._solve_upper_local(Ll, Y, w=CHOL_W, plan=plan)

    for name, (mesh, data) in EASE_CASES.items():
        model = EASE_R_Recommender(csr_from(inputs, data), device=cpu)
        model.fit(mesh_plan=plans[mesh], **EASE_KW)
        out[f"ease/{name}"] = model.W_sparse.toarray()

    for data in ("urm80", "urm78"):
        X = csr_from(inputs, data)
        for sim in SIMILARITIES:
            out[f"sim/{data}/{sim}"] = compute_similarity(X, sim, mesh_plan=plan, device=cpu, **SIM_KW).toarray()
    out["sim/pearson"] = compute_similarity(csr_from(inputs, "ratings78"), "pearson", mesh_plan=plan, device=cpu,
                                            **PEARSON_KW).toarray()
    out["sim/2x2/cosine"] = compute_similarity(csr_from(inputs, "urm78"), "cosine", mesh_plan=plans["2x2"],
                                               device=cpu, **SIM_KW).toarray()

    knn = ItemKNNCFRecommender(csr_from(inputs, "urm80"), device=cpu)
    knn.fit(mesh_plan=plans["2x2"], **KNN_KW)
    out["knn/W"] = knn.W_sparse.toarray()
    out["knn/device_w"] = np.asarray(knn._device_w is None)
    return out


CASES = {"linalg": _case_linalg}

if __name__ == "__main__":
    worker_main(CASES)
elif not os.environ.get(RANK_ENV):
    # -- the pytest side ---------------------------------------------------------
    import jax
    import jax.numpy as jnp
    import pytest
    import scipy.sparse as sps
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ganmf_tpu.models import ItemKNNCFRecommender as JaxItemKNN
    from ganmf_tpu.models.extras import EASE_R_Recommender as JaxEASE
    from ganmf_tpu.ops import distchol as jdist
    from ganmf_tpu.ops.similarity import compute_similarity as jax_similarity
    from ganmf_tpu.parallel import make_mesh as jax_make_mesh
    from ganmf_tpu.parallel.mesh import MODEL_AXIS as JAX_MODEL

    def _inputs():
        rng = np.random.RandomState(0)
        M = rng.randn(CHOL_N, CHOL_N).astype(np.float32)
        G = M @ M.T + CHOL_N * np.eye(CHOL_N, dtype=np.float32)
        R = rng.randn(CHOL_N, CHOL_RHS).astype(np.float32)
        urm80, _ = urm_split(50, 80)
        urm78, _ = urm_split(50, 78, seed=4)
        ease70 = sps.csr_matrix((np.random.RandomState(11).rand(40, 70) < 0.25).astype(np.float32))
        rr = np.random.RandomState(3)
        ratings78 = sps.csr_matrix(((rr.rand(40, 78) < 0.3) * rr.randint(1, 6, (40, 78))).astype(np.float32))
        data = dict(urm80=urm80, urm78=urm78, ease70=ease70, ratings78=ratings78)
        return dict(G=G, R=R, **{k: v for name, m in data.items() for k, v in csr_arrays(name, m).items()}), data

    def _jax_chol(G, R):
        plan = jax_make_mesh(**MESHES["1x4"])
        W = CHOL_N // 4

        def local(Gfull, Rfull):
            me = jax.lax.axis_index(JAX_MODEL)
            Gl = jax.lax.dynamic_slice(Gfull, (0, me * W), (CHOL_N, W))
            Ll = jdist._cholesky_local(Gl, w=CHOL_W, axis=JAX_MODEL)
            Y = jdist._solve_lower_local(Ll, Rfull, w=CHOL_W, axis=JAX_MODEL)
            return Ll, jdist._solve_upper_local(Ll, Y, w=CHOL_W, axis=JAX_MODEL)

        Ll, X = shard_map(local, mesh=plan.mesh, in_specs=(P(None, None), P(None, None)),
                          out_specs=(P(None, JAX_MODEL), P(None, None)), check_vma=False)(jnp.asarray(G),
                                                                                           jnp.asarray(R))
        return np.asarray(Ll), np.asarray(X)

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        inputs, data = _inputs()
        got = spawn("linalg", inputs, tmp_path_factory.mktemp("linalg"), script=Path(__file__))
        plans = {name: jax_make_mesh(**kw) for name, kw in MESHES.items()}
        want = {"chol": _jax_chol(inputs["G"], inputs["R"])}
        for name, (mesh, key) in EASE_CASES.items():
            m = JaxEASE(data[key])
            m.fit(mesh_plan=plans[mesh], **EASE_KW)
            want[f"ease/{name}"] = m.W_sparse
        for key in ("urm80", "urm78"):
            for sim in SIMILARITIES:
                want[f"sim/{key}/{sim}"] = jax_similarity(data[key], sim, mesh_plan=plans["1x4"], **SIM_KW)
        want["sim/pearson"] = jax_similarity(data["ratings78"], "pearson", mesh_plan=plans["1x4"], **PEARSON_KW)
        want["sim/2x2/cosine"] = jax_similarity(data["urm78"], "cosine", mesh_plan=plans["2x2"], **SIM_KW)
        knn = JaxItemKNN(data["urm80"])
        knn.fit(mesh_plan=plans["2x2"], **KNN_KW)
        want["knn/W"] = knn.W_sparse
        return got, want, inputs

    def _same_sparse(got, want):
        """tests/test_parallel.py's ``_assert_same_sparse``."""
        want = want.toarray() if sps.issparse(want) else want
        assert ((got != 0) == (want != 0)).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_distributed_cholesky_and_solves(runs):
        got, want, inputs = runs
        G, R = inputs["G"], inputs["R"]
        L_ref, X_ref = np.linalg.cholesky(G.astype(np.float64)), np.linalg.solve(G.astype(np.float64), R)
        jL, jX = want["chol"]
        for res in got:
            np.testing.assert_allclose(res["chol/L"], L_ref, rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(res["chol/X"], X_ref, rtol=2e-3, atol=2e-4)
            np.testing.assert_allclose(res["chol/L"], jL, rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(res["chol/X"], jX, rtol=2e-3, atol=2e-4)
            assert (np.triu(res["chol/L"], 1) == 0).all()

    @pytest.mark.parametrize("name", list(EASE_CASES))
    def test_ease_r_matches_jax_mesh_fit(runs, name):
        got, want, _ = runs
        for res in got:
            np.testing.assert_allclose(res[f"ease/{name}"], want[f"ease/{name}"].toarray(), rtol=1e-4, atol=1e-6)

    @pytest.mark.parametrize("key", ["urm80", "urm78"])
    @pytest.mark.parametrize("sim", SIMILARITIES)
    def test_sharded_similarity_matches_jax(runs, sim, key):
        got, want, _ = runs
        for res in got:
            _same_sparse(res[f"sim/{key}/{sim}"], want[f"sim/{key}/{sim}"])
            np.testing.assert_array_equal(res[f"sim/{key}/{sim}"], got[0][f"sim/{key}/{sim}"])

    @pytest.mark.parametrize("case", ["pearson", "2x2/cosine"])
    def test_sharded_similarity_negative_and_2x2(runs, case):
        """Pearson's negative similarities survive the -inf padding; the
        (2, 2) mesh's model axis of 2 splits 78 items evenly."""
        got, want, _ = runs
        if case == "pearson":
            assert (want["sim/pearson"].data < 0).any()  # the negative neighbours are there
        for res in got:
            _same_sparse(res[f"sim/{case}"], want[f"sim/{case}"])

    def test_itemknn_on_a_mesh_matches_jax(runs):
        got, want, _ = runs
        for res in got:
            assert bool(res["knn/device_w"])  # the csr export, as JAX's
            _same_sparse(res["knn/W"], want["knn/W"])
