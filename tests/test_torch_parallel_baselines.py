"""IALS, MF-SGD and SLIM-BPR fit(mesh_plan=...) on gloo processes against
JAX's mesh fits, on the CPU.

One spawn of 4 ranks (tests/test_torch_parallel.py's ``spawn``) on the
(data 2, model 2) mesh runs every case below; the pytest process runs the
JAX package's fits on its 8-device virtual mesh (``make_mesh(n_data=2,
n_model=2)``) from the same inputs and compares. 50 users x 80 items. IALS
starts from the reference's numpy initialisation in both packages; MF-SGD
and SLIM-BPR train from JAX's draws, passed in through the fits' draw seams
(``_draw`` and ``_triples``).

Cases and tolerances:
- IALS dense, padded csr and flat csr (the byte limit set to 1), 3 epochs
  at JAX's own mesh-test settings (tests/test_parallel.py:271-316): U and V
  within rtol 2e-4 / atol 2e-6 of JAX's mesh fit; the same three with 8-row
  chunks (``chunk_rows`` set to 8 in both fits, so that each rank solves
  several chunks, the dense products are summed over the shards and a dense
  chunk is split between two data ranks): dense each factor row within 1e-4
  of its norm of the port's one-process fit
  (tests/test_torch_ials.py's ``ROW_GAP`` for 8-row chunks: the shards'
  partial Gram sums change the float32 order, and several CG exits a
  half-step carry that on), padded and flat csr bitwise equal to it;
- MF-SGD BPR (dense and csr), AsySVD with biases (dense) and FunkSVD with
  biases and plain SGD (csr): the factors and biases within rtol 1e-4 /
  atol 1e-5 of JAX's mesh fit (the port's one-card bound,
  tests/test_torch_mf_sgd.py); the sharded draws bitwise equal to the
  one-process draws from the same seed, dense and csr;
- SLIM-BPR asymmetric and symmetric, adagrad, adam and rmsprop: the trained
  dense W (gathered) within rtol 1e-5 plus 1e-5 of max|W| of JAX's mesh fit's (the
  numbers of the port's one-card bound, tests/test_torch_slim_bpr.py, held
  before the prune: at lr 0.05 AdaGrad's first steps are exactly 0.05, and
  the prune breaks those exact ties by differences of one rounding), and
  the pruned ``W_sparse`` bitwise the port's one-process export; the
  sharded triples bitwise the one-process triples;
- the mesh evaluator on the mesh-trained IALS and MF-SGD models (K1 on each
  rank's item shard) within 1e-5 of one process's evaluation of the same
  factors, the same on every rank;
- a checkpoint written by a mesh fit resumes on one process, and a
  one-process checkpoint resumes on the mesh, to the uninterrupted
  one-process fit within rtol 2e-4 / atol 2e-6, for each of the three models.
"""

import contextlib
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import RANK_ENV, csr_arrays, csr_from, spawn, urm_split, worker_main  # noqa: E402

MESH = dict(n_data=2, n_model=2)
CUTOFFS = [5, 20]
IALS_KW = dict(epochs=3, num_factors=4, confidence_scaling="log", alpha=2.0)
IALS_CASES = {"dense": dict(urm_storage="dense"), "padded": dict(urm_storage="csr"),
              "flat": dict(urm_storage="csr")}
SMALL_CHUNK = 8
MF_KW = dict(epochs=2, num_factors=4, learning_rate=0.05, batch_size=16, samples_per_epoch=160, user_reg=1e-3,
             item_reg=1e-3, bias_reg=1e-2, random_seed=11)
MF_N_CHUNKS = 10
#: name: (class, fit keywords)
MF_CASES = {"bpr_dense": ("MatrixFactorization_BPR", dict(urm_storage="dense")),
            "bpr_csr": ("MatrixFactorization_BPR", dict(urm_storage="csr")),
            "asy_dense": ("MatrixFactorization_AsySVD", dict(urm_storage="dense", use_bias=True)),
            "funk_csr": ("MatrixFactorization_FunkSVD", dict(urm_storage="csr", use_bias=True, sgd_mode="sgd"))}
SLIM_KW = dict(epochs=2, topK=12, learning_rate=0.05, lambda_i=1e-3, lambda_j=1e-4, chunk_size=16, random_seed=11,
               presample=True)
SLIM_CASES = {f"{'sym' if sym else 'asym'}_{mode}": dict(symmetric=sym, sgd_mode=mode)
              for sym in (False, True) for mode in ("adagrad", "adam", "rmsprop")}
CKPT_EPOCHS = 4
ROW_GAP = 1e-4  # tests/test_torch_ials.py's


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _storage_patch(name):
    """The byte-limit patch that forces IALS case ``name``'s storage."""
    from ganmf_tpu_torch.models import ials

    return _patched(ials, "_PAD_PLANE_BYTE_LIMIT", 1 if name == "flat" else ials._PAD_PLANE_BYTE_LIMIT)


def _factors(model):
    return [np.asarray(model.USER_factors), np.asarray(model.ITEM_factors)]


# -- the rank's side ---------------------------------------------------------------

def _evaluate(model, test, plan):
    """(metrics on the mesh, metrics of one process on the same factors)."""
    from ganmf_tpu_torch.eval import EvaluatorHoldout

    cpu = torch.device("cpu")
    on_mesh, _ = EvaluatorHoldout(test, CUTOFFS, mesh_plan=plan, device=cpu).evaluateRecommender(model)
    alone, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(model)
    return [np.asarray([list(r[c].values()) for c in CUTOFFS]) for r in (on_mesh, alone)]


def _mf_draws(inputs, name):
    """The model's ``_draw`` replaced by JAX's draws, an epoch at a time."""
    epochs = iter(range(MF_KW["epochs"] * 4))

    def draw(shape):
        e = next(epochs) % MF_KW["epochs"]
        return tuple(torch.from_numpy(inputs[f"mf_{name}_{t}"][e]) for t in ("u", "i", "r", "j"))

    return draw


def _slim_triples(inputs):
    epochs = iter(range(SLIM_KW["epochs"] * 4))

    def triples(n):
        e = next(epochs) % SLIM_KW["epochs"]
        return tuple(torch.from_numpy(inputs[f"slim_{t}"][e]) for t in ("u", "i", "j"))

    return triples


def _case_baselines(inputs, workdir):
    import torch.distributed as dist

    from ganmf_tpu_torch import models
    from ganmf_tpu_torch.models import ials, mf_sgd, slim_bpr
    from ganmf_tpu_torch.parallel import Shards, make_mesh
    from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer

    cpu = torch.device("cpu")
    plan = make_mesh(**MESH, device="cpu")
    train, test = csr_from(inputs, "train"), csr_from(inputs, "test")
    out = {}

    # IALS at JAX's settings, then in 8-row chunks against one process
    for name, kw in IALS_CASES.items():
        with _storage_patch(name):
            model = models.IALSRecommender(train, device=cpu)
            model.fit(mesh_plan=plan, **IALS_KW, **kw)
            out[f"ials/{name}/form"] = np.asarray(model._store_users[0] + "/" + model._store_items[0])
            out[f"ials/{name}/U"], out[f"ials/{name}/V"] = _factors(model)
            if name == "dense":
                out["ials/eval/mesh"], out["ials/eval/alone"] = _evaluate(model, test, plan)
            with _patched(ials, "chunk_rows", lambda K, n: SMALL_CHUNK):
                meshed = models.IALSRecommender(train, device=cpu)
                meshed.fit(mesh_plan=plan, **IALS_KW, **kw)
                alone = models.IALSRecommender(train, device=cpu)
                alone.fit(**IALS_KW, **kw)
            out[f"ials_small/{name}/mesh"] = np.concatenate(_factors(meshed))
            out[f"ials_small/{name}/alone"] = np.concatenate(_factors(alone))
            out[f"ials_small/{name}/rows"] = np.asarray([meshed._rows_u.rows, meshed._rows_i.rows])
            out[f"ials_small/{name}/its"] = np.asarray([[it for it, _ in epoch] for epoch in meshed.cg_log])
            out[f"ials_small/{name}/alone_its"] = np.asarray([[it for it, _ in epoch] for epoch in alone.cg_log])

    # the sharded draws against the one-process draws from one seed
    lay = Shards(plan, *train.shape)
    for storage in ("dense", "csr"):
        want = mf_sgd.draw_samples(mf_sgd.build_tables(train, cpu, storage), (200,), True,
                                   torch.Generator().manual_seed(5))
        got = mf_sgd.draw_samples(mf_sgd.build_tables(train, cpu, storage, lay), (200,), True,
                                  torch.Generator().manual_seed(5), lay)
        out[f"draws/mf/{storage}"] = np.asarray([bool(torch.equal(a, b)) for a, b in zip(got, want)])
    mask = train.copy()
    mask.data = np.ones_like(mask.data)
    want = slim_bpr.draw_triples(slim_bpr.build_tables(mask, cpu), 200, torch.Generator().manual_seed(6))
    got = slim_bpr.draw_triples(slim_bpr.build_tables(mask, cpu, lay), 200, torch.Generator().manual_seed(6), lay)
    out["draws/slim"] = np.asarray([bool(torch.equal(a, b)) for a, b in zip(got, want)])

    # MF-SGD from JAX's draws
    for name, (cls, kw) in MF_CASES.items():
        model = getattr(models, cls)(train, device=cpu)
        model._draw = _mf_draws(inputs, name)
        model.fit(mesh_plan=plan, **MF_KW, **kw)
        out[f"mf/{name}/U"], out[f"mf/{name}/V"] = _factors(model)
        if model.use_bias:
            out[f"mf/{name}/bU"], out[f"mf/{name}/bV"] = np.asarray(model.USER_bias), np.asarray(model.ITEM_bias)
            out[f"mf/{name}/bG"] = np.asarray(model.GLOBAL_bias)
        if name == "bpr_dense":
            out["mf/eval/mesh"], out["mf/eval/alone"] = _evaluate(model, test, plan)

    # SLIM-BPR from JAX's triples
    for name, kw in SLIM_CASES.items():
        model = models.SLIM_BPR(train, device=cpu)
        model._triples = _slim_triples(inputs)
        model.fit(mesh_plan=plan, **SLIM_KW, **kw)
        out[f"slim/{name}/W"] = model._full_w(model._state.W)
        out[f"slim/{name}/export"] = model.W_sparse.toarray()
        alone = models.SLIM_BPR(train, device=cpu)
        alone._triples = _slim_triples(inputs)
        alone.fit(**SLIM_KW, **kw)
        out[f"slim/{name}/alone"] = alone.W_sparse.toarray()

    # checkpoints across plans: a mesh checkpoint resumed on one process,
    # a one-process checkpoint resumed on the mesh (rank 0 writes, all read)
    ckpt = {"ials": ("IALSRecommender", dict(IALS_KW, epochs=CKPT_EPOCHS)),
            "mf": ("MatrixFactorization_BPR", dict(MF_KW, epochs=CKPT_EPOCHS)),
            "slim": ("SLIM_BPR", dict(SLIM_KW, epochs=CKPT_EPOCHS))}
    for key, (cls, kw) in ckpt.items():
        def fit(directory, epochs, mesh):
            model = getattr(models, cls)(train, device=cpu)
            model.checkpointer = TrainCheckpointer(os.path.join(workdir, directory), every_n_epochs=2)
            model.fit(**dict(kw, epochs=epochs), mesh_plan=plan if mesh else None)
            return model

        def result(model):
            if key == "slim":
                return model.W_sparse.toarray().ravel()
            return np.concatenate([f.ravel() for f in _factors(model)])

        fit(f"{key}_mesh", 2, True)  # a mesh checkpoint at epoch 2
        dist.barrier()
        if plan.rank == 0:
            fit(f"{key}_one", 2, False)  # a one-process checkpoint at epoch 2
            out[f"ckpt/{key}/one_from_mesh"] = result(fit(f"{key}_mesh", CKPT_EPOCHS, False))
            out[f"ckpt/{key}/whole"] = result(fit(f"{key}_whole", CKPT_EPOCHS, False))
        dist.barrier()
        out[f"ckpt/{key}/mesh_from_one"] = result(fit(f"{key}_one", CKPT_EPOCHS, True))
    return out


CASES = {"baselines": _case_baselines}

if __name__ == "__main__":
    worker_main(CASES)
elif not os.environ.get(RANK_ENV):
    # -- the pytest side ---------------------------------------------------------
    import jax
    import jax.numpy as jnp
    import pytest

    from ganmf_tpu import models as jmodels
    from ganmf_tpu.data.device import padded_csr_from_sparse as jax_padded
    from ganmf_tpu.models import ials as jials
    from ganmf_tpu.models import mf_sgd as jm
    from ganmf_tpu.models import slim_bpr as js
    from ganmf_tpu.parallel import make_mesh as jax_make_mesh

    def _jax_mf_draws(train, with_neg):
        """JAX's presampled draws of each epoch of a fit with MF_KW (its key
        chain: one split an epoch from the seed, :157-166)."""
        lens = np.ediff1d(train.indptr)
        pc = jax_padded(train, cache=False)
        tables = (jnp.asarray(train.toarray()), pc.val, jnp.asarray(np.where(lens > 0)[0].astype(np.int32)), pc.idx,
                  jnp.asarray(np.maximum(lens, 1).astype(np.int32)))
        key, out = jax.random.PRNGKey(MF_KW["random_seed"]), []
        for _ in range(MF_KW["epochs"]):
            key, sub = jax.random.split(key)
            out.append(jm._draw_samples(*tables, train.shape[1], sub, (MF_N_CHUNKS, MF_KW["batch_size"]), with_neg))
        return [np.stack([np.asarray(d[t]) for d in out]).astype(np.float32 if t == 2 else np.int64)
                for t in range(4)]

    def _jax_slim_triples(train):
        mask = train.copy()
        mask.data = np.ones_like(mask.data)
        lens = np.ediff1d(mask.indptr)
        warm = np.where((lens > 0) & (lens < mask.shape[1]))[0].astype(np.int32)
        pad = np.zeros((mask.shape[0], max(int(lens.max()), 1)), np.int32)
        for u in range(mask.shape[0]):
            pad[u, : lens[u]] = mask.indices[mask.indptr[u] : mask.indptr[u + 1]]
        tables = (jnp.asarray(mask.toarray()), jnp.asarray(warm), jnp.asarray(pad),
                  jnp.asarray(np.maximum(lens, 1).astype(np.int32)))
        n = -(-mask.shape[0] // SLIM_KW["chunk_size"])
        key, out = jax.random.PRNGKey(SLIM_KW["random_seed"]), []
        for _ in range(SLIM_KW["epochs"]):
            key, sub = jax.random.split(key)
            out.append(js._draw_triples(*tables, sub, (n * SLIM_KW["chunk_size"],)))
        return [np.stack([np.asarray(d[t]) for d in out]).astype(np.int64) for t in range(3)]

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        train, test = urm_split(50, 80)
        inputs = dict(**csr_arrays("train", train), **csr_arrays("test", test))
        for name, (cls, kw) in MF_CASES.items():
            draws = _jax_mf_draws(train, with_neg=cls == "MatrixFactorization_BPR")
            inputs.update({f"mf_{name}_{t}": d for t, d in zip("uirj", draws)})
        inputs.update({f"slim_{t}": d for t, d in zip("uij", _jax_slim_triples(train))})
        got = spawn("baselines", inputs, tmp_path_factory.mktemp("baselines"), script=Path(__file__))

        jplan = jax_make_mesh(**MESH)
        want = {}
        for name, kw in IALS_CASES.items():
            limit = jials._PAD_PLANE_BYTE_LIMIT
            jials._PAD_PLANE_BYTE_LIMIT = 1 if name == "flat" else limit
            try:
                m = jmodels.IALSRecommender(train)
                m.fit(mesh_plan=jplan, **IALS_KW, **kw)
            finally:
                jials._PAD_PLANE_BYTE_LIMIT = limit
            form = getattr(m, "_store_users", ("dense",))[0]
            want[f"ials/{name}"] = (np.asarray(m._U_dev), np.asarray(m._V_dev), form)
        for name, (cls, kw) in MF_CASES.items():
            m = getattr(jm, cls)(train)
            m.fit(mesh_plan=jplan, **MF_KW, **kw)
            want[f"mf/{name}"] = m
        for name, kw in SLIM_CASES.items():
            m = jmodels.SLIM_BPR(train)
            m.fit(mesh_plan=jplan, **SLIM_KW, **kw)
            want[f"slim/{name}"] = np.asarray(m._state.W)
        return got, want

    @pytest.mark.parametrize("name", list(IALS_CASES))
    def test_ials_matches_jax_mesh_fit(runs, name):
        got, want = runs
        U, V, form = want[f"ials/{name}"]
        assert form == ("flat_sharded" if name == "flat" else name)
        for res in got:
            assert str(res[f"ials/{name}/form"]) == ("flat/flat" if name == "flat" else f"{name}/{name}")
            np.testing.assert_allclose(res[f"ials/{name}/U"], U, rtol=2e-4, atol=2e-6)
            np.testing.assert_allclose(res[f"ials/{name}/V"], V, rtol=2e-4, atol=2e-6)

    @pytest.mark.parametrize("name", list(IALS_CASES))
    def test_ials_in_small_chunks_matches_one_process(runs, name):
        """8-row chunks, several a rank: dense in JAX's placements (25 users
        a data rank, so that the chunk of users 24-31 is split between the
        two; 40 items a model rank), padded and flat csr in JAX's flat
        ranges of whole chunks (50 users in 64 padded rows, 32 and 18 real a
        data rank); csr bitwise."""
        got, _ = runs
        rows = sorted({tuple(int(x) for x in res[f"ials_small/{name}/rows"][:2]) for res in got})
        assert rows == ([(25, 40)] if name == "dense" else [(18, 40), (32, 40)])
        for res in got:
            mesh, alone = res[f"ials_small/{name}/mesh"], res[f"ials_small/{name}/alone"]
            if name == "dense":
                gap = np.abs(mesh - alone).max(axis=1) / np.linalg.norm(alone, axis=1)
                assert gap.max() <= ROW_GAP, gap.max()
                # every rank steps through every chunk; in the first epoch,
                # from the same start, each stops where one process stops
                # (later, the summation order moves a chunk at the rtol edge
                # by an iteration)
                its, alone_its = res[f"ials_small/{name}/its"], res[f"ials_small/{name}/alone_its"]
                assert its.shape == alone_its.shape
                np.testing.assert_array_equal(its[0], alone_its[0])
            else:
                np.testing.assert_array_equal(mesh, alone)

    def test_sharded_draws_are_the_one_process_draws(runs):
        got, _ = runs
        for res in got:
            assert res["draws/mf/dense"].all() and res["draws/mf/csr"].all() and res["draws/slim"].all()

    @pytest.mark.parametrize("name", list(MF_CASES))
    def test_mf_sgd_matches_jax_mesh_fit(runs, name):
        got, want = runs
        jax_model = want[f"mf/{name}"]
        close = dict(rtol=1e-4, atol=1e-5)
        for res in got:
            np.testing.assert_allclose(res[f"mf/{name}/U"], jax_model.USER_factors, **close)
            np.testing.assert_allclose(res[f"mf/{name}/V"], jax_model.ITEM_factors, **close)
            if jax_model.use_bias:
                np.testing.assert_allclose(res[f"mf/{name}/bU"], jax_model.USER_bias, **close)
                np.testing.assert_allclose(res[f"mf/{name}/bV"], jax_model.ITEM_bias, **close)
                assert float(res[f"mf/{name}/bG"]) == pytest.approx(jax_model.GLOBAL_bias, rel=1e-4, abs=1e-5)

    @pytest.mark.parametrize("name", list(SLIM_CASES))
    def test_slim_bpr_matches_jax_mesh_fit(runs, name):
        got, want = runs
        W = want[f"slim/{name}"]
        scale = np.abs(W).max()
        for res in got:
            np.testing.assert_allclose(res[f"slim/{name}/W"], W, rtol=1e-5, atol=1e-5 * scale)
            np.testing.assert_array_equal(res[f"slim/{name}/export"], res[f"slim/{name}/alone"])

    @pytest.mark.parametrize("model", ["ials", "mf"])
    def test_mesh_evaluation_matches_one_process(runs, model):
        got, _ = runs
        for res in got:
            np.testing.assert_allclose(res[f"{model}/eval/mesh"], res[f"{model}/eval/alone"], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(res[f"{model}/eval/mesh"], got[0][f"{model}/eval/mesh"])

    @pytest.mark.parametrize("model", ["ials", "mf", "slim"])
    def test_checkpoints_resume_across_plans(runs, model):
        got, _ = runs
        whole = got[0][f"ckpt/{model}/whole"]
        np.testing.assert_allclose(got[0][f"ckpt/{model}/one_from_mesh"], whole, rtol=2e-4, atol=2e-6)
        for res in got:
            np.testing.assert_allclose(res[f"ckpt/{model}/mesh_from_one"], whole, rtol=2e-4, atol=2e-6)
