"""GANMF.fit(mesh_plan=...) on gloo processes against JAX's mesh fit, on the CPU.

One spawn of 4 ranks (tests/test_torch_parallel.py's ``spawn``) trains every
case below from JAX's initial weights, passed through ``params_from_jax``;
the pytest process runs JAX's ``GANMF.fit(mesh_plan=make_mesh(...))`` on the
same mesh shape and compares. 50 users x 80 items, K=8, E=16, batches of 16
(so a padding slot replays row 0 in every epoch), 3 epochs.

Tolerances:
- every parameter within rtol 2e-4 / atol 2e-6 of JAX's mesh fit
  (tests/test_parallel.py:169-196,251-268) and the loss histories within
  rel 1e-5, for dense and csr storage, user and item mode, dense and lazy
  user Adam, on the (data 2, model 2) and the (slice 2, data 1, model 2)
  meshes;
- the bf16 case: the bound of tests/test_torch_ganmf_train.py (every element
  within 2.2 * lr a step, the median difference within 5% of the median
  distance the fit moved the tensor), the two frameworks rounding bf16 at
  other places;
- the mesh evaluator on the mesh-trained model against the one-process
  evaluator on its gathered parameters: rel 1e-5 / abs 1e-7;
- early stopping on the mesh stops at the epoch the one-process fit stops
  at, with parameters within rtol 2e-4 / atol 2e-6;
- a checkpoint written by a mesh fit resumes on one process, and a
  one-process checkpoint resumes on the mesh, to the uninterrupted run's
  parameters (rtol 2e-4 / atol 2e-6);
- the 1 x 1 plan (make_mesh() without a process group) trains bitwise as
  fit() without a plan.
"""

import os
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import RANK_ENV, csr_arrays, csr_from, spawn, urm_split, worker_main  # noqa: E402

SEED = 42
KW = dict(num_factors=8, emb_dim=16, batch_size=16, d_reg=1e-4, g_reg=1e-4)
EPOCHS = 3
CUTOFFS = [5, 20]
MESH_2X2, MESH_SLICED = dict(n_data=2, n_model=2), dict(n_data=1, n_model=2, n_slices=2)
#: name: (mesh, mode, urm_storage, lazy_user_adam, compute_dtype)
FITS = {
    "dense_user": (MESH_2X2, "user", "dense", False, "f32"),
    "csr_user": (MESH_2X2, "user", "csr", False, "f32"),
    "dense_item": (MESH_2X2, "item", "dense", False, "f32"),
    "lazy_user": (MESH_2X2, "user", "dense", True, "f32"),
    "lazy_item_csr": (MESH_2X2, "item", "csr", True, "f32"),
    "bf16_user": (MESH_2X2, "user", "dense", False, "bf16"),
    "sliced_user": (MESH_SLICED, "user", "dense", False, "f32"),
}
EVALUATED = ("dense_user", "dense_item")
STOP = dict(epochs=8, freq=1, allow_worse=1)  # the early-stopping case


def _inject(pgm, init):
    """Make the port's init_params return JAX's initial weights (by mode)."""
    pgm.init_params = lambda n_rows, n_cols, k, e, generator, device: pgm.params_from_jax(
        init[n_rows > n_cols], device)


def results_array(results):
    return np.asarray([list(results[c].values()) for c in CUTOFFS], np.float64)


def _params(model):
    return [t.detach().cpu().numpy() for t in model._full_params().parameters()]


# -- the rank's side ---------------------------------------------------------------

def _case_fits(inputs, workdir):
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import GANMF
    from ganmf_tpu_torch.models import ganmf as pgm
    from ganmf_tpu_torch.parallel import make_mesh
    from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer

    cpu = torch.device("cpu")
    train, test = csr_from(inputs, "train"), csr_from(inputs, "test")
    _inject(pgm, {False: [inputs[f"u{i}"] for i in range(6)], True: [inputs[f"i{i}"] for i in range(6)]})
    out = {}
    plans = {}

    def plan_for(mesh):
        key = tuple(sorted(mesh.items()))
        if key not in plans:
            plans[key] = make_mesh(**mesh, device="cpu")
        return plans[key]

    for name, (mesh, mode, storage, lazy, dtype) in FITS.items():
        plan = plan_for(mesh)
        model = GANMF(train, mode=mode, seed=SEED, is_experiment=True, device=cpu)
        model.fit(**KW, epochs=EPOCHS, mesh_plan=plan, urm_storage=storage, lazy_user_adam=lazy,
                  compute_dtype=dtype)
        for i, t in enumerate(_params(model)):
            out[f"{name}/p{i}"] = t
        out[f"{name}/losses"] = np.asarray([[float(d), float(g)] for d, g in
                                            zip(model.train_d_loss, model.train_g_loss)])
        out[f"{name}/local0"] = model.params.user_emb.detach()  # this rank's shard only
        if name in EVALUATED:
            got, _ = EvaluatorHoldout(test, CUTOFFS, mesh_plan=plan, device=cpu).evaluateRecommender(model)
            single = GANMF(train, mode=mode, seed=SEED, is_experiment=True, device=cpu)
            single.params = model._full_params()
            want, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(single)
            out[f"{name}/eval"], out[f"{name}/eval_single"] = results_array(got), results_array(want)

    plan = plan_for(MESH_2X2)
    model = GANMF(train, seed=SEED, is_experiment=True, device=cpu)
    out["stop/returned"] = model.fit(
        **KW, **STOP, mesh_plan=plan,
        validation_evaluator=EvaluatorHoldout(test, CUTOFFS, mesh_plan=plan, device=cpu))
    for i, t in enumerate(_params(model)):
        out[f"stop/p{i}"] = t

    # a mesh fit writes its checkpoints (rank 0), full tensors
    model = GANMF(train, seed=SEED, is_experiment=True, device=cpu)
    model.checkpointer = TrainCheckpointer(os.path.join(workdir, "ck_mesh"), every_n_epochs=2, max_to_keep=3)
    model.fit(**KW, epochs=4, mesh_plan=plan)
    for i, t in enumerate(_params(model)):
        out[f"ck_mesh/p{i}"] = t
    # a one-process checkpoint (epoch 2) resumes on the mesh
    model = GANMF(train, seed=SEED, is_experiment=True, device=cpu)
    model.checkpointer = TrainCheckpointer(os.path.join(workdir, "ck_one"), every_n_epochs=2)
    model.fit(**KW, epochs=4, mesh_plan=plan)
    for i, t in enumerate(_params(model)):
        out[f"ck_one/p{i}"] = t
    out["ck_one/losses"] = np.asarray([float(v) for v in model.train_d_loss])
    return out


CASES = {"fits": _case_fits}

if __name__ == "__main__":
    worker_main(CASES)
elif not os.environ.get(RANK_ENV):
    # -- the pytest side ---------------------------------------------------------
    import jax
    import pytest

    from ganmf_tpu.models import GANMF as JaxGANMF
    from ganmf_tpu.models import ganmf as jgm
    from ganmf_tpu.parallel import make_mesh as jax_make_mesh
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import GANMF
    from ganmf_tpu_torch.models import ganmf as pgm
    from ganmf_tpu_torch.parallel import make_mesh
    from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer

    CPU = torch.device("cpu")

    def _jax_init(n_rows, n_cols):
        return [np.asarray(t) for t in jgm._init_params(jax.random.PRNGKey(SEED), n_rows, n_cols,
                                                        KW["num_factors"], KW["emb_dim"])]

    def _inputs(train, test):
        inputs = {**csr_arrays("train", train), **csr_arrays("test", test)}
        for prefix, shape in (("u", train.shape), ("i", train.shape[::-1])):
            inputs.update({f"{prefix}{i}": a for i, a in enumerate(_jax_init(*shape))})
        return inputs

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        train, test = urm_split()
        workdir = tmp_path_factory.mktemp("fits")
        # the one-process run whose epoch-2 checkpoint the mesh resumes
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pgm, "init_params", lambda n_rows, n_cols, k, e, generator, device:
                       pgm.params_from_jax(_jax_init(n_rows, n_cols), device))
            one = GANMF(train, seed=SEED, is_experiment=True, device=CPU)
            one.checkpointer = TrainCheckpointer(str(workdir / "ck_one"), every_n_epochs=2)
            one.fit(**KW, epochs=2)
        got = spawn("fits", _inputs(train, test), workdir, script=Path(__file__))
        return got, workdir, (train, test)

    _JAX = {}

    def _jax_fit(name):
        if name not in _JAX:
            mesh, mode, storage, lazy, dtype = FITS[name]
            train, _ = urm_split()
            jm = JaxGANMF(train, mode=mode, seed=SEED, is_experiment=True)
            jm.fit(**KW, epochs=EPOCHS, mesh_plan=jax_make_mesh(**mesh), urm_storage=storage,
                   lazy_user_adam=lazy, compute_dtype=dtype)
            _JAX[name] = ([np.asarray(t) for t in jm.params],
                          np.asarray([[float(d), float(g)] for d, g in zip(jm.train_d_loss, jm.train_g_loss)]))
        return _JAX[name]

    def _port_fit(mode="user", **kw):
        """A one-process port fit from JAX's init."""
        train, test = urm_split()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pgm, "init_params", lambda n_rows, n_cols, k, e, generator, device:
                       pgm.params_from_jax(_jax_init(n_rows, n_cols), device))
            m = GANMF(train, mode=mode, seed=SEED, is_experiment=True, device=CPU)
            returned = m.fit(**KW, **kw)
        return m, returned

    def _close(got, want):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-6)

    @pytest.mark.parametrize("name", [n for n in FITS if FITS[n][4] == "f32"])
    def test_mesh_fit_matches_jax_mesh_fit(runs, name):
        got, _, _ = runs
        want, want_losses = _jax_fit(name)
        params = [got[0][f"{name}/p{i}"] for i in range(6)]
        for res in got[1:]:  # every rank gathers the same parameters and losses
            for i in range(6):
                np.testing.assert_array_equal(res[f"{name}/p{i}"], params[i])
            np.testing.assert_array_equal(res[f"{name}/losses"], got[0][f"{name}/losses"])
        _close(params, want)
        np.testing.assert_allclose(got[0][f"{name}/losses"], want_losses, rtol=1e-5)

    def test_bf16_mesh_fit_within_the_bf16_bound(runs):
        got, _, _ = runs
        want, want_losses = _jax_fit("bf16_user")
        init = _jax_init(50, 80)
        n_batches = -(-50 // KW["batch_size"])
        for i, (w, i0) in enumerate(zip(want, init)):
            g = got[0][f"bf16_user/p{i}"]
            lr = 1e-4  # fit's default d_lr and g_lr
            diff = np.abs(g - w)
            assert diff.max() <= 2.2 * lr * EPOCHS * n_batches, i
            assert np.median(diff) <= 0.05 * np.median(np.abs(w - i0)), i
        np.testing.assert_allclose(got[0]["bf16_user/losses"], want_losses, rtol=2e-2)

    def test_each_rank_holds_only_its_shard(runs):
        got, _, _ = runs
        # 50 users over 2 data ranks: 25 rows each, on the rows' owner
        full = got[0]["dense_user/p0"]
        for rank, res in enumerate(got):
            data = rank // 2
            np.testing.assert_array_equal(res["dense_user/local0"], full[25 * data : 25 * (data + 1)])

    @pytest.mark.parametrize("name", EVALUATED)
    def test_mesh_evaluator_on_the_mesh_trained_model(runs, name):
        got, _, _ = runs
        for res in got:
            np.testing.assert_allclose(res[f"{name}/eval"], res[f"{name}/eval_single"], rtol=1e-5, atol=1e-7)

    def test_early_stopping_on_the_mesh_stops_where_one_process_stops(runs):
        got, _, (train, test) = runs
        single, returned = _port_fit(**STOP, validation_evaluator=EvaluatorHoldout(test, CUTOFFS, device=CPU))
        for res in got:
            assert int(res["stop/returned"]) == returned
        assert returned < STOP["epochs"] + 1  # it did stop
        _close([got[0][f"stop/p{i}"] for i in range(6)], [t.detach().numpy() for t in single.params.parameters()])

    def test_mesh_checkpoint_resumes_on_one_process(runs, tmp_path):
        got, workdir, (train, _) = runs
        ck = tmp_path / "ck"
        shutil.copytree(workdir / "ck_mesh", ck)
        assert sorted(p.name for p in ck.iterdir()) == ["aux_2.pt", "aux_4.pt", "ckpt_2.pt", "ckpt_4.pt"]
        for kind in ("ckpt", "aux"):
            (ck / f"{kind}_4.pt").unlink()  # resume from epoch 2, run epochs 3 and 4
        state = torch.load(ck / "ckpt_2.pt", weights_only=True)
        assert tuple(state["params"]["user_emb"].shape) == (50, 8)  # full tensors
        assert tuple(state["d_state"]["state"][0]["exp_avg"].shape) == (80, 16)
        m = GANMF(train, seed=SEED, is_experiment=True, device=CPU)
        m.checkpointer = TrainCheckpointer(str(ck), every_n_epochs=2)
        m.fit(**KW, epochs=4)
        _close([t.detach().numpy() for t in m.params.parameters()], [got[0][f"ck_mesh/p{i}"] for i in range(6)])

    def test_one_process_checkpoint_resumes_on_the_mesh(runs):
        got, _, _ = runs
        full, _ = _port_fit(epochs=4)
        _close([got[0][f"ck_one/p{i}"] for i in range(6)], [t.detach().numpy() for t in full.params.parameters()])
        np.testing.assert_allclose(got[0]["ck_one/losses"], [float(v) for v in full.train_d_loss], rtol=1e-5)

    @pytest.mark.parametrize("storage", ["dense", "csr"])
    def test_one_by_one_plan_fits_bitwise_as_no_plan(storage):
        """make_mesh() without a process group: a 1 x 1 plan whose
        collectives are identities; the fit is fit()'s, bitwise."""
        train, test = urm_split()
        plan = make_mesh(device="cpu")
        assert (plan.n_data, plan.n_model, plan.n_user_shards) == (1, 1, 1) and plan.group("data") is None
        runs = []
        for mesh_plan in (None, plan):
            m = GANMF(train, seed=SEED, is_experiment=True, device=CPU)
            m.fit(**KW, epochs=2, urm_storage=storage, lazy_user_adam=True, mesh_plan=mesh_plan)
            res, _ = EvaluatorHoldout(test, CUTOFFS, mesh_plan=mesh_plan, device=CPU).evaluateRecommender(m)
            runs.append(([t.detach().numpy() for t in m.params.parameters()],
                         [float(v) for v in m.train_d_loss + m.train_g_loss], results_array(res)))
        (p0, l0, r0), (p1, l1, r1) = runs
        for a, b in zip(p0, p1):
            np.testing.assert_array_equal(a, b)
        assert l0 == l1
        np.testing.assert_array_equal(r0, r1)
