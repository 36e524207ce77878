"""DisGANMF, CFGAN and CAAE fit(mesh_plan=...) on gloo processes against
JAX's mesh fits, on the CPU.

One spawn of 4 ranks (tests/test_torch_parallel.py's ``spawn``) on the
(data 2, model 2) mesh trains every case below from JAX's initial weights
(through each model's ``params_from_jax``) and JAX's draws, passed in through
the fits' seams (CFGAN's ``_epoch_uniforms`` and ``keyed_uniforms``, CAAE's
``_epoch_draws``); the pytest process runs the JAX package's fits on its
8-device virtual mesh (``make_mesh(n_data=2, n_model=2)``) and compares. 50
users x 80 items (81 for DisGANMF's and CFGAN's second cases), 2 epochs (3 for the
unmasked csr case of tests/test_parallel.py:501-519).

Cases and tolerances:
- every parameter within rtol 2e-4 / atol 2e-6 of JAX's mesh fit (JAX's own
  bound, tests/test_parallel.py:246): DisGANMF in user mode with 80 items
  (D's [81, d] first kernel degrades to replicated) and with 81 items (its
  [82, d] kernel splits by rows), CFGAN dense ZP with 80 items (D's [160, d]
  kernel in the aligned form) and 81 items (the items whole, D's [162, d]
  kernel split by JAX's rows), csr unmasked and csr masked from JAX's
  fold_in rows, CAAE with d_scatter "direct" and "dedup";
- CFGAN in bf16: the bound of tests/test_torch_parallel_fit.py (every element
  within 2.2 * lr a step, the median difference within 5% of the median
  distance the fit moved the tensor);
- each rank's shards have the shapes of JAX's addressable shards for that
  device, the degrade included (CFGAN D's first kernel in the aligned form
  has the shape of JAX's share), and every rank gathers the same full
  parameters;
- replicas are bitwise equal across the ranks that hold the same slice;
- the mesh evaluator's metrics on each mesh-trained model within 1e-5 of
  one process's on its gathered parameters;
- a checkpoint written by a mesh fit resumes on one process and a
  one-process checkpoint resumes on the mesh, to the uninterrupted run's
  parameters within rtol 2e-4 / atol 2e-6;
- a 1 x 1 plan (make_mesh() without a process group) fits bitwise as no plan.
"""

import contextlib
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import RANK_ENV, csr_arrays, csr_from, spawn, urm_split, worker_main  # noqa: E402

SEED = 42
EPOCHS = 2
CUTOFFS = [5, 20]
MESH = dict(n_data=2, n_model=2)
DIS_KW = dict(num_factors=4, d_layers=2, d_nodes=8, d_hidden_act="relu", batch_size=12, d_lr=1e-3,
              g_lr=2e-3, d_reg=1e-4, g_reg=1e-4, recon_coefficient=0.2)
CFG_KW = dict(d_nodes=8, g_nodes=16, d_layers=2, g_layers=1, scheme="ZP", d_hidden_act="tanh",
              g_hidden_act="tanh", d_lr=1e-3, g_lr=1e-3, d_reg=1e-4, g_reg=1e-4, d_batch_size=16,
              g_batch_size=32, zr_ratio=0.3, zp_ratio=0.2, zr_coefficient=0.05, allow_worse=None, freq=None)
NOMASK_KW = dict(d_nodes=8, g_nodes=8, scheme="ZR", zr_ratio=0.0, zr_coefficient=0.0, d_batch_size=16,
                 g_batch_size=16, allow_worse=None, freq=None)
CAAE_KW = dict(d_steps=2, g_steps=2, gpr_steps=2, g_layers=2, g_units=16, num_factors=6, d_bsize=128,
               m_batch=8, lmbda=0.5, beta=0.01, lr=0.05, S=0.3)
#: name: (model, item count, fit keywords, epochs)
FITS = {
    "dis_user": ("DisGANMF", 80, dict(DIS_KW), EPOCHS),
    "dis_rows": ("DisGANMF", 81, dict(DIS_KW), EPOCHS),
    "cfgan_dense": ("CFGAN", 80, dict(CFG_KW), EPOCHS),
    "cfgan_rows": ("CFGAN", 81, dict(CFG_KW), EPOCHS),
    "cfgan_csr": ("CFGAN", 80, dict(NOMASK_KW, urm_storage="csr"), 3),
    "cfgan_csr_masked": ("CFGAN", 80, dict(CFG_KW, urm_storage="csr"), EPOCHS),
    "cfgan_bf16": ("CFGAN", 80, dict(CFG_KW, compute_dtype="bf16"), EPOCHS),
    "caae_direct": ("CAAE", 80, dict(CAAE_KW, d_scatter="direct"), EPOCHS),
    "caae_dedup": ("CAAE", 80, dict(CAAE_KW, d_scatter="dedup"), EPOCHS),
}
F32_FITS = [n for n in FITS if n != "cfgan_bf16"]
#: the checkpoint cases: (model, fit keywords)
RESUMED = {"DisGANMF": dict(DIS_KW), "CFGAN": dict(CFG_KW), "CAAE": dict(CAAE_KW, d_scatter="dedup")}


def _models():
    from ganmf_tpu_torch.models import CAAE, CFGAN, DisGANMF

    return {"DisGANMF": DisGANMF, "CFGAN": CFGAN, "CAAE": CAAE}


def _params(model):
    return [t.detach().cpu().numpy() for t in model._full_params().parameters()]


def results_array(results):
    return np.asarray([list(results[c].values()) for c in CUTOFFS], np.float64)


def _caae_statics(train, kw):
    coo = train.tocoo()
    n_chunks = max(1, int(np.ceil(coo.nnz / kw["d_bsize"])))
    n_samples = max(1, 2 * int(np.median(np.ediff1d(train.indptr))))
    return n_chunks * kw["d_bsize"], kw["d_steps"] * n_chunks * kw["d_bsize"], n_samples


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


# -- the rank's side ---------------------------------------------------------------

DRAW_FIELDS = ("perm", "d_uniforms", "g_users", "g_gumbel", "g_sample", "gpr_users", "gpr_sample")


def _injected(name, inputs):
    """The patches that give fit ``name`` JAX's initial weights and draws."""
    from ganmf_tpu_torch.models import caae as pca
    from ganmf_tpu_torch.models import cfgan as pcf
    from ganmf_tpu_torch.models import disganmf as pdg

    kind = FITS[name][0]
    n_leaves = sum(1 for k in inputs if k.startswith(f"{name}/init"))
    leaves = [inputs[f"{name}/init{i}"] for i in range(n_leaves)]
    stack = contextlib.ExitStack()
    if kind == "DisGANMF":  # init_params(..., generator, device)
        stack.enter_context(_patched(pdg, "init_params", lambda *a: pdg.params_from_jax(leaves, a[-1])))
    elif kind == "CFGAN":
        g_layers = FITS[name][2].get("g_layers", 1)
        stack.enter_context(_patched(pcf, "init_params", lambda g_dims, d_dims, generator, device:
                                     pcf.params_from_jax(leaves, g_layers, device)))
        if f"{name}/uniforms" in inputs:  # [epochs, 2, padded, I]
            it = iter(inputs[f"{name}/uniforms"])
            stack.enter_context(_patched(pcf.CFGAN, "_epoch_uniforms", lambda self, n_rows, n_cols, scheme: tuple(
                torch.from_numpy(a) for a in next(it))))
        if f"{name}/rows" in inputs:  # [epochs, 2, padded, I]: JAX's fold_in rows
            table = torch.from_numpy(inputs[f"{name}/rows"])
            stack.enter_context(_patched(pcf, "keyed_uniforms", lambda seed, epoch, stream, rows, n_cols:
                                         table[epoch - 1, stream].index_select(0, rows.cpu())))
    else:
        stack.enter_context(_patched(pca, "init_params", lambda *a: pca.params_from_jax(leaves, a[-1])))
        epoch = iter(range(FITS[name][3]))

        def draws(self, *args):
            e = next(epoch)
            return pca.CAAEDraws(*(torch.from_numpy(inputs[f"{name}/draw{e}/{f}"]) for f in DRAW_FIELDS))

        stack.enter_context(_patched(pca.CAAE, "_epoch_draws", draws))
    return stack


def _slice_key(plan, spec, shape, n_cols):
    from ganmf_tpu_torch.parallel.distributed import PAIRED

    if spec == PAIRED:
        return str(plan.bounds((n_cols,), plan.item_rows))
    return str(plan.bounds(tuple(shape), spec))


def _single_copy(name, model, train):
    """A one-process model holding ``model``'s gathered parameters."""
    single = _models()[FITS[name][0]](train, seed=SEED, is_experiment=True, device=torch.device("cpu"))
    single.config = model.config
    single.params = model._full_params()
    return single


def _case_fits(inputs, workdir):
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.parallel import make_mesh
    from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer

    cpu = torch.device("cpu")
    plan = make_mesh(**MESH, device="cpu")
    splits = {n: (csr_from(inputs, f"train{n}"), csr_from(inputs, f"test{n}")) for n in (80, 81)}
    out = {}
    for name, (kind, n_items, kw, epochs) in FITS.items():
        train, test = splits[n_items]
        with _injected(name, inputs):
            model = _models()[kind](train, seed=SEED, is_experiment=True, device=cpu)
            model.fit(**kw, epochs=epochs, mesh_plan=plan)
        for i, t in enumerate(_params(model)):
            out[f"{name}/p{i}"] = t
        specs, shapes, n_cols = model.params.mesh_layout
        for i, (t, spec, shape) in enumerate(zip(model.params.parameters(), specs, shapes)):
            out[f"{name}/local{i}"] = t.detach().numpy()
            out[f"{name}/key{i}"] = np.asarray(_slice_key(plan, spec, shape, n_cols))
        got, _ = EvaluatorHoldout(test, CUTOFFS, mesh_plan=plan, device=cpu).evaluateRecommender(model)
        want, _ = EvaluatorHoldout(test, CUTOFFS, device=cpu).evaluateRecommender(_single_copy(name, model, train))
        out[f"{name}/eval"], out[f"{name}/eval_single"] = results_array(got), results_array(want)

    train, _ = splits[80]
    for kind, kw in RESUMED.items():
        # a mesh fit writes its checkpoints (rank 0), full tensors
        model = _models()[kind](train, seed=SEED, is_experiment=True, device=cpu)
        model.checkpointer = TrainCheckpointer(os.path.join(workdir, f"ck_mesh_{kind}"), every_n_epochs=2)
        model.fit(**kw, epochs=4, mesh_plan=plan)
        for i, t in enumerate(_params(model)):
            out[f"ck_mesh_{kind}/p{i}"] = t
        # a one-process checkpoint (epoch 2) resumes on the mesh
        model = _models()[kind](train, seed=SEED, is_experiment=True, device=cpu)
        model.checkpointer = TrainCheckpointer(os.path.join(workdir, f"ck_one_{kind}"), every_n_epochs=2)
        model.fit(**kw, epochs=4, mesh_plan=plan)
        for i, t in enumerate(_params(model)):
            out[f"ck_one_{kind}/p{i}"] = t
    return out


CASES = {"fits": _case_fits}

if __name__ == "__main__":
    worker_main(CASES)
elif not os.environ.get(RANK_ENV):
    # -- the pytest side ---------------------------------------------------------
    import jax
    import jax.numpy as jnp
    import pytest

    from ganmf_tpu.models import CAAE as JaxCAAE
    from ganmf_tpu.models import CFGAN as JaxCFGAN
    from ganmf_tpu.models import DisGANMF as JaxDisGANMF
    from ganmf_tpu.models import cfgan as jcf
    from ganmf_tpu.models import disganmf as jdg
    from ganmf_tpu.models.gan_base import make_batches
    from ganmf_tpu.parallel import distributed as jdist
    from ganmf_tpu.parallel import make_mesh as jax_make_mesh
    from ganmf_tpu_torch.parallel import make_mesh
    from ganmf_tpu_torch.utils.checkpoint import TrainCheckpointer
    from test_torch_caae import _jax_draws
    from test_torch_caae import _jax_init as _caae_jax_init

    CPU = torch.device("cpu")
    JAX_MODELS = {"DisGANMF": JaxDisGANMF, "CFGAN": JaxCFGAN, "CAAE": JaxCAAE}

    def _leaves(tree):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]

    def _cfgan_chain(train, kw, epochs):
        """JAX CFGAN's initial parameters, and its key chain's per-epoch
        (ZR, PM) dense planes and csr fold_in rows."""
        n_rows, n_cols = train.shape
        padded = max(make_batches(n_rows, kw["d_batch_size"])[1], make_batches(n_rows, kw["g_batch_size"])[1])
        g_dims = [n_cols] + [kw.get("g_nodes", 32)] * kw.get("g_layers", 1) + [n_cols]
        d_dims = [2 * n_cols] + [kw.get("d_nodes", 32)] * kw.get("d_layers", 1) + [1]
        k_g, k_d, ek = jax.random.split(jax.random.PRNGKey(SEED), 3)
        init = jcf.CFGANParams(G=jcf._init_mlp(k_g, g_dims), D=jcf._init_mlp(k_d, d_dims))
        planes, rows = [], []
        for _ in range(epochs):
            ek, sub = jax.random.split(ek)
            keys = jax.random.split(sub)
            planes.append([np.asarray(jax.random.uniform(k, (padded, n_cols))) for k in keys])
            r = jnp.arange(padded, dtype=jnp.int32)
            rows.append([np.asarray(jax.vmap(lambda u, b=b: jax.random.uniform(jax.random.fold_in(b, u), (n_cols,)))(r))
                         for b in keys])
        return init, np.asarray(planes, np.float32), np.asarray(rows, np.float32)

    def _caae_chain(train, kw, epochs):
        init, chain = _caae_jax_init(*train.shape, kw, SEED)
        nnz_pad, n_d_draws, n_samples = _caae_statics(train, kw)
        m = min(kw["m_batch"], train.shape[0])
        draws = []
        for _ in range(epochs):
            chain, sub = jax.random.split(chain)
            draws.append(_jax_draws(sub, nnz_pad, *train.shape, n_d_draws, kw["g_steps"], kw["gpr_steps"], m,
                                    n_samples))
        return init, draws

    def _inputs():
        inputs = {}
        for n in (80, 81):
            train, test = urm_split(n_items=n)
            inputs.update({**csr_arrays(f"train{n}", train), **csr_arrays(f"test{n}", test)})
        for name, (kind, n_items, kw, epochs) in FITS.items():
            train, _ = urm_split(n_items=n_items)
            if kind == "DisGANMF":
                init = jdg._init_params(jax.random.PRNGKey(SEED), *train.shape, kw["num_factors"],
                                        kw["d_layers"], kw["d_nodes"])
            elif kind == "CFGAN":
                init, planes, rows = _cfgan_chain(train, kw, epochs)
                if kw.get("urm_storage") == "csr":
                    inputs[f"{name}/rows"] = rows
                else:
                    inputs[f"{name}/uniforms"] = planes
            else:
                init, draws = _caae_chain(train, kw, epochs)
                for e, d in enumerate(draws):
                    inputs.update({f"{name}/draw{e}/{f}": getattr(d, f).numpy() for f in DRAW_FIELDS})
            inputs.update({f"{name}/init{i}": a for i, a in enumerate(_leaves(init))})
        return inputs

    def _one_process_checkpoints(workdir):
        train, _ = urm_split()
        for kind, kw in RESUMED.items():
            one = _models()[kind](train, seed=SEED, is_experiment=True, device=CPU)
            one.checkpointer = TrainCheckpointer(str(workdir / f"ck_one_{kind}"), every_n_epochs=2)
            one.fit(**kw, epochs=2)

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        workdir = tmp_path_factory.mktemp("gan_fits")
        _one_process_checkpoints(workdir)
        return spawn("fits", _inputs(), workdir, script=Path(__file__)), workdir

    _JAX = {}

    def _jax_fit(name):
        """JAX's mesh fit of ``name``: (its model, its leaves)."""
        if name not in _JAX:
            kind, n_items, kw, epochs = FITS[name]
            train, _ = urm_split(n_items=n_items)
            jm = JAX_MODELS[kind](train, seed=SEED, is_experiment=True)
            jm.fit(**kw, epochs=epochs, mesh_plan=jax_make_mesh(**MESH))
            _JAX[name] = jm, _leaves(jm.params)
        return _JAX[name]

    def _n_params(got, name):
        return sum(1 for k in got[0] if k.startswith(f"{name}/p"))

    def _close(got, want):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-6, err_msg=str(i))

    @pytest.mark.parametrize("name", F32_FITS)
    def test_mesh_fit_matches_jax_mesh_fit(runs, name):
        got, _ = runs
        n = _n_params(got, name)
        params = [got[0][f"{name}/p{i}"] for i in range(n)]
        for res in got[1:]:  # every rank gathers the same parameters
            for i in range(n):
                np.testing.assert_array_equal(res[f"{name}/p{i}"], params[i])
        _close(params, _jax_fit(name)[1])

    def test_bf16_mesh_fit_within_the_bf16_bound(runs):
        got, _ = runs
        _, want = _jax_fit("cfgan_bf16")
        train, _ = urm_split()
        init = _leaves(_cfgan_chain(train, CFG_KW, 1)[0])
        n_g = 2 * (CFG_KW["g_layers"] + 1)
        d_n = make_batches(train.shape[0], CFG_KW["d_batch_size"])[0]
        g_n = make_batches(train.shape[0], CFG_KW["g_batch_size"])[0]
        for i, (w, i0) in enumerate(zip(want, init)):
            steps, lr = (g_n, CFG_KW["g_lr"]) if i < n_g else (d_n, CFG_KW["d_lr"])
            diff = np.abs(got[0][f"cfgan_bf16/p{i}"] - w)
            assert diff.max() <= 2.2 * lr * steps * EPOCHS, i
            assert np.median(diff) <= 0.05 * np.median(np.abs(w - i0)), i

    _SHARDERS = {"DisGANMF": jdist.shard_disganmf_params, "CFGAN": jdist.shard_cfgan_params,
                 "CAAE": jdist.shard_caae_params}

    @pytest.mark.parametrize("name", ["dis_user", "dis_rows", "cfgan_dense", "cfgan_rows", "cfgan_csr",
                                      "caae_direct"])
    def test_each_rank_holds_what_jax_places_on_its_device(runs, name):
        """Per-rank bytes and shapes against JAX's addressable shards of the
        same placement: DisGANMF's [81, 8] kernel replicated and its [82, 8]
        split in two, CFGAN D's [160, 8] kernel as two [80, 8] shares (the
        aligned form) and its [162, 8] kernel at 81 items, whose G stays
        whole, as JAX's two row halves."""
        got, _ = runs
        kind, n_items, kw, _ = FITS[name]
        jm, _ = _jax_fit(name)
        jplan = jax_make_mesh(**MESH)
        placed = jax.tree_util.tree_leaves(_SHARDERS[kind](jm.params, jplan))
        devices = jplan.mesh.devices
        for rank, res in enumerate(got):
            dev = devices[rank // MESH["n_model"], rank % MESH["n_model"]]
            for i, leaf in enumerate(placed):
                shard, = [s for s in leaf.addressable_shards if s.device == dev]
                local = res[f"{name}/local{i}"]
                assert local.shape == tuple(shard.data.shape), (rank, i)
                assert local.nbytes == np.asarray(shard.data).nbytes, (rank, i)
        if name == "dis_user":  # the degrade: D's first kernel whole on every rank
            assert got[0][f"{name}/local2"].shape == (n_items + 1, kw["d_nodes"])
        if name == "dis_rows":
            assert got[0][f"{name}/local2"].shape == ((n_items + 1) // 2, kw["d_nodes"])

    @pytest.mark.parametrize("name", F32_FITS)
    def test_replicas_are_bitwise_equal_across_ranks(runs, name):
        got, _ = runs
        n = _n_params(got, name)
        for i in range(n):
            by_key = {}
            for res in got:
                by_key.setdefault(str(res[f"{name}/key{i}"]), []).append(res[f"{name}/local{i}"])
            for copies in by_key.values():
                for c in copies[1:]:
                    np.testing.assert_array_equal(c, copies[0])

    @pytest.mark.parametrize("name", list(FITS))
    def test_mesh_evaluator_on_the_mesh_trained_model(runs, name):
        got, _ = runs
        for res in got:
            np.testing.assert_allclose(res[f"{name}/eval"], res[f"{name}/eval_single"], rtol=1e-5, atol=1e-7)
            np.testing.assert_array_equal(res[f"{name}/eval"], got[0][f"{name}/eval"])

    @pytest.mark.parametrize("kind", list(RESUMED))
    def test_mesh_checkpoint_resumes_on_one_process(runs, kind, tmp_path):
        got, workdir = runs
        ck = tmp_path / "ck"
        shutil.copytree(workdir / f"ck_mesh_{kind}", ck)
        for f in ck.glob("*_4.pt"):
            f.unlink()  # resume from epoch 2, run epochs 3 and 4
        state = torch.load(ck / "ckpt_2.pt", weights_only=True)
        train, _ = urm_split()
        one = _models()[kind](train, seed=SEED, is_experiment=True, device=CPU)
        one.checkpointer = TrainCheckpointer(str(ck), every_n_epochs=2)
        one.fit(**RESUMED[kind], epochs=4)
        want = [got[0][f"ck_mesh_{kind}/p{i}"] for i in range(len(list(one.params.parameters())))]
        for (key, t), w in zip(state["params"].items(), want):
            assert tuple(t.shape) == w.shape, key  # full tensors in JAX's layouts
        _close([t.detach().numpy() for t in one.params.parameters()], want)

    @pytest.mark.parametrize("kind", list(RESUMED))
    def test_one_process_checkpoint_resumes_on_the_mesh(runs, kind):
        got, _ = runs
        train, _ = urm_split()
        full = _models()[kind](train, seed=SEED, is_experiment=True, device=CPU)
        full.fit(**RESUMED[kind], epochs=4)
        params = [t.detach().numpy() for t in full.params.parameters()]
        _close([got[0][f"ck_one_{kind}/p{i}"] for i in range(len(params))], params)
        _close([got[0][f"ck_mesh_{kind}/p{i}"] for i in range(len(params))], params)

    @pytest.mark.parametrize("name", ["dis_user", "cfgan_dense", "cfgan_csr_masked", "cfgan_bf16", "caae_direct",
                                      "caae_dedup"])
    def test_one_by_one_plan_fits_bitwise_as_no_plan(name):
        """make_mesh() without a process group: a 1 x 1 plan whose
        collectives are identities; the sharded epoch's arithmetic is the
        one-card epoch's, bitwise. The evaluations agree within 1e-6: on a
        mesh the scores come from the sharded forward over every training
        row, which may round other than the one-card path's product."""
        from ganmf_tpu_torch.eval import EvaluatorHoldout

        kind, n_items, kw, _ = FITS[name]
        train, test = urm_split(n_items=n_items)
        plan = make_mesh(device="cpu")
        fits = []
        for mesh_plan in (None, plan):
            m = _models()[kind](train, seed=SEED, is_experiment=True, device=CPU)
            m.fit(**kw, epochs=EPOCHS, mesh_plan=mesh_plan)
            res, _ = EvaluatorHoldout(test, CUTOFFS, mesh_plan=mesh_plan, device=CPU).evaluateRecommender(m)
            fits.append((_params(m), results_array(res)))
        (p0, r0), (p1, r1) = fits
        for a, b in zip(p0, p1):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(r1, r0, rtol=1e-6, atol=1e-9)
