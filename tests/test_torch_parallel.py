"""The port's mesh layer on the CPU: gloo processes against JAX's mesh.

Each check spawns 4 processes of this file run as a script (``__main__``
below, as tests/mp_worker.py is for the JAX package), joined by gloo on the
CPU; each rank writes its results to an .npz file, and the pytest process,
whose JAX has the 8-device virtual mesh of tests/conftest.py, computes JAX's
side and compares. Every spawn has a timeout: a hung collective fails the
test. tests/test_torch_parallel_fit.py and tests/test_torch_parallel_eval.py
spawn through ``spawn`` here.

Checks and tolerances (those of JAX's own mesh tests, tests/test_parallel.py):
- make_mesh's axis sizes and coordinates on (2, 2), (1, 4) and (slice 2,
  data 1, model 2), and ``put``'s degrade rule against JAX's ``MeshPlan.put``
  on odd shapes (50 users over a 4-way user axis, 3706 items over 4): exact;
- the named collectives over each axis set against numpy (1e-6), and the
  autograd operators' gradients against unsharded autograd (within 1e-6 of
  the largest gradient: float32 partial sums added in another order);
- ``sharded_topk``: ids bitwise JAX's, with ties across shards, signed zeros
  and rows that are -inf throughout;
- one distributed GANMF step against JAX's ``make_distributed_ganmf_step``
  from the same params: losses within rel 1e-5, user_emb within rtol 1e-4 /
  atol 1e-6 (tests/test_parallel.py:139-166).
"""

import contextlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT = 300  # seconds for a whole spawn; a hung collective fails it
#: set in the ranks' environment: a rank imports these files for their
#: worker code only, never their JAX side
RANK_ENV = "GANMF_TORCH_MESH_RANK"
MESHES = {"2x2": dict(n_data=2, n_model=2), "1x4": dict(n_data=1, n_model=4),
          "s2x1x2": dict(n_data=1, n_model=2, n_slices=2)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_gloo():
    """A world of one gloo rank in this process, and its (1, 1) plan on the
    CPU: every axis has its process group, so the collectives are real calls
    over groups of one."""
    from ganmf_tpu_torch.parallel import comm, make_mesh

    comm.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        yield make_mesh(device="cpu")
    finally:
        comm.shutdown()


def spawn(case: str, inputs: dict, workdir: Path, script: Path = Path(__file__), world: int = WORLD):
    """Run ``case`` of ``script``'s worker in ``world`` gloo processes on the
    CPU with ``inputs`` (arrays, written to workdir/in.npz); returns each
    rank's result dict. Fails if any rank fails or the spawn outlasts
    SPAWN_TIMEOUT."""
    import pytest

    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "in.npz", **inputs)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **{RANK_ENV: "1"})
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(script), case, str(r), str(world), str(port), str(workdir)],
                              cwd=str(workdir), env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            pytest.fail(f"rank {r} of {case} exited {p.returncode}:\n{text[-4000:]}")
        with np.load(workdir / f"out{r}.npz", allow_pickle=False) as f:
            out.append({k: f[k] for k in f.files})
    return out


def worker_main(cases: dict) -> None:
    """The rank's side of ``spawn``: join the gloo group, run ``cases[case]``
    (inputs) and write its dict of arrays."""
    case, rank, world, port, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    from ganmf_tpu_torch.parallel import comm

    comm.initialize(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
    with np.load(os.path.join(workdir, "in.npz"), allow_pickle=False) as f:
        inputs = {k: f[k] for k in f.files}
    try:
        result = cases[case](inputs, workdir)
    finally:
        comm.shutdown()
    np.savez(os.path.join(workdir, f"out{rank}.npz"), **{k: np.asarray(v) for k, v in result.items()})


def urm_split(n_users=50, n_items=80, seed=3):
    """tests/conftest.py's urm_pair at any shape: every user warm in train and test."""
    import scipy.sparse as sps

    rng = np.random.RandomState(seed)
    full = (rng.rand(n_users, n_items) < 0.25).astype(np.float32)
    for u in range(n_users):
        while full[u].sum() < 4:
            full[u, rng.randint(n_items)] = 1.0
    test_mask = np.zeros_like(full)
    for u in range(n_users):
        items = np.where(full[u] > 0)[0]
        picked = rng.choice(items, size=max(1, len(items) // 5), replace=False)
        test_mask[u, picked] = 1.0
    return sps.csr_matrix(full * (1 - test_mask)), sps.csr_matrix(full * test_mask)


def csr_arrays(prefix, m):
    return {f"{prefix}_data": m.data, f"{prefix}_indices": m.indices, f"{prefix}_indptr": m.indptr,
            f"{prefix}_shape": np.asarray(m.shape)}


def csr_from(inputs, prefix):
    import scipy.sparse as sps

    return sps.csr_matrix((inputs[f"{prefix}_data"], inputs[f"{prefix}_indices"], inputs[f"{prefix}_indptr"]),
                          shape=tuple(inputs[f"{prefix}_shape"]))


# -- the rank's side ---------------------------------------------------------------

AXIS_SETS = {"2x2": ["data", "model", ("data", "model")], "1x4": ["model"],
             "s2x1x2": ["slice", "model", ("slice", "data"), ("slice", "data", "model")]}
TOPK_SHAPES = (6, 64, 5)  # rows, items, k


def _case_basics(inputs, workdir):
    from ganmf_tpu_torch.ops.topk import sharded_topk
    from ganmf_tpu_torch.parallel import comm, make_mesh
    from ganmf_tpu_torch.parallel.mesh import _names

    out = {}
    for name, kw in MESHES.items():
        plan = make_mesh(**kw, device="cpu")
        out[f"{name}/sizes"] = [plan.n_slices, plan.n_data, plan.n_model, plan.n_user_shards]
        out[f"{name}/coords"] = [plan.coords.get(a, 0) for a in ("slice", "data", "model")]
        for shape in ((50, 8), (3706, 8), (50, 3706)):
            for spec in ("urm", "user_rows", "item_rows", "item_cols"):
                eff = plan.effective_spec(shape, getattr(plan, spec))
                out[f"{name}/put/{shape}/{spec}"] = np.asarray(
                    [len(a) for a in eff] + [0] * (len(shape) - len(eff)) + [hi - lo for lo, hi in plan.bounds(shape, getattr(plan, spec))])
        x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 100.0 * plan.rank
        for axes in AXIS_SETS[name]:
            key = f"{name}/{'+'.join(_names(axes))}"
            out[f"{key}/psum"] = comm.psum(x, plan, axes)
            out[f"{key}/pmean"] = comm.pmean(x, plan, axes)
            out[f"{key}/pmax"] = comm.pmax(-x, plan, axes)
            out[f"{key}/all_gather"] = comm.all_gather(x, plan, axes, tiled_axis=1)
            out[f"{key}/reduce_scatter"] = comm.reduce_scatter(x, plan, axes)
            out[f"{key}/ppermute"] = comm.ppermute_shift(x, plan, axes, shift=1)

        # Megatron's pair on a column- then row-parallel product
        rng = np.random.RandomState(0)
        X, W1, W2 = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((5, 6), (6, 8), (8, 3)))
        n, m = plan.n_model, plan.coords["model"]
        X = X.clone().requires_grad_(True)
        W1l = W1[:, m * 8 // n : (m + 1) * 8 // n].clone().requires_grad_(True)
        W2l = W2[m * 8 // n : (m + 1) * 8 // n].clone().requires_grad_(True)
        Y = comm.reduce_from(torch.tanh(comm.copy_to(X, plan, "model") @ W1l) @ W2l, plan, "model")
        gX, gW1, gW2 = torch.autograd.grad((Y**2).sum(), [X, W1l, W2l])
        out[f"{name}/grad/Y"], out[f"{name}/grad/X"] = Y.detach(), gX
        out[f"{name}/grad/W1"] = comm.all_gather(gW1, plan, "model", tiled_axis=1)
        out[f"{name}/grad/W2"] = comm.all_gather(gW2, plan, "model", tiled_axis=0)

        # sharded_topk: this rank's rows (over the user axes) and items (model)
        scores = torch.from_numpy(inputs["topk_scores"])
        B, I, k = TOPK_SHAPES
        (r0, r1), (i0, i1) = plan.bounds((B, I), plan.urm)
        vals, ids = sharded_topk(scores[r0:r1, i0:i1], k, plan, batch_axes=plan.user_axes)
        out[f"{name}/topk/vals"] = comm.all_gather(vals, plan, plan.user_axes)
        out[f"{name}/topk/ids"] = comm.all_gather(ids, plan, plan.user_axes)
    return out


def _case_step(inputs, workdir):
    import scipy.sparse as sps

    from ganmf_tpu_torch.models.ganmf import params_from_jax
    from ganmf_tpu_torch.parallel import make_distributed_ganmf_step, make_mesh, shard_ganmf_params
    from ganmf_tpu_torch.parallel.distributed import gather_module
    from ganmf_tpu_torch.models.gan_base import ADAM_BETAS, ADAM_EPS

    from ganmf_tpu_torch.data.device import padded_csr_from_sparse
    from ganmf_tpu_torch.parallel import shard_padded_csr

    out = {}
    urm = torch.from_numpy(inputs["urm"])
    cpu = torch.device("cpu")
    for name, storage in (("2x2", "dense"), ("s2x1x2", "dense"), ("2x2", "csr")):
        plan = make_mesh(**MESHES[name], device="cpu")
        params = shard_ganmf_params(params_from_jax([inputs[f"p{i}"] for i in range(6)], cpu), plan)
        d_opt = torch.optim.Adam(params.d_params(), lr=1.0, betas=ADAM_BETAS, eps=ADAM_EPS)
        g_opt = torch.optim.Adam(params.g_params(), lr=1.0, betas=ADAM_BETAS, eps=ADAM_EPS)
        step = make_distributed_ganmf_step(plan, 1.0, 0.2, 1e-4, 1e-4)
        if storage == "csr":  # the padded planes' rows over the user axes, every column kept
            local = shard_padded_csr(padded_csr_from_sparse(sps.csr_matrix(inputs["urm"]), cpu), plan)
            out["csr/rows"] = local.idx.shape[0]
            name = "2x2_csr"
        else:
            local = plan.put(urm, plan.urm)
        params, _, _, dloss, gloss = step(params, d_opt, g_opt, local, torch.from_numpy(inputs["uids"]),
                                          torch.from_numpy(inputs["w"]), 1e-3, 1e-3)
        full = gather_module(params, plan)
        out[f"{name}/losses"] = torch.stack([dloss, gloss])
        for i, t in enumerate(full.parameters()):
            out[f"{name}/p{i}"] = t.detach()
    return out


CASES = {"basics": _case_basics, "step": _case_step}

if __name__ == "__main__":
    worker_main(CASES)
elif not os.environ.get(RANK_ENV):
    # -- the pytest side ---------------------------------------------------------
    import jax
    import jax.numpy as jnp
    import pytest

    from ganmf_tpu.ops.topk import sharded_topk as jax_sharded_topk
    from ganmf_tpu.parallel import init_distributed, make_distributed_ganmf_step
    from ganmf_tpu.parallel import make_mesh as jax_make_mesh

    def _topk_scores():
        """Scores with exact ties inside and across shards, signed zeros and
        a row that is -inf throughout."""
        rng = np.random.RandomState(0)
        B, I, _ = TOPK_SHAPES
        s = rng.randn(B, I).astype(np.float32)
        s[1] = np.round(s[1])  # a few distinct values, tied across every shard
        s[2, ::2], s[2, 1::2] = 0.0, -0.0  # signed zeros only: +0.0 ranks above -0.0
        s[3] = -np.inf
        s[4, [3, 19, 35, 51]] = 7.0  # one tie per shard of 16 at the top
        s[5, :] = 1.0
        return s

    @pytest.fixture(scope="module")
    def basics(tmp_path_factory):
        return spawn("basics", {"topk_scores": _topk_scores()}, tmp_path_factory.mktemp("basics"))

    def _grid(name):
        kw = MESHES[name]
        sizes = (kw.get("n_slices", 1), kw["n_data"], kw["n_model"])
        names = ("slice", "data", "model")
        return np.arange(WORLD).reshape(sizes), names

    def _members(name, rank, axes):
        """The ranks of ``rank``'s group over ``axes``, in coordinate order."""
        grid, names = _grid(name)
        axes = (axes,) if isinstance(axes, str) else axes
        coord = np.argwhere(grid == rank)[0]
        idx = tuple(slice(None) if names[a] in axes else int(coord[a]) for a in range(3))
        return grid[idx].reshape(-1).tolist()

    @pytest.mark.parametrize("name", list(MESHES))
    def test_make_mesh_sizes_and_coords(basics, name):
        jplan = jax_make_mesh(**MESHES[name])
        want = [jplan.n_slices, jplan.n_data, jplan.n_model, jplan.n_user_shards]
        grid, _ = _grid(name)
        for rank, res in enumerate(basics):
            assert res[f"{name}/sizes"].tolist() == want
            # JAX's device grid: rank r at the position of device r
            assert res[f"{name}/coords"].tolist() == np.argwhere(grid == rank)[0].tolist()

    @pytest.mark.parametrize("name", list(MESHES))
    def test_put_keeps_the_axes_jax_keeps(basics, name):
        jplan = jax_make_mesh(**MESHES[name])
        for shape in ((50, 8), (3706, 8), (50, 3706)):
            for spec in ("urm", "user_rows", "item_rows", "item_cols"):
                arr = jplan.put(jnp.zeros(shape, jnp.float32), getattr(jplan, spec))
                jspec = list(arr.sharding.spec) + [None] * (len(shape) - len(arr.sharding.spec))
                kept = [0 if a is None else len(a) if isinstance(a, tuple) else 1 for a in jspec[: len(shape)]]
                local = list(arr.addressable_shards[0].data.shape)
                for res in basics:
                    assert res[f"{name}/put/{shape}/{spec}"].tolist() == kept + local, (shape, spec)

    @pytest.mark.parametrize("name", list(MESHES))
    def test_collectives_match_numpy(basics, name):
        xs = [np.arange(8, dtype=np.float32).reshape(4, 2) + 100.0 * r for r in range(WORLD)]
        for axes in AXIS_SETS[name]:
            key = f"{name}/{'+'.join((axes,) if isinstance(axes, str) else axes)}"
            for rank, res in enumerate(basics):
                members = _members(name, rank, axes)
                n, i = len(members), members.index(rank)
                total = sum(xs[r] for r in members)
                np.testing.assert_allclose(res[f"{key}/psum"], total, rtol=1e-6)
                np.testing.assert_allclose(res[f"{key}/pmean"], total / n, rtol=1e-6)
                np.testing.assert_array_equal(res[f"{key}/pmax"], np.max([-xs[r] for r in members], axis=0))
                np.testing.assert_array_equal(res[f"{key}/all_gather"], np.concatenate([xs[r] for r in members], 1))
                width = 4 // n
                np.testing.assert_allclose(res[f"{key}/reduce_scatter"], total[i * width : (i + 1) * width], rtol=1e-6)
                np.testing.assert_array_equal(res[f"{key}/ppermute"], xs[members[(i - 1) % n]])

    @pytest.mark.parametrize("name", list(MESHES))
    def test_autograd_operators_match_unsharded_gradients(basics, name):
        rng = np.random.RandomState(0)
        X, W1, W2 = (torch.from_numpy(rng.randn(*s).astype(np.float32)).requires_grad_(True)
                     for s in ((5, 6), (6, 8), (8, 3)))
        Y = torch.tanh(X @ W1) @ W2
        want = torch.autograd.grad((Y**2).sum(), [X, W1, W2])
        for res in basics:
            np.testing.assert_allclose(res[f"{name}/grad/Y"], Y.detach().numpy(), rtol=1e-6, atol=1e-6)
            for key, w in zip(("X", "W1", "W2"), want):
                # float32 partial sums added in another order: within 1e-6 of the largest
                np.testing.assert_allclose(res[f"{name}/grad/{key}"], w.numpy(), rtol=0,
                                           atol=1e-6 * float(w.abs().max()))

    @pytest.mark.parametrize("name", list(MESHES))
    def test_sharded_topk_ids_bitwise_jax(basics, name):
        """Against JAX's sharded_topk on its (1, 4) mesh (the rows whole, the
        items over 4) and on this mesh's layout: the ids bitwise, with ties to
        the lowest global id and +0.0 above -0.0."""
        scores = _topk_scores()
        k = TOPK_SHAPES[2]
        jplan = jax_make_mesh(**MESHES[name])
        jv, ji = jax_sharded_topk(jax.device_put(jnp.asarray(scores), jplan.urm), k, jplan,
                                  batch_axes=jplan.user_axes)
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(np.asarray(ji), np.asarray(ref_i))
        for res in basics:
            np.testing.assert_array_equal(res[f"{name}/topk/ids"], np.asarray(ji))
            np.testing.assert_array_equal(res[f"{name}/topk/vals"], np.asarray(jv))
            np.testing.assert_array_equal(np.signbit(res[f"{name}/topk/vals"]), np.signbit(np.asarray(jv)))
        assert res[f"{name}/topk/ids"][2].tolist() == [0, 2, 4, 6, 8]  # the +0.0 entries
        assert res[f"{name}/topk/ids"][5].tolist() == [0, 1, 2, 3, 4]

    @pytest.fixture(scope="module")
    def step_runs(tmp_path_factory):
        n_users, n_items, K, E, B = 16, 12, 3, 6, 4
        rng = np.random.RandomState(1)
        urm = (rng.rand(n_users, n_items) < 0.4).astype(np.float32)
        uids, w = np.arange(B, dtype=np.int32), np.ones((B,), np.float32)
        inputs = dict(urm=urm, uids=uids.astype(np.int64), w=w)
        want = {}
        for name in ("2x2", "s2x1x2"):
            plan = jax_make_mesh(**MESHES[name])
            params, d_state, g_state = init_distributed(7, n_users, n_items, K, E, plan)
            if name == "2x2":
                inputs.update({f"p{i}": np.asarray(t) for i, t in enumerate(params)})
            step = make_distributed_ganmf_step(plan, 1.0, 0.2, 1e-4, 1e-4)
            params, _, _, dloss, gloss = step(
                params, d_state, g_state, jax.device_put(jnp.asarray(urm), plan.urm),
                jax.device_put(jnp.asarray(uids), plan.batch), jax.device_put(jnp.asarray(w), plan.batch),
                jnp.float32(1e-3), jnp.float32(1e-3))
            want[name] = (float(dloss), float(gloss), [np.asarray(t) for t in params])
        return spawn("step", inputs, tmp_path_factory.mktemp("step")), want

    @pytest.mark.parametrize("name", ["2x2", "s2x1x2", "2x2_csr"])
    def test_distributed_step_matches_jax(step_runs, name):
        """The step on each mesh, and on the 2 x 2 mesh from
        ``shard_padded_csr``'s planes (8 of the 16 rows a rank), against
        JAX's step on its dense URM."""
        got, want = step_runs
        dloss, gloss, params = want[name.replace("_csr", "")]
        if name.endswith("csr"):
            assert all(int(res["csr/rows"]) == 8 for res in got)
        for res in got:  # every rank reports the same global losses
            assert res[f"{name}/losses"][0] == pytest.approx(dloss, rel=1e-5)
            assert res[f"{name}/losses"][1] == pytest.approx(gloss, rel=1e-5)
        np.testing.assert_allclose(got[0][f"{name}/p0"], params[0], rtol=1e-4, atol=1e-6)
        for i in range(1, 6):
            np.testing.assert_allclose(got[0][f"{name}/p{i}"], params[i], rtol=1e-4, atol=1e-6)

    def test_plans_default_to_the_card_and_raise_without_one(monkeypatch):
        """A plan's device is the card unless the caller asks for another;
        without a card the default raises, before any work."""
        from ganmf_tpu_torch.parallel import comm, make_mesh

        comm.initialize()  # no launcher environment: a no-op
        assert not comm.is_initialized() and comm.process_count() == 1 and comm.process_index() == 0
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_mesh(n_data=2, n_model=2, device="cpu")  # one process is a world of one
        assert make_mesh(device="cpu").device == torch.device("cpu")
