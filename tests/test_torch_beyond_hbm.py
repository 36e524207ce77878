"""Training past the card's memory (ganmf_tpu_torch/cli/beyond_hbm.py, the
counterpart of scripts/beyond_hbm_demo.py) against the JAX package, on the
CPU, at a small shape: 2,048 x 1,536 with 8 uniform draws a user.

- ``synthetic_urm``: bitwise the JAX script's matrix at three sizes and seeds;
- the settings: the JAX script's fit arguments, epochs, seed and mode, read
  from its calls, are the module's;
- each of the five csr fits through the module's stage, at the script's
  settings with narrowed widths, from JAX's initial weights or draws through
  the seams the csr tests use, against JAX's csr fit: GANMF and DisGANMF
  within 1e-4 (tests/test_torch_ganmf_train.py's csr fit against JAX's),
  CFGAN from JAX's fold_in rows within 1e-5 (tests/test_torch_cfgan_csr.py's
  masked epoch), MF-BPR from JAX's key chain within rtol 1e-4 / atol 1e-5
  (tests/test_torch_mf_sgd.py's fits), IALS from the same numpy factors with
  every row within 1e-4 of its norm (tests/test_torch_ials.py's csr fit
  against JAX's: the port's chunks are cut to 256 rows, so its CG exits are
  other than JAX's one chunk) and each orientation's storage JAX's, at the
  default plane limit and at one that sends the items to flat CSR;
- under a ``TorchDispatchMode`` that records every op's output size, no op of
  any of those fits (the port's own draws and weights) outputs U x I / 4
  elements or more;
- the script's JSON lines: the JAX script's shape line, and a line a model
  with the JAX script's keys and bench names plus ``peak_gib``, ``card`` and
  ``storage``, for its default model list and for all five.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax

from ganmf_tpu import models as jmodels
from ganmf_tpu.models import cfgan as jcf
from ganmf_tpu.models import disganmf as jdg
from ganmf_tpu.models import ganmf as jgm
from ganmf_tpu.models import ials as jials
from ganmf_tpu_torch.cli import beyond_hbm
from ganmf_tpu_torch.data.synthetic import synthetic_urm
from ganmf_tpu_torch.models import cfgan as pcf
from ganmf_tpu_torch.models import disganmf as pdg
from ganmf_tpu_torch.models import ganmf as pgm
from ganmf_tpu_torch.models import ials as pials
from test_torch_mf_sgd import _jax_draws

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import beyond_hbm_demo  # noqa: E402  (the JAX script; imports JAX only inside main)

torch.set_num_threads(1)
CPU = torch.device("cpu")
SHAPE = (2048, 1536, 8)
CHUNK = 256  # the port's IALS chunks here: one chunk would hold every row
ROW_GAP = 1e-4
# the script's settings with narrowed widths
NARROW = {
    "GANMF_PARAMS": dict(beyond_hbm.GANMF_PARAMS, num_factors=8, emb_dim=16),
    "DISGANMF_PARAMS": dict(beyond_hbm.DISGANMF_PARAMS, num_factors=8, d_nodes=16),
    "CFGAN_PARAMS": dict(beyond_hbm.CFGAN_PARAMS, d_nodes=8, g_nodes=16),
    "MFBPR_PARAMS": dict(beyond_hbm.MFBPR_PARAMS, num_factors=8),
    "IALS_PARAMS": dict(beyond_hbm.IALS_PARAMS, num_factors=8),
}
PARAMS = {"ganmf": "GANMF_PARAMS", "disganmf": "DISGANMF_PARAMS", "cfgan": "CFGAN_PARAMS", "mfbpr": "MFBPR_PARAMS",
          "ials": "IALS_PARAMS"}
ALL = tuple(beyond_hbm.STAGES)


@pytest.fixture(scope="module")
def train():
    return synthetic_urm(*SHAPE)


@pytest.fixture
def narrow(monkeypatch):
    for name, params in NARROW.items():
        monkeypatch.setattr(beyond_hbm, name, params)
    monkeypatch.setattr(pials, "chunk_rows", lambda num_factors, n_cols: CHUNK)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# -- the matrix and the settings -------------------------------------------------

@pytest.mark.parametrize("u,i,per_user,seed", [(300, 200, 5, 0), (1000, 4096, 17, 3), (64, 7, 9, 11)])
def test_synthetic_urm_is_the_scripts(u, i, per_user, seed):
    got, want = synthetic_urm(u, i, per_user, seed), beyond_hbm_demo.synthetic_urm(u, i, per_user, seed)
    assert got.shape == want.shape == (u, i) and got.dtype == want.dtype == np.float32
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.nnz <= u * per_user and np.all(got.data == 1.0)


def _load_demo(monkeypatch, env):
    """The JAX script as a fresh module, its shape read from ``env``."""
    for name in ("DEMO_USERS", "DEMO_ITEMS", "DEMO_NNZ_PER_USER"):
        if name in env:
            monkeypatch.setenv(name, str(env[name]))
        else:
            monkeypatch.delenv(name, raising=False)
    spec = importlib.util.spec_from_file_location("beyond_hbm_demo_fresh", REPO / "scripts" / "beyond_hbm_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


def _run_demo(monkeypatch, demo, models, calls):
    """Run the JAX script's main with its timings and fits recorded into
    ``calls`` (name -> (fit arguments, epochs, model)), not run."""
    import _timing

    def epoch_time(make_model, fit_kwargs, n_epochs):
        m = make_model()
        calls[type(m).__name__] = (fit_kwargs, n_epochs, m)
        return 1.0

    def recording_fit(self, **kwargs):
        calls[type(self).__name__] = (kwargs, None, self)

    monkeypatch.setattr(demo, "epoch_time", epoch_time)
    monkeypatch.setattr(_timing, "timeit", lambda fn, n=3, warmup=1: 1.0)
    for cls in ("MatrixFactorization_BPR", "IALSRecommender"):
        monkeypatch.setattr(getattr(jmodels, cls), "fit", recording_fit)
    monkeypatch.setattr(sys, "argv", ["beyond_hbm_demo.py", *models])
    demo.main()


def test_settings_are_the_jax_scripts(monkeypatch, capsys):
    demo = _load_demo(monkeypatch, {})
    assert (demo.U, demo.I, demo.NNZ_PER_USER) == beyond_hbm.demo_shape() == (
        beyond_hbm.DEFAULT_USERS, beyond_hbm.DEFAULT_ITEMS, beyond_hbm.DEFAULT_NNZ_PER_USER)
    demo = _load_demo(monkeypatch, dict(DEMO_USERS=96, DEMO_ITEMS=64, DEMO_NNZ_PER_USER=3))
    assert beyond_hbm.demo_shape() == (96, 64, 3)
    calls = {}
    _run_demo(monkeypatch, demo, ALL, calls)
    for cls, name in (("GANMF", "GANMF_PARAMS"), ("DisGANMF", "DISGANMF_PARAMS"), ("CFGAN", "CFGAN_PARAMS")):
        kwargs, n_epochs, m = calls[cls]
        assert kwargs == getattr(beyond_hbm, name) and n_epochs == beyond_hbm.GAN_EPOCHS
        assert (m.seed, m.mode, m.is_experiment) == (beyond_hbm.SEED, "user", True)
    assert calls["MatrixFactorization_BPR"][0] == beyond_hbm.MFBPR_PARAMS
    assert calls["IALSRecommender"][0] == beyond_hbm.IALS_PARAMS
    capsys.readouterr()


# -- the five csr fits against JAX's ----------------------------------------------

def _inject_jax_init(monkeypatch, name, mat, params):
    """The port's GAN fits start from JAX's initial weights; CFGAN's csr masks
    come from JAX's fold_in rows (tests/test_torch_cfgan_csr.py's seam).
    Returns the initial leaves."""
    key, seed = jax.random.PRNGKey(beyond_hbm.SEED), beyond_hbm.SEED
    if name == "ganmf":
        init = _leaves(jgm._init_params(key, *mat.shape, params["num_factors"], params["emb_dim"]))
        monkeypatch.setattr(pgm, "init_params", lambda *a: pgm.params_from_jax(init, CPU))
        return init
    if name == "disganmf":
        init = _leaves(jdg._init_params(key, *mat.shape, params["num_factors"], 1, params["d_nodes"]))
        monkeypatch.setattr(pdg, "init_params", lambda *a: pdg.params_from_jax(init, CPU))
        return init
    n_cols = mat.shape[1]
    k_g, k_d, ek = jax.random.split(jax.random.PRNGKey(seed), 3)
    init = _leaves(jcf.CFGANParams(G=jcf._init_mlp(k_g, [n_cols, params["g_nodes"], n_cols]),
                                   D=jcf._init_mlp(k_d, [2 * n_cols, params["d_nodes"], 1])))
    monkeypatch.setattr(pcf, "init_params", lambda *a: pcf.params_from_jax(init, 1, CPU))
    subs = {}

    def jax_rows(seed_, epoch, stream, rows, n_cols_):
        nonlocal ek
        while len(subs) < epoch:
            ek, sub = jax.random.split(ek)
            subs[len(subs) + 1] = jax.random.split(sub)
        base = subs[epoch][stream]
        r = jax.numpy.asarray(rows.numpy(), dtype=jax.numpy.int32)
        return torch.from_numpy(np.array(jax.vmap(lambda u: jax.random.uniform(jax.random.fold_in(base, u),
                                                                               (n_cols_,)))(r)))

    monkeypatch.setattr(pcf, "keyed_uniforms", jax_rows)
    return init


def _row_gap(got, want):
    return float((np.linalg.norm(got - want, axis=1) / np.maximum(np.linalg.norm(want, axis=1), 1e-30)).max())


@pytest.mark.parametrize("name", ["ganmf", "disganmf", "cfgan"])
def test_gan_csr_fit_matches_jax(name, train, narrow, monkeypatch):
    params = getattr(beyond_hbm, PARAMS[name])
    jm = getattr(jmodels, {"ganmf": "GANMF", "disganmf": "DisGANMF", "cfgan": "CFGAN"}[name])(
        train, mode="user", seed=beyond_hbm.SEED, is_experiment=True)
    jm.fit(epochs=1, **params)
    init = _inject_jax_init(monkeypatch, name, train, params)
    row, detail, m = beyond_hbm.STAGES[name](train, CPU, "cpu", epochs=1)
    assert m._urm_streams() and row["storage"] == "csr (padded rows)" and len(detail["epoch_walls"]) == 1
    atol = 1e-5 if name == "cfgan" else 1e-4
    got = [t.detach().numpy() for t in m.params.parameters()]
    assert len(got) == len(init)
    for g, w, i in zip(got, _leaves(jm.params), init):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    assert any(np.abs(g - i).max() > 10 * atol for g, i in zip(got, init))  # the epoch moved the weights


def test_mfbpr_csr_fit_matches_jax(train, narrow, monkeypatch):
    params = beyond_hbm.MFBPR_PARAMS
    jm = jmodels.MatrixFactorization_BPR(train)
    jm.fit(**params)
    _jax_draws(monkeypatch, 1234, n_chunks=0, presample=True)  # the fits' default random_seed
    row, detail, m = beyond_hbm.mfbpr(train, CPU, "cpu", timed_epochs=0)
    assert m._tables.urm is None and row["storage"] == "csr (padded rows)"
    np.testing.assert_allclose(np.asarray(m.USER_factors), jm.USER_factors, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(m.ITEM_factors), jm.ITEM_factors, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("limit", [None, 150_000], ids=["default_limit", "items_flat"])
def test_ials_csr_fit_matches_jax(limit, train, narrow, monkeypatch):
    if limit is not None:  # users: 8 bytes x 2048 rows x <= 8 slots; items: past it
        monkeypatch.setattr(jials, "_PAD_PLANE_BYTE_LIMIT", limit)
        monkeypatch.setattr(pials, "_PAD_PLANE_BYTE_LIMIT", limit)
    jm = jmodels.IALSRecommender(train)
    jm.fit(**beyond_hbm.IALS_PARAMS)
    row, detail, m = beyond_hbm.ials(train, CPU, "cpu", timed_epochs=0)
    kinds = (m._store_users[0], m._store_items[0])
    assert kinds == (jm._store_users[0], jm._store_items[0])
    assert kinds == (("padded", "padded") if limit is None else ("padded", "flat"))
    assert row["storage"] == f"csr: users {kinds[0]}, items {kinds[1]}"
    assert detail["chunks"] == [CHUNK, CHUNK]
    for got, want in ((m._U_dev, jm._U_dev), (m._V_dev, jm._V_dev)):
        assert _row_gap(got.numpy(), np.asarray(want)) <= ROW_GAP


# -- no dense [U, I] ---------------------------------------------------------------

class LargestOutput(TorchDispatchMode):
    """Records the largest tensor any op outputs, and its op."""

    def __init__(self):
        super().__init__()
        self.largest, self.op = 0, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel() > self.largest:
                self.largest, self.op = t.numel(), str(func)
        return out


@pytest.mark.parametrize("name", ALL)
def test_no_op_outputs_a_quarter_of_the_urm(name, train, narrow):
    """The fit and, for MF-BPR and IALS, the script's timed epochs, from the
    port's own weights and draws: the largest op output stays under U x I / 4
    elements (a minibatch's rows, an IALS chunk's confidence block)."""
    U, I = train.shape
    with LargestOutput() as seen:
        kw = {"timed_epochs": 1} if name in ("mfbpr", "ials") else {"epochs": 2}
        beyond_hbm.STAGES[name](train, CPU, "cpu", **kw)
    assert 0 < seen.largest < U * I // 4, (seen.op, seen.largest)
    if name != "mfbpr":  # the mode saw the densified rows
        assert seen.largest >= 64 * I, (seen.op, seen.largest)


# -- the script's lines ---------------------------------------------------------------

@pytest.mark.parametrize("models", [(), ALL], ids=["default_models", "all_models"])
def test_rows_have_the_jax_scripts_keys_and_values(models, monkeypatch, capsys, tmp_path, narrow):
    demo = _load_demo(monkeypatch, dict(DEMO_USERS=128, DEMO_ITEMS=96, DEMO_NNZ_PER_USER=4))
    _run_demo(monkeypatch, demo, models, {})
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    out = tmp_path / "beyond_hbm.json"
    assert beyond_hbm.main([*models, "--out", str(out)], device="cpu") == 0
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert got[0] == want[0] == beyond_hbm.shape_row(synthetic_urm(128, 96, 4))
    assert len(got) == len(want) == 1 + (len(ALL) if models else len(beyond_hbm.DEFAULT_MODELS))
    for g, w in zip(got[1:], want[1:]):
        assert set(g) == set(w) | {"peak_gib", "card", "storage"}
        assert g["bench"] == w["bench"]
        assert isinstance(g["s_per_epoch"], float) and g["s_per_epoch"] == round(g["s_per_epoch"], 2)
        assert g["peak_gib"] is None and g["card"] == "cpu" and g["storage"].startswith("csr")
    saved = json.loads(out.read_text())
    assert saved["shape"] == got[0] and saved["rows"] == got[1:] and saved["over_bound"] == []


def test_unknown_models_are_refused(tmp_path):
    with pytest.raises(SystemExit):
        beyond_hbm.main(["ganmf", "caae", "--out", str(tmp_path / "x.json")], device="cpu")
