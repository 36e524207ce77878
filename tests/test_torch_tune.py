"""The port's tuner (ganmf_tpu_torch/tune, cli/spaces.py) against the JAX
package's, on the CPU.

- The spaces: every space of ``DICT_DIMENSIONS`` (and the similarity extras)
  encodes and decodes random points as the JAX copy does, exactly.
- The GP: the port's numpy/scipy fit against scikit-learn's
  GaussianProcessRegressor as the JAX package configures it, at fixed data:
  the log marginal likelihood, the predictive mean and std within 1e-6
  relative (both follow the same float64 steps, so they agree far closer).
- The proposals: ``gp_minimize`` (15 calls, 5 random starts) and
  ``dummy_minimize`` on tests/test_tune.py's objective propose JAX's points
  for seeds 0-2, within 1e-6 in the unit cube. Were an expected-improvement
  near-tie to flip a proposal, the test would say so and hold the EI at both
  points to 1e-9 relative instead.
- The checkpoints: resume works; the port pickles its own class; in a
  process that refuses jax, ganmf_tpu and sklearn, the port's ``load`` reads
  every committed experiments/*/checkpoint.pkl and gives the x_iters,
  func_vals, x and fun of JAX's ``load``.
"""

import glob
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ganmf_tpu.cli import spaces as jax_spaces
from ganmf_tpu.tune import gp as jgp
from ganmf_tpu.tune import space as jspace
from ganmf_tpu_torch.cli import spaces
from ganmf_tpu_torch.tune import Categorical, Integer, Real, dummy_minimize, gp_minimize
from ganmf_tpu_torch.tune import gp
from ganmf_tpu_torch.tune.space import decode_point, encode_point
from test_tune import DIMS as JAX_DIMS
from test_tune import objective

REPO = Path(__file__).resolve().parents[1]
CHECKPOINTS = sorted(glob.glob(str(REPO / "experiments" / "*" / "checkpoint.pkl")))

# tests/test_tune.py's dimensions, built from the port's classes
DIMS = [
    Real(-2, 2, name="x"),
    Real(1e-3, 10, prior="log-uniform", name="y"),
    Integer(0, 10, name="k"),
    Categorical(["a", "b"], name="c"),
]


def _all_spaces(module):
    out = dict(module.DICT_DIMENSIONS)
    for sim in ("asymmetric", "tversky", "euclidean", "cosine"):
        out["sim_" + sim] = module.similarity_extra_dimensions(sim)
    return out


@pytest.mark.parametrize("name", sorted(_all_spaces(spaces)))
def test_space_encodes_and_decodes_as_jax(name):
    mine, theirs = _all_spaces(spaces)[name], _all_spaces(jax_spaces)[name]
    assert [d.name for d in mine] == [d.name for d in theirs]
    assert [type(d).__name__ for d in mine] == [type(d).__name__ for d in theirs]
    rng = np.random.RandomState(len(name))
    for u in list(rng.rand(64, len(mine))) + [np.zeros(len(mine)), np.ones(len(mine))]:
        x = decode_point(mine, u)
        assert x == jspace.decode_point(theirs, u)
        np.testing.assert_array_equal(encode_point(mine, x), jspace.encode_point(theirs, x))


@pytest.mark.parametrize("d,n,flat_y", [(1, 5, False), (4, 12, False), (15, 10, False), (3, 6, True)])
def test_gp_matches_sklearn(d, n, flat_y):
    rng = np.random.RandomState(d * 100 + n)
    X = rng.rand(n, d)
    y = np.full(n, -0.25) if flat_y else rng.randn(n)  # a flat y has std 0: scaled by 1
    mine = gp._fit_gp(X, y, np.random.RandomState(11))
    theirs = jgp._fit_gp(X, y, np.random.RandomState(11))
    assert mine.log_marginal_likelihood_value_ == pytest.approx(theirs.log_marginal_likelihood_value_, rel=1e-6)
    np.testing.assert_allclose(mine.theta, theirs.kernel_.theta, rtol=1e-6)
    Q = np.vstack([rng.rand(300, d), X])  # the training points too, where the std nears 0
    mu, sigma = mine.predict(Q, return_std=True)
    jmu, jsigma = theirs.predict(Q, return_std=True)
    np.testing.assert_allclose(mu, jmu, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(sigma, jsigma, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(mine.predict(Q), jmu, rtol=1e-6, atol=1e-12)
    lml, grad = mine.log_marginal_likelihood(mine.theta)
    jlml, jgrad = theirs.log_marginal_likelihood(theirs.kernel_.theta, eval_gradient=True)
    assert lml == pytest.approx(jlml, rel=1e-6)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-6, atol=1e-9)


def _ei_at(result, upto, dims, points):
    """The expected improvement at ``points`` (unit cube) of the port's GP fit
    to the first ``upto`` trials of ``result``, as the proposal saw it."""
    X = np.asarray([encode_point(dims, x) for x in result.x_iters[:upto]])
    y = np.asarray(result.func_vals[:upto])
    model = gp.GaussianProcess(X, y, random_state=0)
    mu, sigma = model.predict(np.asarray(points), return_std=True)
    return gp._expected_improvement(mu, sigma, np.min(y))


def _assert_same_proposals(mine, theirs, dims, jdims, n_random):
    for i, (a, b) in enumerate(zip(mine.x_iters, theirs.x_iters)):
        ua, ub = encode_point(dims, a), jspace.encode_point(jdims, b)
        if np.abs(ua - ub).max() <= 1e-6:
            assert mine.func_vals[i] == pytest.approx(theirs.func_vals[i], rel=1e-12)
            continue
        # a flip: only a GP proposal may differ, and only at an EI near-tie
        assert i >= n_random, f"random start {i} differs: {a} vs {b}"
        ei = _ei_at(mine, i, dims, [ua, ub])
        print(f"proposal {i} flipped at an EI near-tie: {a} vs {b}, EI {ei}")
        assert ei[0] == pytest.approx(ei[1], rel=1e-9)
        return  # the histories part here
    assert len(mine.x_iters) == len(theirs.x_iters)
    assert mine.fun == pytest.approx(theirs.fun, rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp_minimize_proposes_jax_points(seed):
    mine = gp_minimize(objective, DIMS, n_calls=15, n_random_starts=5, random_state=seed)
    theirs = jgp.gp_minimize(objective, JAX_DIMS, n_calls=15, n_random_starts=5, random_state=seed)
    assert len(mine.func_vals) == 15
    _assert_same_proposals(mine, theirs, DIMS, JAX_DIMS, n_random=5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dummy_minimize_proposes_jax_points(seed):
    mine = dummy_minimize(objective, DIMS, n_calls=10, random_state=seed)
    theirs = jgp.dummy_minimize(objective, JAX_DIMS, n_calls=10, random_state=seed)
    _assert_same_proposals(mine, theirs, DIMS, JAX_DIMS, n_random=10)


def test_checkpoint_resume(tmp_path):
    path = str(tmp_path / "checkpoint.pkl")
    saver = gp.CheckpointSaver(path)
    first = gp_minimize(objective, DIMS, n_calls=5, random_state=0, callback=[saver])
    prev = gp.load(path)
    assert type(prev) is gp.OptimizeResult and len(prev.func_vals) == 5
    with open(path, "rb") as fh:  # the port pickles its own class
        assert b"ganmf_tpu_torch.tune.gp" in fh.read()

    gp_minimize(objective, DIMS, n_calls=5, x0=prev.x_iters, y0=prev.func_vals,
                n_random_starts=0, random_state=0, callback=[saver])
    final = gp.load(path)
    assert len(final.func_vals) == 10 and final.x_iters[:5] == prev.x_iters
    assert final.fun <= first.fun

    # resumed on JAX's side from the same history, the GP proposes the same points
    theirs = jgp.gp_minimize(objective, JAX_DIMS, n_calls=5, x0=prev.x_iters, y0=prev.func_vals,
                             n_random_starts=0, random_state=0)
    _assert_same_proposals(final, theirs, DIMS, JAX_DIMS, n_random=5)


def test_load_reads_a_jax_checkpoint_and_refuses_other_classes(tmp_path):
    path = str(tmp_path / "checkpoint.pkl")
    jgp.dummy_minimize(objective, JAX_DIMS, n_calls=3, random_state=4, callback=[jgp.CheckpointSaver(path)])
    want = jgp.load(path)
    got = gp.load(path)
    assert type(got) is gp.OptimizeResult
    assert (got.x_iters, got.func_vals, got.x, got.fun) == (want.x_iters, want.func_vals, want.x, want.fun)

    # the classes of the JAX package's space module map onto the port's
    bad = tmp_path / "other.pkl"
    with open(bad, "wb") as fh:
        pickle.dump(jax_spaces.DICT_DIMENSIONS, fh)
    assert type(gp.load(str(bad))["ALS"][0]) is Integer
    # any other class of the JAX package is refused, not imported
    from ganmf_tpu.models.toppop import TopPop

    with open(bad, "wb") as fh:
        pickle.dump(TopPop, fh)
    with pytest.raises(pickle.UnpicklingError, match="ganmf_tpu.models.toppop.TopPop"):
        gp.load(str(bad))


_LOAD_WITHOUT_JAX = r"""
import json, sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ganmf_tpu", "sklearn"):
            raise ImportError(f"refused {name}")
        return None

for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ganmf_tpu", "sklearn")]:
    del sys.modules[name]
sys.meta_path.insert(0, _Refuse())

from ganmf_tpu_torch.tune.gp import OptimizeResult, load
out = {}
for path in sys.argv[1:]:
    r = load(path)
    assert type(r) is OptimizeResult
    out[path] = [r.x_iters, r.func_vals, r.x, r.fun]
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ganmf_tpu", "sklearn"))
assert not leaked, leaked
print("LOADED", json.dumps(out))
"""


def test_committed_checkpoints_load_without_jax():
    assert len(CHECKPOINTS) == 6, CHECKPOINTS
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _LOAD_WITHOUT_JAX, *CHECKPOINTS], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.split("LOADED", 1)[1])
    for path in CHECKPOINTS:
        want = jgp.load(path)
        assert len(want.func_vals) > 0
        # JSON keeps floats exact (repr round-trips) and turns tuples into lists
        assert got[path] == json.loads(json.dumps([want.x_iters, want.func_vals, want.x, want.fun])), path
