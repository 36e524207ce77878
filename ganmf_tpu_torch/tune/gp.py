"""Bayesian optimization: a Gaussian-process surrogate and expected improvement.

Port of ganmf_tpu/tune/gp.py, the stand-in for the skopt ``gp_minimize`` and
``dummy_minimize`` calls of the reference harness (RecSysExp.py:376-391), with
warm starts (x0/y0), per-trial callbacks and checkpoint pickles.

The JAX package fits its surrogate with scikit-learn's
``GaussianProcessRegressor``; this module computes the same fit with numpy and
scipy alone, so that the tuner runs where scikit-learn is not installed.
``GaussianProcess`` follows sklearn 1.9's ``fit``, ``log_marginal_likelihood``
and ``predict`` step by step for the one configuration the tuner uses:

- the kernel ``ConstantKernel(1.0) * Matern(length_scale=[0.3] * d, nu=2.5) +
  WhiteKernel(1e-6)``, every hyperparameter bounded to [1e-5, 1e5] and
  optimized in log space;
- ``alpha=1e-10`` on the diagonal, ``normalize_y`` (the mean and the
  population std of y; a zero std becomes 1);
- the negative log marginal likelihood and its analytic gradient minimized
  by scipy's L-BFGS-B from the kernel's start, clipped into the bounds as
  scipy's L-BFGS-B clips it (the white noise starts below its bound), then
  from 2 starts drawn uniformly in the log bounds from
  ``RandomState(random_state)``; the lowest wins;
- ``predict(return_std=True)`` clips negative variances to 0.

``_run`` draws from its RandomState in the JAX package's order (``rand(d)``
for a random start; per GP step ``randint(2**31 - 1)`` for the GP, then
``rand(8192, d)`` and three ``randn(256, d)``), so the two packages propose
the same points from one seed.

``load`` reads checkpoints pickled by either package: the JAX package's
``OptimizeResult`` maps onto this module's without importing ``ganmf_tpu``.
"""

from __future__ import annotations

import math
import pickle
from dataclasses import dataclass, field
from typing import Callable, List, Sequence

import numpy as np
import scipy.optimize
from scipy.linalg import cho_solve, cholesky, solve_triangular
from scipy.spatial.distance import cdist, pdist, squareform
from scipy.stats import norm

from ganmf_tpu_torch.tune.space import Dimension, decode_point, encode_point


@dataclass
class OptimizeResult:
    x: list = None
    fun: float = np.inf
    x_iters: List[list] = field(default_factory=list)
    func_vals: List[float] = field(default_factory=list)

    def update(self, x, y):
        self.x_iters.append(list(x))
        self.func_vals.append(float(y))
        if y < self.fun:
            self.fun = float(y)
            self.x = list(x)


class CheckpointSaver:
    """Pickle the running result after every trial
    (skopt.callbacks.CheckpointSaver equivalent, RecSysExp.py:368)."""

    def __init__(self, path: str, **_):
        self.path = path

    def __call__(self, result: OptimizeResult):
        with open(self.path, "wb") as fh:
            pickle.dump(result, fh, pickle.HIGHEST_PROTOCOL)


# the JAX package's modules whose classes a checkpoint may name
_JAX_MODULES = {"ganmf_tpu.tune.gp": __name__, "ganmf_tpu.tune.space": "ganmf_tpu_torch.tune.space"}


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _JAX_MODULES:
            module = _JAX_MODULES[module]
        elif module.split(".")[0] == "ganmf_tpu":
            raise pickle.UnpicklingError(f"{module}.{name} is not a class of the tuner's checkpoints")
        return super().find_class(module, name)


def load(path: str) -> OptimizeResult:
    """The OptimizeResult pickled at ``path`` by either package."""
    with open(path, "rb") as fh:
        return _CheckpointUnpickler(fh).load()


# sklearn's GaussianProcessRegressor defaults and the tuner's kernel
_ALPHA = 1e-10
_BOUNDS = (1e-5, 1e5)
_CONSTANT, _LENGTH_SCALE, _NOISE = 1.0, 0.3, 1e-6
_N_RESTARTS = 2


class GaussianProcess:
    """The GP surrogate fitted to (X [n, d], y [n]) float64, as sklearn's
    ``GaussianProcessRegressor(kernel=ConstantKernel(1.0) * Matern([0.3] * d,
    nu=2.5) + WhiteKernel(1e-6), normalize_y=True, n_restarts_optimizer=2,
    random_state=random_state)`` fits it. ``theta`` holds the log
    hyperparameters (constant, d length scales, noise)."""

    def __init__(self, X, y, random_state):
        self.X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        d = self.X.shape[1]
        self._anisotropic = d > 1  # a single length scale is a scalar in sklearn
        self.y_mean = np.mean(y, axis=0)
        std = np.std(y, axis=0)
        self.y_std = 1.0 if std == 0.0 else std
        self.y = (y - self.y_mean) / self.y_std

        bounds = np.log(np.vstack([_BOUNDS] * (d + 2)))
        theta0 = np.log(np.hstack([_CONSTANT, np.full(d, _LENGTH_SCALE), _NOISE]))
        rng = np.random.RandomState(random_state)
        optima = [self._minimize(theta0, bounds)]
        for _ in range(_N_RESTARTS):
            optima.append(self._minimize(rng.uniform(bounds[:, 0], bounds[:, 1]), bounds))
        values = [f for _, f in optima]
        self.theta = optima[int(np.argmin(values))][0]
        self.log_marginal_likelihood_value_ = -np.min(values)

        K = self._gram(self.theta)
        K[np.diag_indices_from(K)] += _ALPHA
        self.L = cholesky(K, lower=True, check_finite=False)
        self.alpha = cho_solve((self.L, True), self.y, check_finite=False)

    def _minimize(self, theta0, bounds):
        def objective(theta):
            lml, grad = self.log_marginal_likelihood(theta)
            return -lml, -grad

        res = scipy.optimize.minimize(objective, np.clip(theta0, bounds[:, 0], bounds[:, 1]),
                                      method="L-BFGS-B", jac=True, bounds=bounds)
        return res.x, res.fun

    def _params(self, theta):
        """(constant, length scale(s), noise) from log hyperparameters."""
        ls = np.exp(theta[1:-1]) if self._anisotropic else np.asarray(np.exp(theta[1]), dtype=float)
        return np.exp(theta[0]), ls, np.exp(theta[-1])

    def _gram(self, theta, eval_gradient=False):
        """K(X, X) of the whole kernel and, with ``eval_gradient``, its
        gradient [n, n, d + 2] in the log hyperparameters (sklearn's
        Matern, ConstantKernel, WhiteKernel, Product and Sum)."""
        c, ls, noise = self._params(theta)
        X, n = self.X, self.X.shape[0]
        dists = pdist(X / ls, metric="euclidean")
        Km = dists * math.sqrt(5)
        Km = (1.0 + Km + Km**2 / 3.0) * np.exp(-Km)
        Km = squareform(Km)
        np.fill_diagonal(Km, 1)
        K = c * Km + noise * np.eye(n)
        if not eval_gradient:
            return K
        if self._anisotropic:
            D = (X[:, np.newaxis, :] - X[np.newaxis, :, :]) ** 2 / (ls**2)
        else:
            D = squareform(dists**2)[:, :, np.newaxis]
        tmp = np.sqrt(5 * D.sum(-1))[..., np.newaxis]
        Km_grad = 5.0 / 3.0 * D * (tmp + 1) * np.exp(-tmp)
        # d/dlog c, d/dlog length scales, d/dlog noise
        return K, np.dstack((c * Km[:, :, np.newaxis], c * Km_grad, noise * np.eye(n)[:, :, np.newaxis]))

    def log_marginal_likelihood(self, theta):
        """(log marginal likelihood, its gradient) at log hyperparameters
        ``theta``; (-inf, 0) where K is not positive definite."""
        K, K_gradient = self._gram(theta, eval_gradient=True)
        K[np.diag_indices_from(K)] += _ALPHA
        try:
            L = cholesky(K, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return -np.inf, np.zeros_like(theta)
        y = self.y[:, np.newaxis]
        alpha = cho_solve((L, True), y, check_finite=False)
        lml_dims = -0.5 * np.einsum("ik,ik->k", y, alpha)
        lml_dims -= np.log(np.diag(L)).sum()
        lml_dims -= K.shape[0] / 2 * np.log(2 * np.pi)
        inner = np.einsum("ik,jk->ijk", alpha, alpha)
        K_inv = cho_solve((L, True), np.eye(K.shape[0]), check_finite=False)
        inner -= K_inv[..., np.newaxis]
        grad_dims = 0.5 * np.einsum("ijl,jik->kl", inner, K_gradient)
        return lml_dims.sum(axis=-1), grad_dims.sum(axis=-1)

    def predict(self, Xq, return_std=False):
        """The predictive mean at Xq [m, d] (and its std, negative variances
        clipped to 0), in the units of y."""
        c, ls, noise = self._params(self.theta)
        Xq = np.asarray(Xq, dtype=np.float64)
        Km = cdist(Xq / ls, self.X / ls, metric="euclidean") * math.sqrt(5)
        K_trans = c * ((1.0 + Km + Km**2 / 3.0) * np.exp(-Km))
        y_mean = self.y_std * (K_trans @ self.alpha) + self.y_mean
        if not return_std:
            return y_mean
        V = solve_triangular(self.L, K_trans.T, lower=True, check_finite=False)
        y_var = np.full(Xq.shape[0], c + noise)  # the kernel's diagonal
        y_var -= np.einsum("ij,ji->i", V.T, V)
        y_var[y_var < 0] = 0.0
        return y_mean, np.sqrt(y_var * self.y_std**2)


def _expected_improvement(mu, sigma, best):
    sigma = np.maximum(sigma, 1e-12)
    z = (best - mu) / sigma
    return (best - mu) * norm.cdf(z) + sigma * norm.pdf(z)


def _fit_gp(X, y, rng):
    return GaussianProcess(X, y, random_state=rng.randint(2**31 - 1))


def _run(
    func: Callable,
    dimensions: Sequence[Dimension],
    n_calls: int,
    rng: np.random.RandomState,
    callbacks,
    x0,
    y0,
    n_random_starts: int,
    use_gp: bool,
    verbose: bool,
) -> OptimizeResult:
    result = OptimizeResult()
    X_unit: List[np.ndarray] = []
    y_vals: List[float] = []

    # warm-start points without observations are evaluated first (counting
    # toward n_calls), mirroring skopt's gp_minimize semantics
    x0_pending: List = []
    if x0 is not None:
        if y0 is not None:
            for xi, yi in zip(x0, y0):
                result.update(xi, yi)
                X_unit.append(encode_point(list(dimensions), xi))
                y_vals.append(float(yi))
        else:
            x0_pending = list(x0)

    def tell(x):
        y = func(x)
        result.update(x, y)
        X_unit.append(encode_point(list(dimensions), x))
        y_vals.append(float(y))
        for cb in callbacks:
            cb(result)
        if verbose:
            print(f"[tune] trial {len(result.func_vals)}: f={y:.6f} best={result.fun:.6f}")

    d = len(dimensions)
    for it in range(n_calls):
        if x0_pending:
            tell(x0_pending.pop(0))
            continue
        n_seen = len(y_vals)
        if not use_gp or n_seen < max(n_random_starts, 2):
            u = rng.rand(d)
        else:
            gp = _fit_gp(np.asarray(X_unit), np.asarray(y_vals), rng)
            best_y = np.min(y_vals)
            # global sweep + local Gaussian refinement around the incumbent
            # EI argmax (cheap surrogate for skopt's L-BFGS restarts)
            cands = rng.rand(8192, d)
            mu, sigma = gp.predict(cands, return_std=True)
            ei = _expected_improvement(mu, sigma, best_y)
            u = cands[int(np.argmax(ei))]
            best_ei = float(np.max(ei))
            for width in (0.1, 0.03, 0.01):
                local = np.clip(u[None, :] + rng.randn(256, d) * width, 0.0, 1.0)
                mu, sigma = gp.predict(local, return_std=True)
                ei = _expected_improvement(mu, sigma, best_y)
                j = int(np.argmax(ei))
                if float(ei[j]) > best_ei:
                    best_ei = float(ei[j])
                    u = local[j]
        tell(decode_point(list(dimensions), u))
    return result


def gp_minimize(
    func,
    dimensions,
    n_calls: int = 50,
    n_random_starts: int = 10,
    random_state=None,
    verbose: bool = False,
    callback=None,
    x0=None,
    y0=None,
):
    rng = np.random.RandomState(random_state)
    callbacks = list(callback or [])
    return _run(func, dimensions, n_calls, rng, callbacks, x0, y0, n_random_starts, True, verbose)


def dummy_minimize(
    func,
    dimensions,
    n_calls: int = 50,
    random_state=None,
    verbose: bool = False,
    callback=None,
    x0=None,
    y0=None,
):
    rng = np.random.RandomState(random_state)
    callbacks = list(callback or [])
    return _run(func, dimensions, n_calls, rng, callbacks, x0, y0, 0, False, verbose)
