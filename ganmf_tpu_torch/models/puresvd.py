"""PureSVD: truncated SVD of the interaction matrix.

Port of ganmf_tpu/models/puresvd.py (the reference wraps sklearn's
randomized_svd, MatrixFactorization/PureSVDRecommender.py:29-37). A
randomized range finder with CholeskyQR passes (n_oversample=10, n_iter=7)
runs as float32 matmuls on the model's device (TF32 off, utils/device.py),
and only the (k + p) x I projection goes through ``torch.linalg.svd``. The
factors stay on the device; K1 ranks them.

``fit`` picks one of three routes, as the JAX fit does (:183-229):
- dense: the [U, I] URM on the device;
- resident bf16, when the dense URM would pass ``_DENSE_URM_BYTE_LIMIT`` but
  a bfloat16 copy fits ``RESIDENT_BF16_BYTES`` and every value is exact in
  bfloat16: every pass multiplies the bf16 matrix, whose products with a
  bf16-rounded iterate are exact in float32. The JAX package asks its matmul
  for float32 outputs; here row chunks of A are upcast to float32 before the
  product, which gives the same exact products summed in float32;
- streamed: each pass densifies ``STREAM_CHUNK`` rows at a time from the
  padded-CSR planes.

The Gaussian test matrix Omega is drawn from a CPU ``torch.Generator`` seeded
with ``random_seed`` by ``draw_omega`` (JAX draws it with ``jax.random``), so
a seed gives the same Omega on every device; ``fit`` also takes an ``omega``.

Host syncs: the Cholesky factorizations use ``cholesky_ex``, which does not
read its status back; the one sync before the fit's final probe (JAX :215,
:225) is ``torch.linalg.svd``'s check of the small projection at its end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ganmf_tpu_torch.data.device import PaddedCSR, dense_bf16_from_padded, padded_rows_dense
from ganmf_tpu_torch.models.base import MatrixFactorizationRecommender

#: Device bytes the resident route may give the bf16 matrix (JAX: 9 GiB).
RESIDENT_BF16_BYTES = 9 << 30

#: Rows densified or upcast at a time by the resident and streamed routes.
STREAM_CHUNK = 2048

N_OVERSAMPLE = 10


def draw_omega(n_cols: int, k: int, random_seed: int, device: torch.device) -> torch.Tensor:
    """The [n_cols, k] standard-normal test matrix, drawn on the host."""
    gen = torch.Generator().manual_seed(int(random_seed))
    return torch.randn((n_cols, k), generator=gen, dtype=torch.float32).to(device)


def _cholqr(Y: torch.Tensor) -> torch.Tensor:
    """One CholeskyQR pass (JAX :32-42): Q = Y L^-T with L L^T = Y^T Y plus a
    ridge of 1e-7 of its mean diagonal."""
    G = Y.T @ Y
    G = G + 1e-7 * torch.trace(G) / G.shape[0] * torch.eye(G.shape[0], dtype=Y.dtype, device=Y.device)
    L = torch.linalg.cholesky_ex(G).L
    return torch.linalg.solve_triangular(L, Y.T, upper=False).T


def _cholqr2(Y: torch.Tensor) -> torch.Tensor:
    """CholeskyQR2: two passes give near-Householder orthogonality."""
    return _cholqr(_cholqr(Y))


def _range_finder(mm_a, mm_at, omega: torch.Tensor, num_factors: int, n_iter: int, mm_at_final=None):
    """(U [rows, f], V [I, f]) with V = (S Vt)^T, from products with A
    (``mm_a``: [I, k] -> [rows, k]) and A^T (``mm_at``: [rows, k] -> [I, k])
    (JAX :50-72). B = Q^T A is ``mm_at_final(Q)^T`` (default ``mm_at``)."""
    Y = mm_a(omega)
    for _ in range(n_iter):
        Y = _cholqr(Y)
        Z = _cholqr(mm_at(Y))
        Y = mm_a(Z)
    Q = _cholqr2(Y)
    Ub, S, Vt = torch.linalg.svd((mm_at_final or mm_at)(Q).T, full_matrices=False)
    U = Q @ Ub
    return U[:, :num_factors], (S[:num_factors, None] * Vt[:num_factors]).T


def puresvd_factors(A: torch.Tensor, omega: torch.Tensor, num_factors: int, n_iter: int):
    """The dense route: A [U, I] float32 on the device."""
    return _range_finder(lambda X: A @ X, lambda Y: A.T @ Y, omega, num_factors, n_iter)


def puresvd_factors_resident(Ab: torch.Tensor, omega: torch.Tensor, num_factors: int, n_iter: int,
                             chunk: int = STREAM_CHUNK):
    """The resident route (JAX :79-120): Ab [R, I] bfloat16, bf16-exact. The
    iterates are rounded to bfloat16 before each product with Ab, as the JAX
    package does; each product upcasts ``chunk`` rows of Ab at a time and
    multiplies in float32. The final projection runs Q as two bf16 planes
    (hi + lo), so B = Q^T A carries about 16 mantissa bits."""
    R = Ab.shape[0]

    def bf16(X):
        return X.to(torch.bfloat16).float()

    def mm_a(X):  # [I, k] -> [R, k]
        Xb = bf16(X)
        return torch.cat([Ab[lo : lo + chunk].float() @ Xb for lo in range(0, R, chunk)])

    def mm_at(Y):  # [R, k] -> [I, k]
        Yb = bf16(Y)
        Z = torch.zeros((Ab.shape[1], Y.shape[1]), dtype=torch.float32, device=Y.device)
        for lo in range(0, R, chunk):
            Z += Ab[lo : lo + chunk].float().T @ Yb[lo : lo + chunk]
        return Z

    def mm_at_planes(Q):
        hi = bf16(Q)
        return mm_at(hi) + mm_at(Q - hi)

    return _range_finder(mm_a, mm_at, omega, num_factors, n_iter, mm_at_final=mm_at_planes)


def puresvd_factors_streamed(idx: torch.Tensor, val: torch.Tensor, n_cols: int, omega: torch.Tensor,
                             num_factors: int, n_iter: int, chunk: int = STREAM_CHUNK):
    """The streamed route (JAX :123-177): the products stream over ``chunk``
    rows of the padded-CSR planes (idx, val [R, L], R a multiple of chunk),
    each densified to [chunk, I] float32 on the device; the dense [R, I]
    matrix never exists."""
    R = idx.shape[0]
    rows = torch.arange(chunk, device=idx.device)

    def dense_chunk(lo):
        return padded_rows_dense(PaddedCSR(idx[lo : lo + chunk], val[lo : lo + chunk]), rows, n_cols)

    def mm_a(X):
        return torch.cat([dense_chunk(lo) @ X for lo in range(0, R, chunk)])

    def mm_at(Y):
        Z = torch.zeros((n_cols, Y.shape[1]), dtype=torch.float32, device=Y.device)
        for lo in range(0, R, chunk):
            Z += dense_chunk(lo).T @ Y[lo : lo + chunk]
        return Z

    return _range_finder(mm_a, mm_at, omega, num_factors, n_iter)


class PureSVDRecommender(MatrixFactorizationRecommender):
    RECOMMENDER_NAME = "PureSVDRecommender"

    def fit_route(self) -> str:
        """The route ``fit`` takes (JAX :183-203): "dense" while the dense
        float32 URM is within ``_DENSE_URM_BYTE_LIMIT``; past it "resident"
        when the bf16 matrix is exact and its rows, padded to a multiple of
        ``STREAM_CHUNK``, fit ``RESIDENT_BF16_BYTES``; else "streamed"."""
        if not self._urm_streams():
            return "dense"
        rows = -(-self.n_users // STREAM_CHUNK) * STREAM_CHUNK
        if self._urm_values_bf16_exact() and 2 * rows * self.n_items <= RESIDENT_BF16_BYTES:
            return "resident"
        return "streamed"

    def fit(self, num_factors: int = 100, random_seed: int = 1234, n_iter: int = 7,
            omega: Optional[torch.Tensor] = None):
        """Factorize the training URM by one of the three routes (JAX
        :183-229). ``omega`` ([I, num_factors + 10] float32) replaces the
        test matrix ``draw_omega`` would draw from ``random_seed``."""
        num_factors, n_iter = int(num_factors), int(n_iter)
        k = num_factors + N_OVERSAMPLE
        if omega is None:
            omega = draw_omega(self.n_items, k, random_seed, self.device)
        elif not isinstance(omega, torch.Tensor):
            omega = torch.from_numpy(np.array(omega, dtype=np.float32))
        omega = omega.to(self.device, torch.float32)
        if omega.shape != (self.n_items, k):
            raise ValueError(f"omega must be [{self.n_items}, {k}], got {tuple(omega.shape)}")
        route = self.fit_route()
        if route != "dense":
            pc = self._padded_urm()
            pad = (-self.n_users) % STREAM_CHUNK
            idx, val = pc.idx, pc.val
            if pad:
                idx = torch.cat([idx, torch.full((pad, idx.shape[1]), self.n_items, dtype=idx.dtype,
                                                 device=idx.device)])
                val = torch.cat([val, torch.zeros((pad, val.shape[1]), dtype=val.dtype, device=val.device)])
            if route == "resident":
                Ab = dense_bf16_from_padded(idx, val, self.n_items, STREAM_CHUNK)
                U, V = puresvd_factors_resident(Ab, omega, num_factors, n_iter)
                del Ab
            else:
                U, V = puresvd_factors_streamed(idx, val, self.n_items, omega, num_factors, n_iter)
            U = U[: self.n_users]
        else:
            U, V = puresvd_factors(self.device_urm().dense, omega, num_factors, n_iter)
        float(U[0, 0])  # the JAX fit's probe: fit returns with the factors built
        # the factor setters drop the device factors; the URM caches stay
        self.USER_factors, self.ITEM_factors = U, V
