"""Column-to-column similarity with top-K pruning.

Port of ganmf_tpu/ops/similarity.py. The Gram matrix A^T A is one float32
product over the dense interaction matrix on the device, the normalization
family (cosine / adjusted / asymmetric / pearson / jaccard / dice / tversky /
euclidean) is elementwise, in the JAX package's order step by step, and each
column's top K comes from ``tiled_topk`` (lowest index first on ties). Only
the preprocessing and the final CSR assembly run on the host.

The JAX package is plain XLA here, with no Pallas kernel, and so is the port:
the products are ``torch.matmul`` with TF32 off (utils/device.py). On 0/1
data every partial sum of the Gram is an integer below 2^24, so the float32
product is exact in any summation order: the JAX package's one-pass bf16
Gram (``bf16_ok``), its float32 one and the port's are bitwise equal.

Routes, chosen by JAX's rules and byte limits (6 GB defaults, so that one
input takes one route in both packages):

- dense: A [n_rows, n_cols] on the device when its float32 bytes are within
  ``_DENSE_A_BYTE_LIMIT``;
- past that, streamed: the Gram is accumulated over ``_STREAM_CHUNK``-row
  chunks of the padded-CSR planes (``_gram_streamed``). For binary data it is
  the dense route's G.

Not ported: JAX's resident-bf16 Gram (:214-236), which gives the streamed
route's G and was slower than it on an H100 at the one shape measured
(PERF.md); the column-blocked build for a Gram past ``_GRAM_BYTE_LIMIT`` and
its int8 form (:294-388), and the build sharded over a mesh (:391-470).
Where the JAX package would take the last three this raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.data.device import dense_from_sparse, padded_csr_from_sparse
from ganmf_tpu_torch.ops.topk import scatter_col_topk_dense, tiled_topk
from ganmf_tpu_torch.utils.device import as_device

SIMILARITIES = ("cosine", "adjusted", "asymmetric", "pearson", "jaccard", "tanimoto", "dice", "tversky", "euclidean")

# Above this dense size the [n_rows, n_cols] data matrix never materializes
# on the device; the Gram accumulates over padded-CSR row chunks instead.
_DENSE_A_BYTE_LIMIT = 6 << 30

# Above this Gram size (bytes of the float32 [I, I] matrix) the JAX package
# builds target columns in blocks; that build is not ported.
_GRAM_BYTE_LIMIT = 6 << 30

# Rows a streamed Gram chunk holds.
_STREAM_CHUNK = 2048


def _f32(x) -> np.float32:
    return np.float32(x)


def _w_block(
    G: torch.Tensor,  # [n_cand, n_targ] Gram block
    ss2_cand: torch.Tensor,  # [n_cand] sum of squares per candidate column
    ss2_targ: torch.Tensor,  # [n_targ] per target column
    targ_off: int,  # global index of the block's first target column
    n_rows: int,
    row_weights: torch.Tensor,
    mode: str,
    shrink: float,
    normalize: bool,
    asymmetric_alpha: float,
    tversky_alpha: float,
    tversky_beta: float,
    normalize_avg_row: bool,
    distance_mode: str,
    use_row_weights: bool,
) -> torch.Tensor:
    """Similarity block W[i, j] of candidate item i against target column j
    (ganmf_tpu/ops/similarity.py:32-122), each elementwise step in JAX's
    order. The scalars are float32, as JAX traces them: a scalar expression
    such as 2 (1 - alpha) is rounded as JAX rounds it."""
    dev = G.device
    n_cand, n_targ = G.shape
    cand = torch.arange(n_cand, device=dev)[:, None]
    targ = torch.arange(n_targ, device=dev)[None, :] + targ_off
    eye = cand == targ
    shrink = float(_f32(shrink))

    if mode == "euclidean":
        # (a-b)^2 = a^2 + b^2 - 2ab; reference Compute_Similarity_Euclidean.py:170-207
        dist = ss2_targ[None, :] + ss2_cand[:, None] - 2.0 * G
        dist = torch.where(eye, 0.0, dist)
        if use_row_weights:
            # the reference scales the candidate axis (dim 0 here) by the
            # row weights; compute_similarity requires a square matrix
            dist = dist * row_weights[:n_cand, None]
        if normalize:
            dist = dist / (torch.sqrt(ss2_cand)[:, None] * torch.sqrt(ss2_targ)[None, :])
        if normalize_avg_row:
            dist = dist / n_rows
        dist = torch.sqrt(torch.clamp_min(dist, 0.0))
        if distance_mode == "exp":
            W = 1.0 / (torch.exp(dist) + shrink + 1e-9)
        elif distance_mode == "log":
            W = 1.0 / (torch.log(dist + 1.0) + shrink + 1e-9)
        else:
            W = 1.0 / (dist + shrink + 1e-9)
        # the JAX package's hashed relative perturbation (~1e-6) that spreads
        # euclidean's exact ties over the columns. Its uint32 hash wraps at
        # 2^32; the low 20 bits it keeps are those of the exact product, so
        # int64 gives the same hash
        h = (cand * 2654435761 + targ * 97777) & 0xFFFFF
        W = W * (1.0 + 1e-6 * (h.to(torch.float32) / float(1 << 20)))
        W = torch.where(eye, 0.0, W)
    else:
        W = torch.where(eye, 0.0, G)
        if normalize:
            if mode == "asymmetric":
                # alpha weights the target column j, (1 - alpha) the candidate
                # rows i (Compute_Similarity_Python.py:248-312)
                a = _f32(asymmetric_alpha)
                e_cand = float(_f32(2.0) * (_f32(1.0) - a))
                e_targ = float(_f32(2.0) * a)
                den = torch.pow(torch.sqrt(ss2_cand), e_cand)[:, None] * torch.pow(
                    torch.sqrt(ss2_targ), e_targ
                )[None, :] + shrink + 1e-6
            else:
                den = torch.sqrt(ss2_cand)[:, None] * torch.sqrt(ss2_targ)[None, :] + shrink + 1e-6
            W = W / den
        elif mode in ("jaccard", "tanimoto"):
            W = W / (ss2_cand[:, None] + ss2_targ[None, :] - W + shrink + 1e-6)
        elif mode == "dice":
            W = W / (ss2_cand[:, None] + ss2_targ[None, :] + shrink + 1e-6)
        elif mode == "tversky":
            # tversky_alpha weights the target column j, tversky_beta the
            # candidate rows i (Compute_Similarity_Python.py:328-332)
            ta, tb = float(_f32(tversky_alpha)), float(_f32(tversky_beta))
            W = W / (
                W
                + (ss2_targ[None, :] - W) * ta
                + (ss2_cand[:, None] - W) * tb
                + shrink
                + 1e-6
            )
        elif shrink != 0:
            # unnormalized cosine with a shrink term (the JAX package fails
            # to trace this branch: it tests a traced shrink)
            W = W / shrink

    # cold-item pairs give 0/0 = NaN under the normalizations; dense scoring
    # would propagate them, so they are zeroed
    return torch.where(torch.isnan(W), 0.0, W)


def _dense_gram(A: torch.Tensor, row_weights: torch.Tensor, gram_rw: bool) -> torch.Tensor:
    """G = A^T diag(w) A (with row weights, except euclidean's) or A^T A, in
    float32 with TF32 off (JAX :147-158)."""
    if gram_rw:
        return (row_weights[:, None] * A).T @ A
    return A.T @ A


def _gram_streamed(idx, val, w_pad, n_cols: int, chunk: int, gram_rw: bool) -> torch.Tensor:
    """G = A^T diag(w) A accumulated over padded-CSR row chunks (JAX
    :176-211): each chunk is scattered into a [chunk, n_cols] block (pad slots
    carry the sentinel column n_cols and the value 0) and ``chunk^T @ chunk``
    is added to the float32 Gram. The dense [n_rows, n_cols] matrix never
    exists. The row count must be a multiple of ``chunk``."""
    G = torch.zeros((n_cols, n_cols), dtype=torch.float32, device=val.device)
    for lo in range(0, idx.shape[0], chunk):
        D = torch.zeros((chunk, n_cols + 1), dtype=torch.float32, device=val.device)
        D = D.scatter_add_(1, idx[lo : lo + chunk], val[lo : lo + chunk])[:, :n_cols]
        left = w_pad[lo : lo + chunk, None] * D if gram_rw else D
        G.addmm_(left.T, D)
    return G


def _similarity_topk_from_gram(G, ss2, row_weights, n_rows: int, *, mode: str, topk: int, **w_kwargs):
    """Normalize G into W and keep each column's top ``topk`` rows (JAX
    :129-174, :243-268): ([n_cols, topk] values, [n_cols, topk] row ids)."""
    W = _w_block(G, ss2, ss2, 0, n_rows, row_weights, mode, **w_kwargs)
    del G
    # W[i, j]: similarity of row-item i to column-item j; the reference keeps
    # the top-K per column
    return tiled_topk(W.T, topk)


def build_gram(X: sps.csr_matrix, row_weights: torch.Tensor, gram_rw: bool, device: torch.device):
    """(G, ss2, route) of the preprocessed data X by the route
    ``compute_similarity`` takes: "dense" or "streamed". ss2 is each column's
    sum of squares."""
    n_rows, n_cols = X.shape
    if 4 * n_rows * n_cols <= _DENSE_A_BYTE_LIMIT:
        A = dense_from_sparse(X, device)
        return _dense_gram(A, row_weights, gram_rw), torch.sum(A * A, dim=0), "dense"
    if 4 * n_cols * n_cols > _GRAM_BYTE_LIMIT:
        raise NotImplementedError(
            f"a {n_cols} x {n_cols} Gram passes _GRAM_BYTE_LIMIT: the column-blocked similarity "
            "build (and its int8 form) is not ported")
    chunk = _STREAM_CHUNK
    pc = padded_csr_from_sparse(X, device)
    pad_rows = (-n_rows) % chunk
    idx_a, val_a, w_pad = pc.idx, pc.val, row_weights
    if pad_rows:
        idx_a = torch.cat([idx_a, torch.full((pad_rows, idx_a.shape[1]), n_cols, dtype=idx_a.dtype, device=device)])
        val_a = torch.cat([val_a, torch.zeros((pad_rows, val_a.shape[1]), dtype=val_a.dtype, device=device)])
        w_pad = torch.cat([row_weights, torch.zeros(pad_rows, dtype=row_weights.dtype, device=device)])
    ss2 = torch.from_numpy(np.asarray(X.multiply(X).sum(axis=0), dtype=np.float32).ravel()).to(device)
    return _gram_streamed(idx_a, val_a, w_pad, n_cols, chunk, gram_rw), ss2, "streamed"


def csc_from_col_topk(vals, idx, n: int) -> sps.csc_matrix:
    """[n, n] CSC from per-column top-k candidates: column j holds rows
    idx[j] with values vals[j]; zero and -inf values are dropped, as the
    JAX package's CSC assemblies do (:698-708)."""
    vals = vals.cpu().numpy() if isinstance(vals, torch.Tensor) else np.asarray(vals)
    idx = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    vals = vals.astype(np.float32, copy=False)
    keep = np.isfinite(vals) & (vals != 0.0)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    return sps.csc_matrix((vals[keep], idx[keep], indptr), shape=(n, n), dtype=np.float32)


def compute_similarity(
    data_matrix,
    similarity: str = "cosine",
    topK: int = 100,
    shrink: float = 0,
    normalize: bool = True,
    asymmetric_alpha: float = 0.5,
    tversky_alpha: float = 1.0,
    tversky_beta: float = 1.0,
    normalize_avg_row: bool = False,
    similarity_from_distance_mode: str = "lin",
    row_weights: Optional[np.ndarray] = None,
    mesh_plan=None,
    export: str = "csr",
    *,
    device=None,
    **_unused,
):
    """Column-to-column similarity with top-K pruning (JAX :473-708; the
    reference Compute_Similarity dispatcher). Returns CSR [n_cols, n_cols]
    whose column j holds the top-K items most similar to j, exact zeros
    dropped; with ``export="device"``, the same matrix dense on the device.
    ``device`` defaults to the card and raises without one."""
    if similarity not in SIMILARITIES:
        raise ValueError(f"similarity must be one of {SIMILARITIES}, got '{similarity}'")
    if export not in ("csr", "device"):
        raise ValueError(f"export must be 'csr' or 'device', got '{export}'")
    if mesh_plan is not None:
        raise NotImplementedError("mesh_plan: the sharded similarity build is not ported")
    device = as_device(device)

    X = sps.csr_matrix(data_matrix, dtype=np.float32).copy()
    n_rows, n_cols = X.shape
    if row_weights is not None and similarity == "euclidean" and n_rows != n_cols:
        # the reference's euclidean row weighting only type-checks on a
        # square matrix (Compute_Similarity_Euclidean.py:181)
        raise ValueError(f"euclidean row_weights requires a square matrix, got {X.shape}")
    topK = min(topK, n_cols)

    # preprocessing (Compute_Similarity_Python.py:117-204)
    if similarity == "adjusted":
        nnz_per_row = np.diff(X.indptr)
        row_sum = np.asarray(X.sum(axis=1)).ravel()
        avg = np.divide(row_sum, nnz_per_row, out=np.zeros_like(row_sum), where=nnz_per_row > 0)
        X.data = X.data - np.repeat(avg, nnz_per_row)
        mode = "cosine"
    elif similarity == "pearson":
        Xc = X.tocsc()
        nnz_per_col = np.diff(Xc.indptr)
        col_sum = np.asarray(Xc.sum(axis=0)).ravel()
        avg = np.divide(col_sum, nnz_per_col, out=np.zeros_like(col_sum), where=nnz_per_col > 0)
        Xc.data = Xc.data - np.repeat(avg, nnz_per_col)
        X = Xc.tocsr()
        mode = "cosine"
    elif similarity in ("jaccard", "tanimoto", "dice", "tversky"):
        X.data = np.ones_like(X.data)
        mode = "jaccard" if similarity == "tanimoto" else similarity
        # the binary-set similarities carry their own normalization
        # (Compute_Similarity_Python.py:77-87)
        normalize = False
    else:
        mode = similarity

    rw = torch.from_numpy(
        np.asarray(row_weights, dtype=np.float32) if row_weights is not None else np.ones(n_rows, np.float32)
    ).to(device)
    use_row_weights = row_weights is not None
    # row weights fold into the Gram except for euclidean, whose reference
    # semantics weight the distances (_w_block)
    G, ss2, _ = build_gram(X, rw, use_row_weights and mode != "euclidean", device)
    vals, idx = _similarity_topk_from_gram(
        G, ss2, rw, n_rows, mode=mode, topk=topK, shrink=float(shrink), normalize=bool(normalize),
        asymmetric_alpha=float(asymmetric_alpha), tversky_alpha=float(tversky_alpha),
        tversky_beta=float(tversky_beta), normalize_avg_row=bool(normalize_avg_row),
        distance_mode=similarity_from_distance_mode, use_row_weights=use_row_weights,
    )
    del G
    if export == "device":
        return scatter_col_topk_dense(vals, idx)
    return csc_from_col_topk(vals, idx, n_cols).tocsr()
