"""Column-to-column similarity with top-K pruning.

Port of ganmf_tpu/ops/similarity.py. The Gram matrix A^T A is one float32
product over the dense interaction matrix on the device, the normalization
family (cosine / adjusted / asymmetric / pearson / jaccard / dice / tversky /
euclidean) is elementwise, in the JAX package's order step by step, and each
column's top K comes from ``tiled_topk`` (lowest index first on ties). Only
the preprocessing and the final CSR assembly run on the host.

The JAX package is plain XLA here, with no Pallas kernel, and so is the port:
the products are library calls. For binary data without row weights (JAX's
``bf16_ok``, :550-559) every route builds the Gram as bf16 products
accumulated and returned in float32 (``simscore.bf16_mm``: the tensor cores
on the card), as JAX does (:150-156, :177-236, :294-336, :435-437); other
data (ratings, centered data, row weights) multiplies in float32 with TF32
off (utils/device.py). On 0/1 data every partial sum of the Gram is an
integer below 2^24, so G is exact in any summation order: every route's G,
in either product, and JAX's are bitwise equal.

Routes, chosen by JAX's rules and byte limits (:600-680), so that one input
takes one route in both packages (``build_route``):

- dense: A [n_rows, n_cols] on the device when its float32 bytes are within
  ``_DENSE_A_BYTE_LIMIT``;
- past that, resident (binary data): A kept on the device as dense bf16
  (``dense_bf16_from_padded``) and the Gram accumulated over
  ``_STREAM_CHUNK``-row slices of it (JAX :214-236), where JAX's rule
  (:655-668) finds room for the bf16 A, the float32 Gram, the padded planes
  and 1 GiB, with the device's memory in place of a TPU's;
- else streamed: the Gram is accumulated over ``_STREAM_CHUNK``-row chunks
  of the padded-CSR planes (``_slab_gram_scatter`` over every column; bf16
  chunks for binary data);
- past that, when the float32 [I, I] Gram would pass ``_GRAM_BYTE_LIMIT``,
  column-blocked (:294-388): target columns are built and ranked in slabs of
  ``width`` columns, a [n_cols, width] Gram slab at a time, so the [I, I]
  Gram never exists. The slab is accumulated over the padded-CSR row chunks
  (the scatter form, bf16 for binary data), or, for binary data whose dense
  int8 matrix fits ``_INT8_A_BYTE_LIMIT``, read from A kept resident as int8:
  one int8 x int8 -> int32 product a slab (``torch._int_mm``, a library
  GEMM, where JAX leaves the product to XLA), exact for 0/1 counts. The slab
  width beside A8 is capped by the device's own memory (the card's total, or
  the host's for CPU tensors), not by a TPU's. ``export="device"`` raises
  there, as in JAX.

The 6 GiB and 9 GiB limits are the JAX package's defaults, set on a TPU; an
H100 measurement of where each route wins is still to make.

With a ``mesh_plan`` whose model axis has more than one rank, the dense
route is sharded over that axis (:391-470): each model rank builds the Gram
block of its own target columns against every candidate, normalizes it,
masks the padded candidates to -inf (so that negative similarities still
rank above them) and ranks its columns; the ranks' candidates are gathered
over ``model``. No streamed or column-blocked route is taken under such a
plan, and ``export="device"`` raises there, as in JAX (:577-580, :686-691).
"""

from __future__ import annotations

from typing import Optional

import os

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.data.device import dense_bf16_from_padded, dense_from_sparse, padded_csr_from_sparse
from ganmf_tpu_torch.ops.simscore import bf16_mm
from ganmf_tpu_torch.ops.topk import scatter_col_topk_dense, tiled_topk
from ganmf_tpu_torch.utils.device import as_device

SIMILARITIES = ("cosine", "adjusted", "asymmetric", "pearson", "jaccard", "tanimoto", "dice", "tversky", "euclidean")

# Above this dense size the [n_rows, n_cols] data matrix never materializes
# on the device; the Gram accumulates over padded-CSR row chunks instead.
_DENSE_A_BYTE_LIMIT = 6 << 30

# Above this Gram size (bytes of the float32 [I, I] matrix) the streamed
# build ranks target columns in slabs: the full Gram never exists.
_GRAM_BYTE_LIMIT = 6 << 30

# Bytes of a binary interaction matrix kept resident as dense int8 during a
# column-blocked build.
_INT8_A_BYTE_LIMIT = 9 << 30

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


def _dense_gram(A: torch.Tensor, row_weights: torch.Tensor, gram_rw: bool, binary: bool = False) -> torch.Tensor:
    """G = A^T diag(w) A (with row weights, except euclidean's) or A^T A
    (JAX :147-158): for binary data one bf16 product with float32
    accumulation, else float32 with TF32 off."""
    if gram_rw:
        return (row_weights[:, None] * A).T @ A
    if binary:
        Ab = A.to(torch.bfloat16)
        return bf16_mm(Ab.T, Ab)
    return A.T @ A


def _similarity_topk_from_gram(G, ss2, row_weights, n_rows: int, *, mode: str, topk: int, **w_kwargs):
    """Normalize G into W and keep each column's top ``topk`` rows (JAX
    :129-174, :243-268): ([n_cols, topk] values, [n_cols, topk] row ids)."""
    W = _w_block(G, ss2, ss2, 0, n_rows, row_weights, mode, **w_kwargs)
    del G
    # W[i, j]: similarity of row-item i to column-item j; the reference keeps
    # the top-K per column
    return tiled_topk(W.T, topk)


def _padded_planes(X: sps.csr_matrix, row_weights: torch.Tensor, device: torch.device):
    """The padded-CSR planes of X with rows padded to a multiple of
    ``_STREAM_CHUNK`` (pad rows hold the sentinel column and the value 0),
    the row weights padded with 0, and each column's sum of squares."""
    n_rows, n_cols = X.shape
    pc = padded_csr_from_sparse(X, device)
    pad_rows = (-n_rows) % _STREAM_CHUNK
    idx_a, val_a, w_pad = pc.idx, pc.val, row_weights
    if pad_rows:
        idx_a = torch.cat([idx_a, torch.full((pad_rows, idx_a.shape[1]), n_cols, dtype=idx_a.dtype, device=device)])
        val_a = torch.cat([val_a, torch.zeros((pad_rows, val_a.shape[1]), dtype=val_a.dtype, device=device)])
        w_pad = torch.cat([row_weights, torch.zeros(pad_rows, dtype=row_weights.dtype, device=device)])
    ss2 = torch.from_numpy(np.asarray(X.multiply(X).sum(axis=0), dtype=np.float32).ravel()).to(device)
    return idx_a, val_a, w_pad, ss2


def build_route(n_rows: int, n_cols: int, mesh_plan=None, *, binary: bool = False, row_len: int = 1,
                device: Optional[torch.device] = None) -> str:
    """The route ``compute_similarity`` takes for an [n_rows, n_cols] input
    (JAX :577-680): "sharded" under a plan with more than one model rank,
    else "dense", "resident", "streamed" or "colblock" by the byte limits.
    "resident" is JAX's rule (:655-668) with the device's memory in place of
    a TPU's: ``binary`` data (JAX's ``bf16_ok``) whose bf16 A, float32 Gram,
    padded planes (its longest row ``row_len``, at JAX's 8 bytes a slot) and
    1 GiB fit the ``device``."""
    if mesh_plan is not None and mesh_plan.n_model > 1:
        return "sharded"
    if 4 * n_rows * n_cols <= _DENSE_A_BYTE_LIMIT:
        return "dense"
    if 4 * n_cols * n_cols > _GRAM_BYTE_LIMIT:
        return "colblock"
    n_rows_pad = -(-n_rows // _STREAM_CHUNK) * _STREAM_CHUNK
    need = 2 * n_rows_pad * n_cols + 4 * n_cols * n_cols + 8 * n_rows_pad * max(row_len, 1) + (1 << 30)
    return "resident" if binary and need <= device_memory_bytes(device) else "streamed"


def _gram_resident_bf16(Ab: torch.Tensor, chunk: int) -> torch.Tensor:
    """G = A^T A over the resident dense bf16 A (JAX :214-236), ``chunk``
    rows at a time: each slice's bf16 product accumulated into the float32
    G. The row count must be a multiple of ``chunk``."""
    G = torch.zeros((Ab.shape[1], Ab.shape[1]), dtype=torch.float32, device=Ab.device)
    for lo in range(0, Ab.shape[0], chunk):
        D = Ab[lo : lo + chunk]
        bf16_mm(D.T, D, out=G)
    return G


def build_gram(X: sps.csr_matrix, row_weights: torch.Tensor, gram_rw: bool, device: torch.device,
               binary: bool = False):
    """(G, ss2, route) of the preprocessed data X by the dense, resident or
    streamed route (below ``_GRAM_BYTE_LIMIT``), bf16 products for
    ``binary`` data (0/1 without row weights). ss2 is each column's sum of
    squares."""
    n_rows, n_cols = X.shape
    binary = binary and not gram_rw
    row_len = max(int(np.ediff1d(X.indptr).max()) if n_rows else 0, 1)
    route = build_route(n_rows, n_cols, binary=binary, row_len=row_len, device=device)
    if route == "dense":
        A = dense_from_sparse(X, device)
        return _dense_gram(A, row_weights, gram_rw, binary), torch.sum(A * A, dim=0), route
    idx_a, val_a, w_pad, ss2 = _padded_planes(X, row_weights, device)
    if route == "resident":
        Ab = dense_bf16_from_padded(idx_a, val_a, n_cols, _STREAM_CHUNK)
        del idx_a, val_a  # the padded planes go before the Gram lands
        return _gram_resident_bf16(Ab, _STREAM_CHUNK), ss2, route
    G = _slab_gram_scatter(idx_a, val_a, w_pad, n_cols, 0, n_cols, _STREAM_CHUNK, gram_rw, binary)
    return G, ss2, route


def device_memory_bytes(device: torch.device) -> int:
    """The device's memory: the card's total, or the host's for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def colblock_plan(n_rows_pad: int, n_cols: int, binary: bool, device: torch.device):
    """(slab width, int8 form?) of the column-blocked build (JAX
    :611-631): slabs of half the Gram budget, at least 512 columns; the int8
    form for binary data whose dense int8 matrix fits
    ``_INT8_A_BYTE_LIMIT``, its slab capped to what fits beside A8 on the
    device (about 24 bytes a slab element for the Gram, the int32 product
    and the ranking's buffers, and 1 GiB of headroom)."""
    width = int(min(n_cols, max(512, _GRAM_BYTE_LIMIT // 2 // (4 * n_cols) // 256 * 256)))
    use_int8 = binary and n_rows_pad * n_cols <= _INT8_A_BYTE_LIMIT
    if use_int8:
        free = device_memory_bytes(device) - n_rows_pad * n_cols - (1 << 30)
        w_int8 = free // (24 * n_cols) // 256 * 256
        if w_int8 >= 512:
            width = int(min(width, w_int8))
        else:
            use_int8 = False  # no useful slab fits beside A8
    return width, use_int8


def _dense_int8_t_from_padded(idx, val, n_cols: int, chunk: int) -> torch.Tensor:
    """The binary matrix as dense int8, transposed: [n_cols, R], built
    ``chunk`` rows at a time (JAX's ``_dense_int8_from_padded``, :338-352,
    kept column-major so that each slab is a row range of it)."""
    R = idx.shape[0]
    out = torch.empty((n_cols, R), dtype=torch.int8, device=idx.device)
    for lo in range(0, R, chunk):
        block = torch.zeros((chunk, n_cols + 1), dtype=torch.float32, device=idx.device)
        block.scatter_add_(1, idx[lo : lo + chunk], val[lo : lo + chunk])
        out[:, lo : lo + chunk] = block[:, :n_cols].T.to(torch.int8)
    return out


def _slab_gram_int8(A8t: torch.Tensor, off: int, width: int) -> torch.Tensor:
    """[n_cols, width] float32 Gram slab A^T A[:, off:off + width] from the
    resident int8 A^T: one int8 x int8 -> int32 product (``torch._int_mm``;
    on the card cuBLASLt, whose int8 product wants A row-major and B
    column-major, as these views are), exact for 0/1 counts below 2^24
    (JAX :355-388)."""
    return torch._int_mm(A8t, A8t[off : off + width].T).to(torch.float32)


def _slab_gram_scatter(idx, val, w_pad, n_cols: int, off: int, width: int, chunk: int,
                       gram_rw: bool, binary: bool = False) -> torch.Tensor:
    """[n_cols, width] float32 Gram slab G = A^T diag(w) A[:, off:off + width]
    accumulated over padded-CSR row chunks (JAX :176-211, :294-335): each
    chunk is scattered into a [chunk, n_cols] block (pad slots carry the
    sentinel column n_cols and the value 0) and left^T @ T is added, T the
    block's target columns and left = w * D with row weights. The dense
    [n_rows, n_cols] matrix never exists. ``binary`` data (0/1, no row
    weights) is scattered in bf16 and multiplied by bf16 products with
    float32 accumulation, other data in float32 with TF32 off; both are
    exact on 0/1 data. The row count must be a multiple of ``chunk``."""
    dt = torch.bfloat16 if binary else torch.float32
    G = torch.zeros((n_cols, width), dtype=torch.float32, device=val.device)
    for lo in range(0, idx.shape[0], chunk):
        D = torch.zeros((chunk, n_cols + 1), dtype=dt, device=val.device)
        D = D.scatter_add_(1, idx[lo : lo + chunk], val[lo : lo + chunk].to(dt))[:, :n_cols]
        if binary:
            bf16_mm(D.T, D[:, off : off + width], out=G)
            continue
        left = w_pad[lo : lo + chunk, None] * D if gram_rw else D
        G.addmm_(left.T, D[:, off : off + width])
    return G


def similarity_topk_colblock(X: sps.csr_matrix, row_weights: torch.Tensor, gram_rw: bool, binary: bool,
                             n_rows: int, device: torch.device, *, mode: str, topk: int, **w_kwargs):
    """([n_cols, topk] values, [n_cols, topk] ids) of every column, built and
    ranked in slabs of target columns (JAX :600-640). The last slab is
    shifted left to end at the last column; its overlap with the one before
    is dropped. ``binary``: 0/1 data without row weights (JAX's ``bf16_ok``)."""
    n_cols = X.shape[1]
    idx_a, val_a, w_pad, ss2 = _padded_planes(X, row_weights, device)
    width, use_int8 = colblock_plan(idx_a.shape[0], n_cols, binary and not gram_rw, device)
    A8t = _dense_int8_t_from_padded(idx_a, val_a, n_cols, _STREAM_CHUNK) if use_int8 else None
    vals = torch.empty((n_cols, topk), dtype=torch.float32, device=device)
    ids = torch.empty((n_cols, topk), dtype=torch.int64, device=device)
    done = 0
    while done < n_cols:
        off = min(done, n_cols - width)
        if use_int8:
            G = _slab_gram_int8(A8t, off, width)
        else:
            G = _slab_gram_scatter(idx_a, val_a, w_pad, n_cols, off, width, _STREAM_CHUNK, gram_rw,
                                   binary and not gram_rw)
        W = _w_block(G, ss2, ss2[off : off + width], off, n_rows, row_weights, mode, **w_kwargs)
        del G
        v, i = tiled_topk(W.T, topk)  # [width, topk] for this slab's columns
        del W
        skip = done - off
        vals[done : off + width], ids[done : off + width] = v[skip:], i[skip:]
        done = off + width
    return vals, ids


def similarity_topk_sharded(A: torch.Tensor, row_weights: torch.Tensor, gram_rw: bool, n_rows: int, plan,
                            *, mode: str, topk: int, binary: bool = False, **w_kwargs):
    """([n_cols, topk] values, [n_cols, topk] ids) of every column, the
    columns split over the plan's model axis (JAX :391-470): this rank's
    target columns [off, off + width) of the zero-padded A (n_cols padded to
    a multiple of n_model) against every candidate, its [n_cols_pad, width]
    Gram block normalized by ``_w_block``, the padded candidates at -inf,
    each column's top ``topk`` (0 where fewer are finite), then gathered
    over ``model``. A: the whole dense [n_rows, n_cols] data; ``binary``
    (0/1, no row weights): the Gram block is one bf16 product with float32
    accumulation (JAX :435-437)."""
    from ganmf_tpu_torch.parallel import comm
    from ganmf_tpu_torch.parallel.mesh import MODEL_AXIS

    n_cols = A.shape[1]
    pad = (-n_cols) % plan.n_model
    if pad:
        A = torch.cat([A, A.new_zeros((A.shape[0], pad))], dim=1)
        if w_kwargs["use_row_weights"] and mode == "euclidean":
            # euclidean's weights index the candidate axis, padded here
            row_weights = torch.cat([row_weights, row_weights.new_zeros(A.shape[1] - row_weights.shape[0])])
    width = A.shape[1] // plan.n_model
    off = plan.coords[MODEL_AXIS] * width
    A_blk = A[:, off : off + width]
    if gram_rw:
        G = (row_weights[:, None] * A).T @ A_blk  # [n_cols_pad, width]
    elif binary:
        G = bf16_mm(A.to(torch.bfloat16).T, A_blk.to(torch.bfloat16))
    else:
        G = A.T @ A_blk
    W = _w_block(G, torch.sum(A * A, dim=0), torch.sum(A_blk * A_blk, dim=0), off, n_rows, row_weights, mode,
                 **w_kwargs)
    del G
    if pad:
        # padded candidates must rank below every real similarity, negative
        # ones too: -inf, not 0
        W[n_cols:] = float("-inf")
    vals, idx = tiled_topk(W.T, topk)  # [width, topk] for this rank's columns
    vals = torch.where(torch.isfinite(vals), vals, 0.0)
    return comm.all_gather(vals, plan, MODEL_AXIS)[:n_cols], comm.all_gather(idx, plan, MODEL_AXIS)[:n_cols]


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
    gram_rw = use_row_weights and mode != "euclidean"
    w_kwargs = dict(
        mode=mode, topk=topK, shrink=float(shrink), normalize=bool(normalize),
        asymmetric_alpha=float(asymmetric_alpha), tversky_alpha=float(tversky_alpha),
        tversky_beta=float(tversky_beta), normalize_avg_row=bool(normalize_avg_row),
        distance_mode=similarity_from_distance_mode, use_row_weights=use_row_weights,
    )
    # binary data (JAX's bf16_ok, :550-559) takes bf16 products on every
    # route, and may take the resident route or the colblock's int8 form
    binary = row_weights is None and bool(X.nnz == 0 or np.all(X.data == 1.0))
    # a plan with more than one model rank takes the sharded dense route, at
    # any size (JAX :577-580)
    route = build_route(n_rows, n_cols, mesh_plan)
    if route == "sharded":
        if export == "device":
            raise ValueError("export='device' materializes [I, I] on one device; use export='csr' with mesh_plan")
        vals, idx = similarity_topk_sharded(dense_from_sparse(X, device), rw, gram_rw, n_rows, mesh_plan,
                                            binary=binary, **w_kwargs)
        return csc_from_col_topk(vals, idx, n_cols).tocsr()
    if route == "colblock":
        if export == "device":
            raise ValueError("export='device' materializes [I, I] on one device; the column-blocked "
                             "build exists because that does not fit")
        vals, idx = similarity_topk_colblock(X, rw, gram_rw, binary, n_rows, device, **w_kwargs)
        return csc_from_col_topk(vals, idx, n_cols).tocsr()
    G, ss2, _ = build_gram(X, rw, gram_rw, device, binary)
    vals, idx = _similarity_topk_from_gram(G, ss2, rw, n_rows, **w_kwargs)
    del G
    if export == "device":
        return scatter_col_topk_dense(vals, idx)
    return csc_from_col_topk(vals, idx, n_cols).tocsr()
