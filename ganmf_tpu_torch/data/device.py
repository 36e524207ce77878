"""Device-resident dense and row-padded views of sparse interaction matrices.

Port of ganmf_tpu/data/device.py. The dense URM is built once on the device
from its COO triplets (O(nnz) host-to-device traffic) and rows are gathered
from it; the padded-CSR planes hold each row's column ids and values,
left-justified and padded with the sentinel column ``n_cols``, for matrices
whose dense form is too large and for the evaluator's test rows.

A similarity matrix too large to hold dense goes to the device as a torch
sparse CSR tensor (``sparse_csr_from_sparse``), multiplied there and read by
rows (``csr_rows_dense``).

The content-digest LRU of ``padded_csr_from_sparse`` is not ported yet.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sps
import torch


def dense_from_sparse(mat: sps.spmatrix, device: torch.device) -> torch.Tensor:
    """Densify on the device: ship only the COO triplets and scatter-add them
    into a zeros buffer."""
    R, C = mat.shape
    coo = mat.tocoo()
    coo.sum_duplicates()
    lin = coo.row.astype(np.int64) * C + coo.col.astype(np.int64)
    out = torch.zeros(R * C, dtype=torch.float32, device=device)
    out.scatter_add_(
        0,
        torch.from_numpy(lin).to(device),
        torch.from_numpy(coo.data.astype(np.float32)).to(device),
    )
    return out.view(R, C)


class DeviceURM:
    """Device-resident dense URM plus its cached boolean mask."""

    def __init__(self, urm: sps.spmatrix, device: torch.device):
        urm = urm.tocsr().astype(np.float32)
        urm.eliminate_zeros()
        self.dense = dense_from_sparse(urm, device)
        self._mask: Optional[torch.Tensor] = None

    @property
    def mask(self) -> torch.Tensor:
        """Boolean interaction mask (True where an interaction exists)."""
        if self._mask is None:
            self._mask = self.dense != 0
        return self._mask

    def rows(self, user_ids: torch.Tensor) -> torch.Tensor:
        """Gather dense profile rows on the device."""
        return self.dense.index_select(0, user_ids)


class PaddedCSR(NamedTuple):
    """Row-padded sparse matrix on the device: ``idx[r]`` holds row r's
    column ids padded with the ``n_cols`` sentinel, ``val[r]`` the values
    padded with 0. Memory is O(rows * max_row_nnz)."""

    idx: torch.Tensor  # [R, L] int64
    val: torch.Tensor  # [R, L] float32


def padded_csr_from_sparse(mat: sps.spmatrix, device: torch.device) -> PaddedCSR:
    """Build the padded planes with one scatter each on the device; the host
    computes only the O(nnz) slot of every stored entry."""
    csr = mat.tocsr().astype(np.float32)
    csr.eliminate_zeros()
    R, C = csr.shape
    lens = np.ediff1d(csr.indptr)
    L = max(int(lens.max()) if R else 0, 1)
    rows = np.repeat(np.arange(R, dtype=np.int64), lens)
    offs = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.indptr[:-1].astype(np.int64), lens)
    lin = torch.from_numpy(rows * L + offs).to(device)
    idx = torch.full((R * L,), C, dtype=torch.int64, device=device)
    idx.index_put_((lin,), torch.from_numpy(csr.indices.astype(np.int64)).to(device))
    val = torch.zeros(R * L, dtype=torch.float32, device=device)
    val.index_put_((lin,), torch.from_numpy(csr.data).to(device))
    return PaddedCSR(idx.view(R, L), val.view(R, L))


def dense_bf16_from_padded(idx: torch.Tensor, val: torch.Tensor, n_cols: int, chunk: int) -> torch.Tensor:
    """The padded-CSR rows as a dense bfloat16 [R, n_cols] matrix, built
    ``chunk`` rows at a time (ganmf_tpu/data/device.py:200-217): half the
    bytes of float32, and exact when every stored value is bf16-representable
    (binary data always is). R must be a multiple of ``chunk``."""
    R = idx.shape[0]
    out = torch.empty((R, n_cols), dtype=torch.bfloat16, device=idx.device)
    for lo in range(0, R, chunk):
        block = torch.zeros((chunk, n_cols + 1), dtype=torch.float32, device=idx.device)
        block.scatter_add_(1, idx[lo : lo + chunk], val[lo : lo + chunk].float())
        out[lo : lo + chunk] = block[:, :n_cols]
    return out


def padded_rows_dense(
    pc: PaddedCSR, uids: torch.Tensor, n_cols: int, max_len: int = None
) -> torch.Tensor:
    """Densify a batch of rows: gather the padded entries and scatter them
    into a [B, n_cols + 1] zeros block, then drop the sentinel column.

    ``max_len`` crops the gathered planes to their first ``max_len`` slots,
    exact whenever every selected row has at most ``max_len`` entries (the
    rows are left-justified; the tail is all sentinel)."""
    bi = pc.idx.index_select(0, uids)
    bv = pc.val.index_select(0, uids)
    if max_len is not None and max_len < bi.shape[1]:
        bi = bi[:, :max_len]
        bv = bv[:, :max_len]
    out = torch.zeros((bi.shape[0], n_cols + 1), dtype=bv.dtype, device=bv.device)
    out.scatter_add_(1, bi, bv)
    return out[:, :n_cols]


def padded_rows_mask(
    pc: PaddedCSR, uids: torch.Tensor, n_cols: int, max_len: int = None
) -> torch.Tensor:
    """Boolean seen-mask rows from the padded storage."""
    return padded_rows_dense(pc, uids, n_cols, max_len=max_len) != 0


def sparse_csr_from_sparse(mat: sps.spmatrix, device: torch.device) -> torch.Tensor:
    """A float32 torch sparse CSR tensor of ``mat`` on the device, exact
    zeros dropped (for ``torch.sparse.mm``)."""
    csr = sps.csr_matrix(mat, dtype=np.float32)
    csr.eliminate_zeros()
    csr.sort_indices()
    with warnings.catch_warnings():  # torch calls its sparse CSR layout beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype(np.int64)), torch.from_numpy(csr.indices.astype(np.int64)),
            torch.from_numpy(csr.data), size=csr.shape, check_invariants=False,
        ).to(device)


def csr_rows_dense(W: torch.Tensor, rows: torch.Tensor, n_cols: int) -> torch.Tensor:
    """[B, n_cols] dense copies of the given rows of the sparse CSR tensor
    W, gathered and scattered on the device (one host read: the rows' entry
    count)."""
    crow, col, val = W.crow_indices(), W.col_indices(), W.values()
    starts = crow.index_select(0, rows)
    lens = crow.index_select(0, rows + 1) - starts
    total = int(lens.sum())
    b = torch.repeat_interleave(torch.arange(len(rows), device=rows.device), lens, output_size=total)
    first = torch.cumsum(lens, 0) - lens
    pos = torch.arange(total, device=rows.device) - first[b] + starts[b]
    out = torch.zeros((len(rows), n_cols), dtype=val.dtype, device=val.device)
    out[b, col[pos]] = val[pos]  # a CSR row holds each column once
    return out
