"""CFGAN's work counted from its shapes: the GEMM FLOPs of an epoch, and the
bytes of the two kernels that draw its ZR masks. A share of a peak divides
them by a time measured on the card; the peaks are ``counters``'."""

from __future__ import annotations

from typing import Sequence

#: bytes a mask entry costs each kernel at the least: K2 reads a float32 key
#: and writes a bool; the keyed draw writes a float32 uniform
K2_BYTES_PER_ENTRY = 5
KEYED_BYTES_PER_ENTRY = 4


def _layers(dims: Sequence[int]) -> int:
    """Multiply-adds of one row through the MLP of widths ``dims``."""
    return sum(a * b for a, b in zip(dims, dims[1:]))


def cfgan_row_flops(g_dims: Sequence[int], d_dims: Sequence[int]) -> tuple:
    """GEMM FLOPs of one row of a D minibatch and of a G minibatch.

    D: G's forward (no gradient), D's forward on the real and on the fake
    pair, D's weight gradients for both, and the gradients of D's inputs
    past its first layer (its input takes none). G: G's forward, D's
    forward on the fake pair and the gradient of its every input back to the
    fake profile (D's weights take none), G's weight gradients and the
    gradients of G's inputs past its first layer.
    """
    fg, fd = 2 * _layers(g_dims), 2 * _layers(d_dims)
    first_g, first_d = 2 * g_dims[0] * g_dims[1], 2 * d_dims[0] * d_dims[1]
    d = fg + 2 * fd + 2 * fd + 2 * (fd - first_d)
    g = fg + fd + fd + fg + (fg - first_g)
    return d, g


def cfgan_epoch_flops(n_rows: int, g_dims: Sequence[int], d_dims: Sequence[int], d_steps: int = 1,
                      g_steps: int = 1) -> float:
    """An epoch's GEMM FLOPs over its valid rows (padding rows not counted)."""
    d, g = cfgan_row_flops(g_dims, d_dims)
    return float(n_rows * (d_steps * d + g_steps * g))


def mask_entries_per_epoch(n_rows: int, n_cols: int, g_batch: int, g_steps: int = 1) -> int:
    """The ZR mask's entries an epoch draws: one [g_batch, n_cols] block for
    each G minibatch, the padded last one whole."""
    return g_steps * -(-n_rows // g_batch) * g_batch * n_cols
