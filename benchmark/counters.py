"""Work counted from shapes, and the chip's published peaks.

The FLOPs and bytes of a unit of work (a GANMF epoch, a full evaluation, a
``recommend`` call, a K1 launch) are worked out here from the sizes of the
configuration alone, never read from the program. A share of a peak divides
them by a time measured on the card.
"""

from __future__ import annotations

import math

#: Published dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
#: data sheet): float32 outside the tensor cores, and HBM3 bytes/s.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def ganmf_pair_flops(rows: int, n_cols: int, num_factors: int, emb_dim: int,
                     d_steps: int = 1, g_steps: int = 1) -> float:
    """GEMM FLOPs of GANMF's D and G phases over ``rows`` profile rows.

    A D minibatch of B rows: the fake profiles U_b V^T (2BKI, no gradient),
    the autoencoder over the real and the fake profiles (2 x 4BIE forward)
    and its weight gradients (2 x 6BIE): 20BIE + 2BKI. A G minibatch: the
    fake profiles (2BKI), their autoencoder pass (4BIE), the real codes
    (2BIE), the gradient back to the fake profiles (4BIE) and to both
    embedding tables (4BKI): 10BIE + 6BKI.
    """
    B, I, K, E = rows, n_cols, num_factors, emb_dim
    d = 20 * B * I * E + 2 * B * K * I
    g = 10 * B * I * E + 6 * B * K * I
    return float(d_steps * d + g_steps * g)


def ganmf_epoch_flops(n_rows: int, n_cols: int, fit: dict) -> float:
    """An epoch's GEMM FLOPs over its valid rows (padding rows not counted)."""
    return ganmf_pair_flops(n_rows, n_cols, fit["num_factors"], fit["emb_dim"],
                            fit.get("d_steps", 1), fit.get("g_steps", 1))


def scoring_flops(users: int, n_items: int, num_factors: int) -> float:
    """The score product U_b V^T of ``users`` rows."""
    return 2.0 * users * n_items * num_factors


def k1_bound_s(B: int, I: int, K: int, k: int) -> float:
    """K1's least time for one launch: its FMAs at the float32 peak, or U,
    V and the mask read once and the lists (float32 values, int64 ids)
    written once at the HBM rate, whichever is longer."""
    ops = 2.0 * B * I * K / F32_FLOPS
    nbytes = 4.0 * (B + I) * K + 1.0 * B * I + 12.0 * B * k
    return max(ops, nbytes / HBM_BYTES_PER_S)


def k1_blocks(n_users: int, block_rows: int):
    """The row counts of the blocks that split ``n_users`` into blocks of at
    most ``block_rows``."""
    n = int(math.ceil(n_users / block_rows)) if n_users else 0
    return [min(block_rows, n_users - i * block_rows) for i in range(n)]
