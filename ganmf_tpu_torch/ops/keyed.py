"""Keyed per-row uniforms: the draw behind CFGAN's csr storage.

The JAX package draws each row's mask keys as
``jax.random.uniform(jax.random.fold_in(base, row), (I,))``
(ganmf_tpu/models/cfgan.py:156-159): a pure function of the epoch's key and
the row id, so the D and G phases, whose batch grids differ, see the same
mask for a row within an epoch. The port defines its own counter-based draw
with that property:

    u(seed, epoch, stream, r, c) = word (c mod 4) of
        Philox4x32-10(counter = (c div 4, r, epoch, stream),
                      key = (seed mod 2^32, seed div 2^32 mod 2^32))
    mapped to (x >> 8) * 2^-24, a float32 in [0, 1).

It gives other numbers than JAX's threefry, of the same distribution; the
tests pass JAX's uniforms to CFGAN's csr epoch (its ``row_uniforms`` argument)
where they compare the two packages draw for draw.

``keyed_uniforms_cuda`` launches a hand-written kernel (csrc/keyed.cu); the
plain version, ``keyed_uniforms_reference``, repeats Philox's 32-bit
arithmetic in int64 tensors and is bitwise equal to it. This is not a TPU
kernel (JAX draws with XLA): fusing the draw into K2, so that the [B, I] keys
are never written, is later work.
"""

from __future__ import annotations

import torch

from ganmf_tpu_torch.ops._build import check, load_library, on_device, stream_handle
from ganmf_tpu_torch.utils.profiling import count

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32's multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # its key increments (Weyl sequence)
_MASK = 0xFFFFFFFF


def key_halves(seed: int):
    """The Philox key (two 32-bit words) of a seed."""
    seed = int(seed)
    return seed & _MASK, (seed >> 32) & _MASK


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of m * x for x in [0, 2^32), in int64 without
    overflow: x is split in 16-bit halves, so each partial product is below
    2^48."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    lo = ((b & 0xFFFF) << 16) + a
    return ((b >> 16) + (lo >> 32)) & _MASK, lo & _MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32 with 10 rounds (Salmon et al., SC'11; Random123's
    philox4x32_R(10, ...)) on int64 tensors holding 32-bit words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def check_keyed_args(rows: torch.Tensor, n_cols: int) -> None:
    if rows.dim() != 1 or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rows must be a 1-d int32 or int64 tensor, got {rows.dtype} {tuple(rows.shape)}")
    if n_cols < 0:
        raise ValueError(f"n_cols must be >= 0, got {n_cols}")


def keyed_uniforms_reference(seed: int, epoch: int, stream: int, rows: torch.Tensor,
                             n_cols: int) -> torch.Tensor:
    """The plain version: [len(rows), n_cols] float32 uniforms, on the rows'
    device."""
    check_keyed_args(rows, n_cols)
    k0, k1 = key_halves(seed)
    n_quads = -(-n_cols // 4)
    shape = (rows.shape[0], n_quads)
    dev = rows.device
    c0 = torch.arange(n_quads, dtype=torch.int64, device=dev)[None, :].expand(shape)
    c1 = (rows.to(torch.int64) & _MASK)[:, None].expand(shape)
    c2 = torch.full(shape, int(epoch) & _MASK, dtype=torch.int64, device=dev)
    c3 = torch.full(shape, int(stream) & _MASK, dtype=torch.int64, device=dev)
    words = torch.stack(philox4x32_10(c0, c1, c2, c3, k0, k1), dim=2).reshape(shape[0], 4 * n_quads)
    return (words[:, :n_cols] >> 8).to(torch.float32) * (2.0**-24)


def keyed_uniforms_cuda(seed: int, epoch: int, stream: int, rows: torch.Tensor,
                        n_cols: int) -> torch.Tensor:
    """Launch the kernel on a CUDA ``rows`` (int32 or int64). Raises on
    anything else, and when the launch fails."""
    check_keyed_args(rows, n_cols)
    if rows.device.type != "cuda":
        raise ValueError(f"keyed_uniforms_cuda takes a CUDA tensor, not {rows.device}")
    out = torch.empty((rows.shape[0], n_cols), dtype=torch.float32, device=rows.device)
    if out.numel() == 0:
        return out
    rows = rows.to(torch.int64).contiguous()
    k0, k1 = key_halves(seed)
    lib = load_library()
    with on_device(rows.device):
        code = lib.ganmf_keyed_uniforms(rows.data_ptr(), rows.shape[0], n_cols, k0, k1,
                                        int(epoch) & _MASK, int(stream) & _MASK, out.data_ptr(),
                                        stream_handle(rows.device))
    check(lib, code, "keyed_uniforms launch")
    count("keyed.launches")
    return out


def keyed_uniforms(seed: int, epoch: int, stream: int, rows: torch.Tensor, n_cols: int) -> torch.Tensor:
    """[len(rows), n_cols] float32 uniforms in [0, 1), a pure function of
    (seed, epoch, stream, row id, column). On a CUDA ``rows`` it launches the
    kernel; on a CPU one it takes the plain version."""
    if rows.device.type == "cpu":
        return keyed_uniforms_reference(seed, epoch, stream, rows, n_cols)
    return keyed_uniforms_cuda(seed, epoch, stream, rows, n_cols)
