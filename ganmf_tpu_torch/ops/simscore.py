"""Scoring and masked top-k for the similarity family.

Port of ``masked_topk_matmul`` and ``split_bf16_planes``
(ganmf_tpu/ops/pallas_scorer.py:64-170). The JAX package keeps them plain XLA
on purpose (docstring :83-93: at a catalog-sized contraction the matmul is the
whole cost), so here they are library products, the seen mask and
``tiled_topk``. No kernel of this repo is launched.

The product takes one of two forms, as in JAX:

- float32 operands: one float32 ``torch.matmul`` with TF32 off (JAX's
  ``Precision.HIGHEST``);
- either operand a tuple of bfloat16 planes (``split_bf16_planes`` of a
  float32 matrix, whose other operand is bf16-exact): one bf16 product a plane
  pair, left planes outer and right planes inner, each accumulated and
  returned in float32, summed in float32 in that order (JAX :122-134). On the
  card each is ``torch.mm(a, b, out_dtype=torch.float32)``, the tensor cores'
  bf16 product with a float32 output; on the CPU the planes are upcast and
  multiplied in float32, where each product of two bf16 values is exact. A
  bf16 product never returns bf16: that would round every score to 8 bits.
"""

from __future__ import annotations

import torch

from ganmf_tpu_torch.ops.topk import tiled_topk


def split_bf16_planes(W: torch.Tensor, passes: int = 2):
    """``passes`` bfloat16 planes whose float32 sum approximates the float32
    W to about 8 x passes mantissa bits (JAX :157-170): each plane is the
    round-to-nearest-even bf16 of what the planes before it leave over."""
    planes = []
    r = W
    for _ in range(passes - 1):
        p = r.to(torch.bfloat16)
        planes.append(p)
        r = r - p.to(torch.float32)
    planes.append(r.to(torch.bfloat16))
    return tuple(planes)


def bf16_mm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """a @ b of two bfloat16 matrices, accumulated and returned in float32;
    with ``out`` (float32) the product is added to it. On the card one
    ``torch.mm``/``torch.addmm`` with ``out_dtype=torch.float32`` (cuBLAS on
    the tensor cores); on the CPU the float32 product of the upcast operands."""
    if a.is_cuda:
        if out is None:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.addmm(out, a, b, out_dtype=torch.float32, out=out)
    s = a.to(torch.float32) @ b.to(torch.float32)
    return s if out is None else out.add_(s)


def plane_product(rows, W) -> torch.Tensor:
    """rows @ W in float32 where either side is a tuple of bf16 planes (a
    single tensor on the other side is cast to bf16): the plane pairs'
    products summed in float32, left planes outer (JAX :122-134)."""
    rs = rows if isinstance(rows, tuple) else (rows.to(torch.bfloat16),)
    ws = W if isinstance(W, tuple) else (W.to(torch.bfloat16),)
    s = None
    for r in rs:
        for w in ws:
            t = bf16_mm(r, w)
            s = t if s is None else s + t
    return s


def masked_topk_matmul(
    rows,  # [B, C] left operand (profile rows, or user-user W rows), or its bf16 planes
    W,  # [C, I] right operand (item-item W, or the dense URM), or its bf16 planes
    seen_mask,  # [B, I] bool, True = exclude; None with mask_from_rows
    pair_ids: torch.Tensor,  # [B, P] test item ids per row (0-padded)
    k: int,
    mask_from_rows: bool = False,
    use_approx: bool = False,
):
    """``top_k(mask(rows @ W))`` plus a test-pair probe (JAX :64-154).
    Returns (values [B, k], ids [B, k], pair_scores [B, P], pair_finite
    [B, P]): each row's masked score at its test items (0 where masked) and
    whether that score was finite, for the evaluator's RMSE.

    ``mask_from_rows`` masks the entries where the left operand, a user's
    training profile, is nonzero: the item-based seen set, without a second
    scatter; the left operand is then one tensor, not planes. ``use_approx``
    (JAX's ``approx_max_k``, which the evaluator never sets) is not ported
    and raises."""
    if use_approx:
        raise NotImplementedError("use_approx (approx_max_k ranking) is not ported")
    if isinstance(rows, tuple) or isinstance(W, tuple):
        s = plane_product(rows, W)
    else:
        s = rows @ W
    if mask_from_rows:
        if isinstance(rows, tuple):
            raise ValueError("mask_from_rows needs the profile rows as the left operand, not planes")
        s = s.masked_fill(rows != 0, float("-inf"))
    if seen_mask is not None:
        s = s.masked_fill(seen_mask, float("-inf"))
    vals, idx = tiled_topk(s, k)
    ps = torch.gather(s, 1, pair_ids)
    fin = torch.isfinite(ps)
    return vals, idx, torch.where(fin, ps, 0.0), fin.float()
