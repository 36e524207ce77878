"""Distributed dense Cholesky and triangular solves over the mesh's model axis.

Port of ganmf_tpu/ops/distchol.py. Every model rank owns a contiguous [n, W]
column block of a symmetric positive-definite matrix (W = n / n_model), and
panels of width ``w`` are factored one at a time, right-looking: the owner
sends its fully updated panel to the others (an owner-masked psum over
``model``, ``_broadcast_panel``), every rank factors the w x w diagonal block
itself, solves the panel against it and updates only its own trailing
columns with the rank-w product. The forward and backward block
substitutions use the same panel broadcast, so no rank holds more than its
[n, W] block and one [n, w] panel. ``ease_r_topk_sharded`` is EASE-R on
that factorization: the Gram columns, the factor, the inverse's columns and
B's weights all stay column-sharded, and each rank ranks its own columns.

The w x w blocks go through ``torch.linalg.cholesky`` and
``torch.linalg.solve_triangular``; the products are float32 with TF32 off
(utils/device.py), as JAX's ``Precision.HIGHEST``. JAX's fori_loops run here
as Python loops over the panels, the same number on every rank of a model
group, so that their collectives line up. The data ranks of a plan repeat
the work (JAX replicates A over them).
"""

from __future__ import annotations

import numpy as np
import torch

from ganmf_tpu_torch.parallel import comm
from ganmf_tpu_torch.parallel.mesh import MODEL_AXIS, MeshPlan


def _broadcast_panel(Ml: torch.Tensor, p: int, *, w: int, ppl: int, plan: MeshPlan) -> torch.Tensor:
    """Panel p ([n, w] columns of the distributed matrix) from its owner to
    every rank of the model group: the owner's columns, zeros elsewhere,
    summed over ``model`` (JAX :32-41)."""
    me = plan.coords[MODEL_AXIS]
    loc = (p % ppl) * w
    panel = Ml[:, loc : loc + w] if me == p // ppl else torch.zeros_like(Ml[:, :w])
    return comm.psum(panel.contiguous(), plan, MODEL_AXIS)


def _cholesky_local(Gl: torch.Tensor, *, w: int, plan: MeshPlan) -> torch.Tensor:
    """Right-looking blocked Cholesky of the column-distributed symmetric
    matrix (JAX :44-80). Gl: this rank's [n, W] columns (full symmetric
    storage). Returns this rank's columns of the lower factor L."""
    n, W = Gl.shape
    ppl = W // w
    me = plan.coords[MODEL_AXIS]
    rows = torch.arange(n, device=Gl.device)[:, None]
    colg = me * W + torch.arange(W, device=Gl.device)[None, :]  # this rank's global column ids
    Gl = Gl.clone()
    for p in range(n // w):
        pw = p * w
        panel = _broadcast_panel(Gl, p, w=w, ppl=ppl, plan=plan)  # [n, w]
        Lpp = torch.linalg.cholesky(panel[pw : pw + w])
        # X = panel @ inv(Lpp)^T; only the rows strictly below the block are L
        X = torch.linalg.solve_triangular(Lpp, panel.T, upper=False).T
        Lbelow = torch.where(rows >= pw + w, X, 0.0)  # [n, w]
        # the trailing symmetric rank-w update of this rank's columns >= pw + w
        Lb_cols = torch.where(colg.T >= pw + w, Lbelow[me * W : (me + 1) * W], 0.0)
        Gl -= Lbelow @ Lb_cols.T
        if me == p // ppl:
            # the owner writes the factored panel (the block and below) back
            loc = (p % ppl) * w
            Lbelow[pw : pw + w] = Lpp
            Gl[:, loc : loc + w] = Lbelow
    return torch.where(rows < colg, 0.0, Gl)  # the upper triangle zeroed


def _solve_lower_local(Ll: torch.Tensor, R: torch.Tensor, *, w: int, plan: MeshPlan) -> torch.Tensor:
    """Forward block substitution L Y = R, L column-distributed and R this
    rank's own right-hand side [n, W_r] (JAX :83-104). Returns its Y."""
    n = Ll.shape[0]
    ppl = Ll.shape[1] // w
    rows = torch.arange(n, device=Ll.device)[:, None]
    Y = R.clone()
    for p in range(n // w):
        pw = p * w
        panel = _broadcast_panel(Ll, p, w=w, ppl=ppl, plan=plan)
        Yp = torch.linalg.solve_triangular(panel[pw : pw + w], Y[pw : pw + w], upper=False)
        Y[pw : pw + w] = Yp
        Y -= torch.where(rows >= pw + w, panel, 0.0) @ Yp
    return Y


def _solve_upper_local(Ll: torch.Tensor, Y: torch.Tensor, *, w: int, plan: MeshPlan) -> torch.Tensor:
    """Backward block substitution L^T X = Y, left-looking: each panel takes
    the contributions of the trailing blocks already solved (JAX
    :107-130)."""
    n = Ll.shape[0]
    P = n // w
    ppl = Ll.shape[1] // w
    rows = torch.arange(n, device=Ll.device)[:, None]
    X = torch.zeros_like(Y)
    for p in range(P - 1, -1, -1):
        pw = p * w
        panel = _broadcast_panel(Ll, p, w=w, ppl=ppl, plan=plan)
        Lbelow = torch.where(rows >= pw + w, panel, 0.0)  # [n, w]
        Yp_eff = Y[pw : pw + w] - Lbelow.T @ X  # X is zero outside the solved blocks
        X[pw : pw + w] = torch.linalg.solve_triangular(panel[pw : pw + w].T, Yp_eff, upper=True)
    return X


def _ease_local(A: torch.Tensor, l2_norm: float, *, k: int, w: int, n_real: int, plan: MeshPlan):
    """This rank's EASE-R (JAX :133-162): its Gram columns, the distributed
    Cholesky, the solve against its unit columns, B's weights and each of
    its columns' top k. A: the whole [U, n_pad] URM. Returns ([W, k] values,
    [W, k] row ids)."""
    from ganmf_tpu_torch.ops.topk import tiled_topk

    me = plan.coords[MODEL_AXIS]
    n = A.shape[1]
    W = n // plan.n_model
    dev = A.device
    colg = me * W + torch.arange(W, device=dev)  # this rank's global target columns
    unit = torch.arange(n, device=dev)[:, None] == colg[None, :]
    Gl = A.T @ A[:, me * W : (me + 1) * W]
    # the ridge on the whole padded diagonal: the padded rows and columns
    # become an independent lambda I block, which factors on its own and
    # never couples into the real columns' inverse
    Gl = Gl + l2_norm * unit.to(Gl.dtype)
    Ll = _cholesky_local(Gl, w=w, plan=plan)
    Y = _solve_lower_local(Ll, unit.to(Gl.dtype), w=w, plan=plan)
    Pcols = _solve_upper_local(Ll, Y, w=w, plan=plan)  # [n, W] columns of G^-1
    diag = Pcols[colg, torch.arange(W, device=dev)]
    B = -Pcols / diag[None, :]
    B = torch.where(unit, 0.0, B)
    B = torch.where(torch.arange(n, device=dev)[:, None] < n_real, B, 0.0)  # the padded rows out
    vals, idx = tiled_topk(torch.where(B == 0.0, float("-inf"), B).T, k)  # stored-nonzero semantics
    return torch.where(torch.isfinite(vals), vals, 0.0), idx


def ease_r_topk_sharded(A: torch.Tensor, l2_norm: float, k: int, plan: MeshPlan, panel: int = 256):
    """EASE-R with its top-K export, column-sharded over the plan's model
    axis (JAX :165-193): no [I, I] buffer is whole on any rank. The item
    axis is padded to a multiple of n_model * w, w = max(8, min(panel,
    ceil(n / n_model))), so that every rank holds whole panels. A: the whole
    [U, n] URM, the same on every rank. Returns ([n, k] values, [n, k] row
    ids), each column's k largest nonzero weights (0 in empty slots), the
    same on every rank (gathered over ``model``)."""
    n = A.shape[1]
    S = plan.n_model
    w = max(8, min(panel, -(-n // S)))
    n_pad = -(-n // (S * w)) * (S * w)
    if n_pad > n:
        A = torch.cat([A, A.new_zeros((A.shape[0], n_pad - n))], dim=1)
    vals, idx = _ease_local(A, float(np.float32(l2_norm)), k=k, w=w, n_real=n, plan=plan)
    return comm.all_gather(vals, plan, MODEL_AXIS)[:n], comm.all_gather(idx, plan, MODEL_AXIS)[:n]
