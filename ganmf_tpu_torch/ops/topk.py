"""Plain top-k with the reference's tie order, and exact-k row selection.

``lax.top_k`` and ``tiled_topk`` (ganmf_tpu/ops/topk.py:25-44) give ties to
the lowest index, and the ranked lists depend on that. ``torch.topk``
promises no tie order, so the plain paths rank with a stable descending sort.
``tiled_topk`` ranks catalog-wide rows (the similarity family's [I, I]
matrices) the same way, with the sort's footprint bounded: tiles of a row
are ranked apart and their candidates merged, and rows go in passes of at
most ``TOPK_PASS_KEYS`` keys. ``scatter_col_topk_dense`` (:47-59) writes a
column-pruned W back into a dense matrix on the device.

``smallest_k_mask`` (ganmf_tpu/ops/topk.py:62-104) selects each row's k[r]
smallest keys, ties to the lowest column: CFGAN's negative-mask draws run it
over the whole training matrix every epoch.
"""

from __future__ import annotations

import torch

from ganmf_tpu_torch.ops.select import check_select_args, smallest_k_mask_cuda


_SIGNED_BITS = {torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF), torch.float32: (torch.int32, 0x7FFFFFFF),
                torch.bfloat16: (torch.int16, 0x7FFF), torch.float16: (torch.int16, 0x7FFF)}


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """A signed-integer image of floating ``x`` that orders as XLA's sorts
    and ``lax.top_k`` order floats: the IEEE total order, where -0.0 lies
    below +0.0 (a float comparison ties them)."""
    itype, low = _SIGNED_BITS[x.dtype]
    bits = x.view(itype)
    return torch.where(bits < 0, bits ^ low, bits)


def topk_lowest_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, in
    ``lax.top_k``'s order: floats by the total order (+0.0 above -0.0),
    ties to the lowest index; indices are int64."""
    if x.dtype not in _SIGNED_BITS:
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :k].contiguous(), idx[..., :k].contiguous()
    idx = torch.sort(total_order_key(x), dim=-1, descending=True, stable=True).indices[..., :k].contiguous()
    return torch.gather(x, -1, idx), idx


def merge_shard_topk(vals: torch.Tensor, ids: torch.Tensor, k: int, plan):
    """Each row's k best of the model ranks' candidates: this rank's
    (vals [B, k'], global ids [B, k']) gathered over the model axis, in shard
    order, and ranked again by ``topk_lowest_index``. Candidates ordered by
    shard and then by rank put equal values in global id order, so ties go
    to the lowest id, as ``lax.top_k`` over the whole row gives them
    (ganmf_tpu/ops/topk.py:121-127). Every model rank gets the same lists;
    a collective over the model axis."""
    from ganmf_tpu_torch.parallel import comm

    v_all = comm.all_gather(vals, plan, "model", tiled_axis=1)
    i_all = comm.all_gather(ids, plan, "model", tiled_axis=1)
    top, pos = topk_lowest_index(v_all, k)
    return top, torch.gather(i_all, 1, pos)


def sharded_topk(scores: torch.Tensor, k: int, plan, batch_axes=None):
    """Exact top-k of item-sharded scores with a candidate all-gather merge
    (ganmf_tpu/ops/topk.py:107-136). ``scores`` is this rank's [b, I / n_model]
    block, items [m * I / n_model, (m + 1) * I / n_model) for model
    coordinate m, and its rows this rank's rows of the block (the user axes
    a JAX layout names in ``batch_axes``: None or ``plan.user_axes``, the
    rows split over them or whole). Returns (values [b, k], global ids
    [b, k]), the same on every model rank; exact whenever k <= I / n_model."""
    if batch_axes not in (None, plan.user_axes):
        raise ValueError(f"batch_axes is None or {plan.user_axes!r}, not {batch_axes!r}")
    if k > scores.shape[1]:
        raise ValueError(f"k = {k} exceeds the shard's {scores.shape[1]} items")
    v, i = topk_lowest_index(scores, k)
    from ganmf_tpu_torch.parallel.mesh import MODEL_AXIS

    return merge_shard_topk(v, i + plan.axis_index(MODEL_AXIS) * scores.shape[1], k, plan)


#: Keys that one pass of ``tiled_topk`` ranks at most: its values, int64 ids
#: and the sort's scratch take about 16 bytes a key (1 GiB here).
TOPK_PASS_KEYS = 1 << 26


def tiled_topk(w: torch.Tensor, k: int, tile: int = 2048):
    """(values, int64 ids) of each row's k largest entries, ties to the lowest
    index and -inf last: ``lax.top_k``'s result, computed as JAX's
    ``tiled_topk`` does (ganmf_tpu/ops/topk.py:25-44). A row is cut into
    ``tile``-wide tiles (the last padded with -inf), each tile's first
    min(k, tile) entries are taken by a stable sort, and the T * min(k, tile)
    candidates, laid out tile by tile, are ranked again by a stable sort, so
    equal values keep their global index order. Rows go in passes of at most
    ``TOPK_PASS_KEYS`` keys: no pass sorts a whole [I, I] matrix."""
    r, n = w.shape
    rows = max(1, TOPK_PASS_KEYS // max(n, 1))
    if r > rows:
        parts = [tiled_topk(w[lo : lo + rows], k, tile) for lo in range(0, r, rows)]
        return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])
    if n <= tile:
        return topk_lowest_index(w, k)
    kk = min(k, tile)
    pad = (-n) % tile
    if pad:
        w = torch.nn.functional.pad(w, (0, pad), value=float("-inf"))
    T = (n + pad) // tile
    v, i = topk_lowest_index(w.reshape(r, T, tile), kk)  # [r, T, kk]
    i = i + (torch.arange(T, device=w.device) * tile)[None, :, None]
    vv, pos = topk_lowest_index(v.reshape(r, T * kk), k)
    return vv, torch.gather(i.reshape(r, T * kk), 1, pos)


def scatter_col_topk_dense(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dense [n, n] W from per-column top-k candidates: W[idx[j, t], j] =
    vals[j, t], zeros elsewhere (ganmf_tpu/ops/topk.py:47-59). A column's ids
    are distinct, so no entry is written twice."""
    n = vals.shape[0]
    cols = torch.arange(n, device=idx.device)[:, None].expand_as(idx)
    W = torch.zeros((n, n), dtype=vals.dtype, device=vals.device)
    W[idx, cols] = vals
    return W


def monotone_key_image(keys: torch.Tensor) -> torch.Tensor:
    """int64 image of float32 keys that orders as the JAX package's monotone
    uint32 map of the key bits (ganmf_tpu/ops/topk.py:88-89): +inf above every
    finite key, -0.0 below +0.0. Comparing the floats would tie the zeros."""
    bits = keys.contiguous().view(torch.int32).to(torch.int64)
    unsigned = bits & 0xFFFFFFFF
    return torch.where(bits < 0, 0xFFFFFFFF - unsigned, unsigned | 0x80000000)


def smallest_k_mask_reference(keys: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The plain version: the stable rank table ``rank(image) < k[r]``, where
    the rank is taken by a stable sort of the monotone image."""
    order = torch.sort(monotone_key_image(keys), dim=1, stable=True).indices
    cols = torch.arange(keys.shape[1], device=keys.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(1, order, cols)
    return rank < k.to(torch.int64)[:, None]


def smallest_k_mask(keys: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Bool mask of each row's ``k[r]`` smallest keys, ties to the lowest
    column; rows with k = 0 are all false. keys [R, I] float32, k [R] int32
    or int64. On CUDA tensors it launches K2 (ops/select.py) at every width;
    on CPU tensors it takes the plain version."""
    if keys.device.type == "cpu":
        check_select_args(keys, k)
        return smallest_k_mask_reference(keys, k)
    return smallest_k_mask_cuda(keys, k)
