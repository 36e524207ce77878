"""Multi-rank epochs of DisGANMF, CFGAN and CAAE.

The counterparts of the JAX package's mesh fits of the three models
(ganmf_tpu/models/disganmf.py:287-294, cfgan.py:324-332, caae.py:468-472),
where GSPMD inserts the collectives from the placements of
``parallel.distributed`` (``shard_disganmf_params``, ``shard_cfgan_params``,
``shard_caae_params``). Here each rank runs the one-card epoch's steps on its
shards and calls them itself, as ``distributed.sharded_ganmf_epoch`` does:

  * every rank knows the whole minibatch (the shared shuffle, or CFGAN's
    natural row order), and its rows split over the user axes
    (``ShardLayout.chunk``); a chunk's URM rows are gathered from the data
    ranks that own them;
  * the item-sized layers run Megatron style over model: a first layer is
    row-parallel (partial sums reduced over model), a last layer
    column-parallel ([b, I_m] outputs, their inputs' gradients reduced over
    model in backward); the hidden layers are replicated;
  * the loss sums are reduced over the axes their terms are split over and
    divided by the global denominators; the gradients are summed over the
    user axes (an L2 term's gradient enters on the first user rank only);
    each optimizer steps its own shard. Nothing reads the device to the host.

Where the model axis does not divide the items they stay whole on every rank
(JAX's degrade rule) and no item collective runs; with every axis of size 1
each step is the one-card step's arithmetic, so a 1 x 1 plan fits bitwise as
no plan.

The model-specific points:

  * DisGANMF: GANMF's MF generator (user rows gathered, fake profiles
    column-parallel). D's [I + 1, d] first kernel is replicated where the
    items divide (then the [b, I_m] profile is all-gathered over model, and
    its backward keeps this rank's columns of the gradient, which every
    model rank computes whole), else this rank holds JAX's row slice of
    concat(float(id), profile): the product runs over that slice of the whole
    input, the id term on the rank whose slice starts at row 0.
  * CFGAN: a row's negative mask needs the row's keys over every item and its
    whole interaction pattern, so each data rank builds its own rows' keys
    over all I columns, draws the masks through K2 (``negative_mask``) on
    [rows, I] and keeps its [rows, I_m] columns; the model ranks repeat the
    select, as GSPMD does around a custom call. Dense storage takes the keys
    from the epoch's whole [padded, I] draw, the same on every rank, and the
    rank's URM rows all-gathered over model, once an epoch; csr storage draws
    each minibatch's keys with ``keyed_uniforms`` for the minibatch rows the
    rank holds (and, on the rank holding the last rows, the padding rows past
    them), densified over every column from its padded-CSR rows. Either way a
    row's mask is the one-card mask, bitwise.
  * CAAE: G and G' are sharded autoencoders; their row softmaxes (the
    REINFORCE terms) reduce their max and sum over model. The row-wide steps
    work on whole rows, all-gathered over model: the epoch's G and G'
    reconstructions of every profile, gathered whole on every rank for
    ``gpr_prob_full`` and the bucketed CDF tables (as the one-card epoch,
    each rank holds 2 [U, I] float32 planes, ``gpr_prob_full`` and the
    pre-softmax activations, and 2 x (U x 64 + U x 64 x ceil(I / 64)) floats
    of tables: about 360 MB at ML-1M's 6040 x 3706), the G step's CDF
    sampling, and the Nu keys, drawn through K2 on [b, I]. The D phase's
    (U + I)(K + 1) table (1.6 MB at ML-1M) is gathered whole once an epoch
    and updated on every rank, then each rank keeps its shards. Under
    ``d_scatter="direct"``, whose ``index_add_`` is not bitwise repeatable
    on the card, the first rank's table is broadcast after the phase, so that
    every replica is bitwise the same; ``"dedup"`` is deterministic as it is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ganmf_tpu_torch.data.device import PaddedCSR, padded_rows_dense
from ganmf_tpu_torch.models import caae as pca
from ganmf_tpu_torch.models import cfgan as pcf
from ganmf_tpu_torch.models.disganmf import _discriminate
from ganmf_tpu_torch.models.gan_base import apply_grads
from ganmf_tpu_torch.models.ganmf import _l2 as _l2_f32
from ganmf_tpu_torch.parallel import comm
from ganmf_tpu_torch.parallel.distributed import (
    PAIRED, ShardLayout, _copy, _reduce, _user_sum, l2_value, param_kinds, sharded_generator_epoch)
from ganmf_tpu_torch.parallel.mesh import MODEL_AXIS
from ganmf_tpu_torch.utils.debug import debug_enabled, raise_on_nan


# -- pieces every epoch here uses --------------------------------------------------

class _GatherCols(torch.autograd.Function):
    """Forward: this rank's [b, I_m] columns all-gathered over ``axes`` into
    [b, I] (in float32, exact). Backward: this rank's columns of the
    gradient, which every member computes whole (the computation after the
    gather is replicated over ``axes``)."""

    @staticmethod
    def forward(ctx, x, plan, axes, i0, i1):
        ctx.cols = (i0, i1)
        return comm.all_gather(x.float(), plan, axes, tiled_axis=1).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        i0, i1 = ctx.cols
        return grad[:, i0:i1], None, None, None, None


def gather_cols(lay: ShardLayout, x: torch.Tensor) -> torch.Tensor:
    """[b, I] whole rows from this rank's [b, I_m] item columns (see
    ``_GatherCols``); the identity where the items are whole."""
    if not lay.item_axes:
        return x
    return _GatherCols.apply(x, lay.plan, lay.item_axes, lay.i0, lay.i1)


def owner_rows(lay: ShardLayout, planes, rows: torch.Tensor):
    """The ``rows`` (global ids, the same on every rank) of each of this
    rank's row-sharded ``planes`` ([rows_l, C] each), gathered from the data
    ranks that hold them in one collective; rows nobody holds are zeros."""
    local, held = lay._held(rows, lay.rows_primary)
    picked = torch.stack([torch.where(held[:, None], p.index_select(0, local).float(), 0.0) for p in planes])
    picked = comm.psum(picked, lay.plan, lay.user_axes)  # exact: one owner's value plus zeros
    return [x.to(p.dtype) for x, p in zip(picked, planes)]


def _chunk_sum(lay: ShardLayout, x: torch.Tensor, axes) -> torch.Tensor:
    """A partial sum reduced over ``axes`` (differentiable, float32)."""
    return comm.reduce_from(x, lay.plan, axes)


# -- DisGANMF ---------------------------------------------------------------------

def _dis_first_rows(lay: ShardLayout) -> Tuple[int, int]:
    """[lo, hi) of the rows of D's [I + 1, d] first kernel this rank holds."""
    (lo, hi), = lay.plan.bounds((lay.n_cols + 1,), lay.plan.item_rows)
    return lo, hi


def dis_discriminate(lay: ShardLayout, p, uids: torch.Tensor, x: torch.Tensor, act,
                     dtype: Optional[torch.dtype] = None):
    """(features, logits [b, 1]) of D over concat(float(uid), profile) for
    this rank's chunk: ``x`` is its [b, I_m] item columns (its [b, I] row
    where the items are whole), ``p`` its shards (models/disganmf.py
    ``_discriminate`` on the shards)."""
    x = gather_cols(lay, x)
    lo, hi = _dis_first_rows(lay)
    if hi - lo == lay.n_cols + 1:  # the kernel whole (replicated): the one-card D
        return _discriminate(p, uids, x, act, dtype)
    # JAX's row slice [lo, hi) of the kernel; the items are whole here
    ws, bs = list(p.d_ws), list(p.d_bs)
    out_w, out_b = p.out_w, p.out_b
    w0 = ws[0]
    if dtype is not None:
        ws, bs = [w.to(dtype).float() for w in ws], [b.to(dtype).float() for b in bs]
        out_w, out_b = out_w.to(dtype).float(), out_b.to(dtype).float()
    x = comm.copy_to(x.float(), lay.plan, MODEL_AXIS).to(x.dtype)
    c0 = max(lo, 1) - 1  # the profile columns of rows [max(lo, 1), hi)
    prof_w = (w0.to(dtype) if dtype is not None else w0)[max(lo, 1) - lo:]
    part = (x[:, c0 : hi - 1] @ prof_w).float()
    if lo == 0:
        part = part + uids[:, None].float() * ws[0][0:1, :]
    h = act(comm.reduce_from(part, lay.plan, MODEL_AXIS) + bs[0])
    for w, b in zip(ws[1:], bs[1:]):
        h = act(h @ w + b)
    return h, h @ out_w + out_b


def _bce_sum(logits: torch.Tensor, target: float, w: torch.Tensor) -> torch.Tensor:
    """The weighted sum of optax's sigmoid BCE (models/disganmf.py ``_bce``
    before its division)."""
    lg = logits[:, 0].float()
    per = -target * F.logsigmoid(lg) - (1.0 - target) * F.logsigmoid(-lg)
    return (per * w).sum()


def _bce_logits_sum(logits: torch.Tensor, target: float, w: torch.Tensor) -> torch.Tensor:
    """The weighted sum of models/cfgan.py ``_bce`` before its division."""
    lg = logits[:, 0].float()
    per = F.binary_cross_entropy_with_logits(lg, torch.full_like(lg, target), reduction="none")
    return (per * w).sum()


def dis_d_loss(lay: ShardLayout, p, uids, real, w, act, dtype=None) -> torch.Tensor:
    """D's data loss (no L2) on this rank's chunk, reduced over the mesh."""
    cs = lay.chunk(len(uids))
    uc, real_c, wc = uids[cs], real[cs], w[cs]
    if dtype is not None:
        real_c = real_c.to(dtype)
    with torch.no_grad():
        U = lay.gather_user_rows(p.user_emb, uids)[cs]
        g = [U, p.item_emb] if dtype is None else [U.to(dtype), p.item_emb.to(dtype)]
        fake_c = g[0] @ g[1].T
    sums = torch.stack([_bce_sum(dis_discriminate(lay, p, uc, real_c, act, dtype)[1], 1.0, wc),
                        _bce_sum(dis_discriminate(lay, p, uc, fake_c, act, dtype)[1], 0.0, wc)])
    # D's outputs are whole on every model rank: summed over the user axes only
    sums = _chunk_sum(lay, sums, lay.user_axes) / torch.clamp(w.sum(), min=1.0)
    return sums[0] + sums[1]


def dis_g_loss(lay: ShardLayout, p, uids, real, w, recon_coefficient: float, act, dtype=None) -> torch.Tensor:
    """G's data loss (no L2) through the frozen D, as ``dis_d_loss``."""
    cs = lay.chunk(len(uids))
    uc, real_c, wc = uids[cs], real[cs], w[cs]
    if dtype is not None:
        real_c = real_c.to(dtype)
    U = lay.gather_user_rows(p.user_emb, uids)[cs]
    g = [U, p.item_emb] if dtype is None else [U.to(dtype), p.item_emb.to(dtype)]
    fake_c = _copy(lay, g[0], lay.item_axes) @ g[1].T
    fake_feat, fake_out = dis_discriminate(lay, p, uc, fake_c, act, dtype)
    with torch.no_grad():
        real_feat, _ = dis_discriminate(lay, p, uc, real_c, act, dtype)
    sq = ((real_feat.float() - fake_feat.float()) ** 2 * wc[:, None]).sum()
    sums = _chunk_sum(lay, torch.stack([_bce_sum(fake_out, 0.0, wc), sq]), lay.user_axes)
    denom = torch.clamp(w.sum(), min=1.0)
    return sums[0] / denom + recon_coefficient * (sums[1] / (denom * fake_feat.shape[1]))


def sharded_disganmf_epoch(
    lay: ShardLayout, params, d_opt: torch.optim.Optimizer, item_opt: torch.optim.Optimizer,
    user_state, urm, perm: torch.Tensor, weights: torch.Tensor,
    *, g_lr: float, recon_coefficient: float, d_reg: float, g_reg: float,
    n_batches: int, batch_size: int, d_steps: int, g_steps: int, d_hidden_act: str,
    lazy_user_adam: bool = True, compute_dtype: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``disganmf_epoch`` (models/disganmf.py) on this rank's shards, in
    place, through ``distributed.sharded_generator_epoch``. Returns the
    global mean losses as device scalars, the same on every rank."""
    act = pcf.ACTIVATIONS[d_hidden_act]
    cd = torch.bfloat16 if compute_dtype == "bf16" else None
    user_emb = params.user_emb
    d_params, g_params = params.d_params(), params.g_params()
    kinds = param_kinds(params)

    def d_step(uids, real, w):
        loss = dis_d_loss(lay, params, uids, real, w, act, cd)
        graph = loss + d_reg * _l2_f32(d_params) if d_reg and lay.user_lead else loss
        grads = _user_sum(lay, torch.autograd.grad(graph, d_params))
        return loss.detach() + (d_reg * l2_value(lay, d_params, kinds[2:]) if d_reg else 0.0), grads

    def g_step(uids, real, w):
        # the user rows' L2 enters on every rank that holds them, the items'
        # on the first user rank only (their gradients are summed over the user axes)
        loss = dis_g_loss(lay, params, uids, real, w, recon_coefficient, act, cd)
        graph = loss + g_reg * _l2_f32(g_params if lay.user_lead else [user_emb]) if g_reg else loss
        g_user, g_item = torch.autograd.grad(graph, g_params)
        g_item, = _user_sum(lay, [g_item])
        return loss.detach() + (g_reg * l2_value(lay, g_params, kinds[:2]) if g_reg else 0.0), g_user, g_item

    return sharded_generator_epoch(
        lay, params, d_opt, item_opt, user_state, urm, perm, weights, d_step, g_step,
        g_lr=g_lr, n_batches=n_batches, batch_size=batch_size, d_steps=d_steps, g_steps=g_steps,
        lazy_user_adam=lazy_user_adam)


# -- CFGAN --------------------------------------------------------------------------

def mlp_shard(lay: ShardLayout, p, x: torch.Tensor, hidden_act: str, dtype=None, in_items: bool = True,
              out_items: bool = True, act_last: bool = False):
    """An MLP on its shards (``distributed._shard_mlp``'s placement): the
    first layer row-parallel over this rank's item columns ``x`` (``in_items``),
    the last column-parallel, giving this rank's [b, I_m] outputs
    (``out_items``), the rest replicated. The activation follows every layer
    but the last (every layer with ``act_last``), as models/cfgan.py ``_mlp``
    (and CAAE's sigmoid ``_autoencode``) run them."""
    act = pcf.ACTIVATIONS[hidden_act]
    n = len(p.ws)
    h = x
    for l, (w, b) in enumerate(zip(p.ws, p.bs)):
        if dtype is not None:
            w, b = w.to(dtype), b.to(dtype)
        if l == 0 and in_items and not (n == 1 and out_items):
            h = _reduce(lay, h @ w, lay.item_axes) + b
        elif l == n - 1 and out_items:
            if l == 0 and in_items:  # one layer, column-sharded: its input whole
                h = comm.all_gather(h.float(), lay.plan, lay.item_axes, tiled_axis=1).to(h.dtype)
            h = _copy(lay, h, lay.item_axes) @ w + b
        else:
            h = h @ w + b
        if l < n - 1 or act_last:
            h = act(h)
    return h


def cfgan_discriminate(lay: ShardLayout, D, cond: torch.Tensor, x: torch.Tensor, hidden_act: str, dtype=None):
    """D's logits [b, 1] over concat(cond, x) from this rank's item columns
    of both: its [2I, d] first kernel is ``PAIRED`` (this rank's cond and data
    rows: one row-parallel product), JAX's row slice of the whole input, or
    replicated."""
    spec0 = D.mesh_layout[0][0]
    act = pcf.ACTIVATIONS[hidden_act]
    n = len(D.ws)
    ws, bs = list(D.ws), list(D.bs)
    if dtype is not None:
        ws, bs = [w.to(dtype) for w in ws], [b.to(dtype) for b in bs]
    inp = torch.cat([cond, x], dim=1)
    w0 = ws[0]
    if spec0 == PAIRED:
        h = _reduce(lay, inp @ w0, lay.item_axes) + bs[0]
    elif w0.shape[0] == 2 * lay.n_cols:  # replicated (the degrade rule)
        h = inp @ w0 + bs[0]
    else:  # JAX's rows [lo, hi) of the kernel; the items are whole here
        (lo, hi), = lay.plan.bounds((2 * lay.n_cols,), lay.plan.item_rows)
        inp = comm.copy_to(inp.float(), lay.plan, MODEL_AXIS).to(inp.dtype)
        h = comm.reduce_from((inp[:, lo:hi] @ w0).float(), lay.plan, MODEL_AXIS).to(inp.dtype) + bs[0]
    for l in range(1, n):
        h = act(h)
        h = h @ ws[l] + bs[l]
    return h


class _DView:
    """D's shards with the placements of D's own parameters (the slice of
    the model's ``mesh_layout`` that D holds)."""

    def __init__(self, params):
        n_g = len(list(params.G.parameters()))
        specs, shapes, n_cols = params.mesh_layout
        self.ws, self.bs = params.D.ws, params.D.bs
        self.mesh_layout = (specs[n_g:], shapes[n_g:], n_cols)


def cfgan_d_loss(lay: ShardLayout, D, G, cond, tmask, w_c, w, d_act: str, g_act: str, dtype=None):
    """D's data loss (no L2) on this rank's chunk (``cond``, ``tmask`` its
    [b, I_m] item columns, ``w_c`` its weights, ``w`` the batch's)."""
    with torch.no_grad():
        fake = mlp_shard(lay, G, cond, g_act, dtype) * tmask
    sums = torch.stack([
        _bce_logits_sum(cfgan_discriminate(lay, D, cond, cond, d_act, dtype), 1.0, w_c),
        _bce_logits_sum(cfgan_discriminate(lay, D, cond, fake, d_act, dtype), 0.0, w_c)])
    sums = _chunk_sum(lay, sums, lay.user_axes) / torch.clamp(w.sum(), min=1.0)
    return sums[0] + sums[1]


def cfgan_g_loss(lay: ShardLayout, G, D, cond, tmask, zmask, w_c, w, d_act: str, g_act: str, dtype=None):
    """(BCE term, ZR term) of G's loss on this rank's chunk, each reduced."""
    fake_raw = mlp_shard(lay, G, cond, g_act, dtype)
    d_fake = cfgan_discriminate(lay, D, cond, fake_raw * tmask, d_act, dtype)
    sq = fake_raw.float() ** 2 * zmask.float()
    denom = torch.clamp(w.sum(), min=1.0)
    bce = _chunk_sum(lay, _bce_logits_sum(d_fake, 1.0, w_c), lay.user_axes) / denom
    zr = _chunk_sum(lay, (sq.sum(1) * w_c).sum(), lay.loss_axes) / denom
    return bce, zr


def rows_full(lay: ShardLayout, block: torch.Tensor) -> torch.Tensor:
    """Rows of this rank's [R, I_m] item columns, whole: [R, I]."""
    if not lay.item_axes:
        return block
    return comm.all_gather(block.float(), lay.plan, lay.item_axes, tiled_axis=1).to(block.dtype)


def _own_cols(lay: ShardLayout, block: torch.Tensor) -> torch.Tensor:
    return block[:, lay.i0 : lay.i1] if lay.item_axes else block


def sharded_cfgan_epoch(
    lay: ShardLayout, params, d_opt: torch.optim.Optimizer, g_opt: torch.optim.Optimizer,
    urm, uniforms, d_weights: torch.Tensor, g_weights: torch.Tensor,
    *, d_reg: float, g_reg: float, zr_ratio: float, zp_ratio: float, zr_coefficient: float,
    scheme: str, d_hidden_act: str, g_hidden_act: str,
    d_n_batches: int, d_batch: int, g_n_batches: int, g_batch: int, d_steps: int, g_steps: int,
    compute_dtype: str = "f32", n_rows: Optional[int] = None,
) -> None:
    """``cfgan_epoch`` (models/cfgan.py) on this rank's shards, in place.

    Dense storage: ``urm`` is this rank's [rows_l, I_m] block of the padded
    URM and ``uniforms`` the epoch's whole (ZR, PM) [padded, I] draws (the
    same on every rank). csr storage: ``urm`` is this rank's rows of the
    padded-CSR planes (every column), ``uniforms`` ``row_uniforms(stream,
    rows)`` and ``n_rows`` the training matrix's row count."""
    cd = torch.bfloat16 if compute_dtype == "bf16" else None
    G, D = params.G, _DView(params)
    d_params, g_params = list(params.D.parameters()), list(G.parameters())
    debug = debug_enabled()
    masked_zr, masked_pm = scheme in ("ZP", "ZR"), scheme in ("ZP", "PM")
    n_cols = lay.n_cols

    if isinstance(urm, PaddedCSR):
        def planes(lo, size, with_zr):
            # the batch rows this rank holds, densified over every column;
            # the rank holding the last rows also takes the padding rows past them
            a = min(max(lo, lay.r0), lo + size)
            b = lo + size if lay.r1 >= n_rows else min(lo + size, lay.r1)
            width = lay.i1 - lay.i0
            out = [torch.zeros((size, width), dtype=urm.val.dtype, device=urm.val.device) for _ in range(3)]
            if b > a and lay.rows_primary:
                n_real = max(0, min(b, n_rows) - a)
                cond = padded_rows_dense(urm, torch.arange(a - lay.r0, a - lay.r0 + n_real, device=urm.idx.device),
                                         n_cols)
                if n_real < b - a:
                    cond = F.pad(cond, (0, 0, 0, b - a - n_real))
                rows = torch.arange(a, b, device=urm.idx.device)
                zr = pm = None
                if with_zr and masked_zr:
                    zr = pcf.negative_mask(cond, uniforms(pcf.ZR_STREAM, rows), zr_ratio)
                if masked_pm:
                    pm = pcf.negative_mask(cond, uniforms(pcf.PM_STREAM, rows), zp_ratio)
                tmask = torch.clamp(cond + pm, 0.0, 1.0) if pm is not None else cond
                for plane, part in zip(out, (cond, tmask, zr)):
                    if part is not None:
                        plane[a - lo : b - lo] = _own_cols(lay, part)
            return comm.psum(torch.stack(out).float(), lay.plan, lay.user_axes).to(out[0].dtype)
    else:
        # the epoch's masks of this rank's rows: K2 over whole rows, then its columns
        whole = rows_full(lay, urm)
        u_zr, u_pm = uniforms
        zr_l = (_own_cols(lay, pcf.negative_mask(whole, u_zr[lay.r0 : lay.r1], zr_ratio)) if masked_zr
                else torch.zeros_like(urm))
        pm_l = (_own_cols(lay, pcf.negative_mask(whole, u_pm[lay.r0 : lay.r1], zp_ratio)) if masked_pm
                else torch.zeros_like(urm))
        train_l = torch.clamp(urm + pm_l, 0.0, 1.0) if masked_pm else urm
        del whole

        def planes(lo, size, with_zr):
            rows = torch.arange(lo, lo + size, device=urm.device)
            return owner_rows(lay, [urm, train_l, zr_l] if with_zr else [urm, train_l], rows)

    for step in range(d_steps * d_n_batches):
        b = (step % d_n_batches) * d_batch
        cs = lay.chunk(d_batch)
        cond, tmask = (t[cs] for t in planes(b, d_batch, False)[:2])
        w = d_weights[b : b + d_batch]
        loss = cfgan_d_loss(lay, D, G, cond, tmask, w[cs], w, d_hidden_act, g_hidden_act, cd)
        graph = loss + d_reg * pcf._l2(params.D) if lay.user_lead else loss
        apply_grads(d_opt, d_params, _user_sum(lay, torch.autograd.grad(graph, d_params)))
        if debug:
            raise_on_nan(f"CFGAN D step {step}", loss=loss, **dict(params.D.named_parameters()))

    for step in range(g_steps * g_n_batches):
        b = (step % g_n_batches) * g_batch
        cs = lay.chunk(g_batch)
        cond, tmask, zmask = (t[cs] for t in planes(b, g_batch, True))
        w = g_weights[b : b + g_batch]
        bce, zr = cfgan_g_loss(lay, G, D, cond, tmask, zmask, w[cs], w, d_hidden_act, g_hidden_act, cd)
        if lay.user_lead:
            loss = bce + g_reg * pcf._l2(G) + zr_coefficient * zr
        else:
            loss = bce + zr_coefficient * zr
        apply_grads(g_opt, g_params, _user_sum(lay, torch.autograd.grad(loss, g_params)))
        if debug:
            raise_on_nan(f"CFGAN G step {step}", loss=loss, **dict(G.named_parameters()))

    d_opt.zero_grad(set_to_none=True)
    g_opt.zero_grad(set_to_none=True)


# -- CAAE ---------------------------------------------------------------------------

def _reinforce_shard(lay: ShardLayout, recon: torch.Tensor, fake_items: torch.Tensor, reward: torch.Tensor,
                     n_total: int) -> torch.Tensor:
    """models/caae.py ``_reinforce`` on this rank's [b, I_m] logits: the
    softmax's max and sum reduced over model, each sampled item's term from
    the rank that holds it; the mean over the whole batch's ``n_total``
    terms."""
    if lay.item_axes:
        mx = comm.pmax(recon.detach().max(dim=1, keepdim=True).values, lay.plan, lay.item_axes)
        e = torch.exp(recon - mx)
        s = comm.reduce_from(e.sum(dim=1, keepdim=True), lay.plan, lay.item_axes)
        local = fake_items - lay.i0
        own = (local >= 0) & (local < lay.i1 - lay.i0)
        num = torch.where(own, e.gather(1, local.clamp(0, lay.i1 - lay.i0 - 1)), 0.0)
        prob = comm.reduce_from(num, lay.plan, lay.item_axes) / s
    else:
        prob = torch.softmax(recon, dim=1).gather(1, fake_items)
    terms = torch.log(torch.clamp(prob, min=1e-20)) * reward
    if lay.plan.n_user_shards == 1:
        return -terms.mean()
    return -comm.reduce_from(terms.sum(), lay.plan, lay.user_axes) / n_total


def _broadcast_first(lay: ShardLayout, x: torch.Tensor) -> None:
    """``x`` replaced in place by the copy of the mesh's first rank."""
    group = lay.plan.group(lay.plan.axis_names)
    if group is not None:
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)


def sharded_caae_epoch(
    lay: ShardLayout, params, urm: torch.Tensor, n_nonint: torch.Tensor, inter_users: torch.Tensor,
    inter_items: torch.Tensor, inter_weight: torch.Tensor, draws: "pca.CAAEDraws",
    *, lr: float, beta: float, lmbda: float, S: float, d_bsize: int, n_d_chunks: int,
    d_steps: int, g_steps: int, gpr_steps: int, m_batch: int, n_samples: int,
    d_scatter: str = "direct",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``caae_epoch`` (models/caae.py) on this rank's shards, in place.
    ``urm`` is this rank's [rows_l, I_m] URM block, ``n_nonint`` every user's
    count of non-interactions, the rest whole and the same on every rank.
    Returns the mean D, G and G' losses as device scalars."""
    plan = lay.plan
    n_users, n_items = lay.n_rows, lay.n_cols
    dev = urm.device
    G, Gpr = params.G, params.Gpr
    kinds = param_kinds(params, ("d_user_emb",))
    n_g = len(list(G.parameters()))
    g_kinds, gpr_kinds = kinds[3 : 3 + n_g], kinds[3 + n_g :]

    users = inter_users.index_select(0, draws.perm)
    pos_items = inter_items.index_select(0, draws.perm)
    weights = inter_weight.index_select(0, draws.perm)

    with torch.no_grad():
        def whole_prob(p):
            return torch.softmax(plan.gather(mlp_shard(lay, p, urm, "sigmoid", act_last=True), plan.urm,
                                             (n_users, n_items)), dim=1)

        gpr_prob_full = whole_prob(Gpr)
        g_tables = pca.bucketed_cdf_tables(whole_prob(G))
        gpr_tables = pca.bucketed_cdf_tables(gpr_prob_full)
        # D's stores, whole on every rank for the phase
        d_user = plan.gather(params.d_user_emb.detach(), plan.user_rows, (n_users, params.d_user_emb.shape[1]))
        d_item = plan.gather(params.d_item_emb.detach(), plan.item_rows, (n_items, params.d_item_emb.shape[1]))
        d_bias = plan.gather(params.d_item_bias.detach(), plan.named(MODEL_AXIS), (n_items,))

    tab, d_sum, n_steps = pca.d_phase(d_user, d_item, d_bias, users, pos_items, weights, g_tables, gpr_tables,
                                      draws, lr=lr, beta=beta, d_bsize=d_bsize, n_d_chunks=n_d_chunks,
                                      d_steps=d_steps, d_scatter=d_scatter)
    K = d_user.shape[1]
    with torch.no_grad():
        if d_scatter == "direct":
            _broadcast_first(lay, tab)
        user_tab, item_tab, bias_tab = tab[:n_users, :K], tab[n_users:, :K], tab[n_users:, K]
        params.d_user_emb.copy_(user_tab[lay.r0 : lay.r1])
        (m0, m1), = plan.bounds((n_items,), plan.item_rows)
        params.d_item_emb.copy_(item_tab[m0:m1])
        params.d_item_bias.copy_(bias_tab[m0:m1])

    def reward_logits(uids, items):
        return torch.einsum("mk,mnk->mn", user_tab.index_select(0, uids), item_tab[items]) + bias_tab[items]

    k_all = pca.nu_sizes(n_nonint, S)
    cs = lay.chunk(m_batch)
    b = cs.stop - cs.start
    sample_rows = torch.arange(b * n_samples, device=dev) // n_samples
    draw_span = slice(cs.start * n_samples, cs.stop * n_samples)
    n_terms = m_batch * n_samples

    def sampled(p, profiles, u):
        with torch.no_grad():
            recon = rows_full(lay, mlp_shard(lay, p, profiles, "sigmoid", act_last=True))
            cdf = torch.cumsum(torch.softmax(recon, dim=1), dim=1)
            return pca.cdf_sample(cdf, sample_rows, u[draw_span], n_items).reshape(b, n_samples)

    # ---- G phase ----
    g_params = list(G.parameters())
    g_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for step in range(g_steps):
        uids = draws.g_users[step]
        uc = uids[cs]
        profiles = lay.batch_rows(urm, uids)[cs]
        whole = rows_full(lay, profiles)
        seen = whole != 0
        gumbel = -torch.log(-torch.log(draws.g_gumbel[step][cs] + 1e-20))
        p_gpr = gpr_prob_full.index_select(0, uc)
        keys = torch.where(seen, float("-inf"), torch.log(torch.clamp(p_gpr, min=1e-30)) + gumbel)
        nu = pca.smallest_k_mask(-keys, k_all.index_select(0, uc)) & ~seen
        e_mask = torch.clamp(profiles + _own_cols(lay, nu).to(profiles.dtype), 0.0, 1.0)
        fake_items = sampled(G, profiles, draws.g_sample[step])
        with torch.no_grad():
            reward = F.logsigmoid(reward_logits(uc, fake_items) - 1.0)
        recon = mlp_shard(lay, G, profiles, "sigmoid", act_last=True)
        ae_loss = _chunk_sum(lay, (((recon - profiles) * e_mask) ** 2).sum(), lay.loss_axes)
        data = lmbda * _reinforce_shard(lay, recon, fake_items, reward, n_terms) + (1.0 - lmbda) * ae_loss
        loss = data + beta * pcf._l2(G) if lay.user_lead else data
        pca._sgd_(g_params, _user_sum(lay, torch.autograd.grad(loss, g_params)), lr)
        if debug_enabled():
            raise_on_nan(f"CAAE G step {step}", loss=loss, **dict(G.named_parameters()))
        g_sum += data.detach() + beta * l2_value(lay, g_params, g_kinds)

    # ---- G' phase ----
    gpr_params = list(Gpr.parameters())
    gpr_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for step in range(gpr_steps):
        uids = draws.gpr_users[step]
        uc = uids[cs]
        profiles = lay.batch_rows(urm, uids)[cs]
        recon = mlp_shard(lay, Gpr, profiles, "sigmoid", act_last=True)
        fake_items = sampled(Gpr, profiles, draws.gpr_sample[step])
        with torch.no_grad():
            reward = F.logsigmoid(1.0 - reward_logits(uc, fake_items))
        data = _reinforce_shard(lay, recon, fake_items, reward, n_terms)
        loss = data + beta * pcf._l2(Gpr) if lay.user_lead else data
        pca._sgd_(gpr_params, _user_sum(lay, torch.autograd.grad(loss, gpr_params)), lr)
        if debug_enabled():
            raise_on_nan(f"CAAE G' step {step}", loss=loss, **dict(Gpr.named_parameters()))
        gpr_sum += data.detach() + beta * l2_value(lay, gpr_params, gpr_kinds)

    return d_sum / max(1, 2 * n_steps), g_sum / max(1, g_steps), gpr_sum / max(1, gpr_steps)
