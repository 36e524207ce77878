"""Multi-rank training: the sharded parameters of GANMF, DisGANMF, CFGAN and
CAAE, GANMF's step and epoch, and the epoch loop GANMF and DisGANMF share
(the other models' epochs are in ``parallel.adversarial``).

Port of ganmf_tpu/parallel/distributed.py. GANMF's placement is the JAX file's:

  * URM             [U, I] -> (data, model)
  * user embeddings [U, K] -> (data, -)      \\  generator
  * item embeddings [I, K] -> (model, -)     /
  * encoder kernel  [I, E] -> (model, -)     \\  discriminator
  * decoder kernel  [E, I] -> (-, model)     /
  * decoder bias    [I]    -> (model)
  * encoder bias    [E]    -> replicated

(data is (slice, data) on a 3-axis mesh). JAX inserts the collectives from
these shardings; here each rank runs the same program on its shards and
calls them itself:

  * every rank knows the whole minibatch (the shared host shuffle), and its
    rows are split over the user axes: each user rank takes one contiguous
    chunk of them;
  * a chunk's URM rows and user embeddings are gathered from the data ranks
    that own them (each owner contributes its rows, an all_reduce over the
    user axes; its backward sends each row's gradient to its owner);
  * the items are split Megatron-style over model: the encoder is a
    row-parallel product (partial [B, E] sums reduced over model), the
    decoder and the fake profiles are column-parallel (their inputs'
    gradients reduced over model in backward);
  * the loss sums are reduced over every axis the summed terms are split
    over (the feature-matching term, whole on each model rank, over the
    user axes only) and divided by the global denominators, sum(w) over the
    whole batch times the whole catalog's I (or E);
  * the shards' gradients are summed over the user axes (an L2 term's
    gradient enters once), and every optimizer steps its own shard
    (elementwise, so the sharded update is the unsharded one).

An item count that the model axis does not divide keeps the items whole on
every model rank (JAX's degrade rule): the model ranks then repeat each
other's work and no item collective runs. Nothing here reads the device to
the host: the losses stay device scalars.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
import torch.distributed as dist
from torch import nn

from ganmf_tpu_torch.data.device import PaddedCSR
from ganmf_tpu_torch.models.gan_base import ADAM_BETAS, ADAM_EPS, apply_grads
from ganmf_tpu_torch.models.ganmf import GANMFParams, _l2, init_params, tf1_adam_
from ganmf_tpu_torch.parallel import comm
from ganmf_tpu_torch.parallel.mesh import MODEL_AXIS, MeshPlan, _names
from ganmf_tpu_torch.utils.debug import debug_enabled, raise_on_nan


def shard_ganmf_params(params: GANMFParams, plan: MeshPlan) -> GANMFParams:
    """This rank's shards of full GANMF parameters (made the same on every
    rank), on the plan's device, in JAX's placement (the table at the top)."""
    specs = [plan.user_rows, plan.item_rows, plan.item_rows, plan.replicated, plan.item_cols,
             plan.named(MODEL_AXIS)]
    return _shard_module(params, specs, plan, params.item_emb.shape[0])


def shard_padded_csr(pc: PaddedCSR, plan: MeshPlan) -> PaddedCSR:
    """This rank's rows of padded-CSR storage: both [R, L] planes shard over
    the user axes (every column kept), so a rank holds O(nnz / n_user_shards)."""
    return PaddedCSR(idx=plan.put(pc.idx, plan.user_rows), val=plan.put(pc.val, plan.user_rows))


# -- the other adversarial trainers' placements -----------------------------------
#
# JAX's rules (ganmf_tpu/parallel/distributed.py:68-126), one placement for
# each tensor in ``parameters()`` order. Two of them split a kernel by its
# rows, which in JAX's layout do not line up with the item shards: CFGAN D's
# [2I, d] first kernel split in n_model pieces gives the first rank the
# ``cond`` rows of every item, and DisGANMF D's [I + 1, d] is offset by the id
# row. The port holds them so:
#
#   * CFGAN D's first kernel, where the items divide over the model axis, in
#     the aligned form ``PAIRED``: this rank's cond rows [i0, i1) then its
#     data rows [I + i0, I + i1), as many rows as JAX's share, so that the
#     row-parallel product takes this rank's item columns of both inputs and
#     needs no input gather. Where the items do not divide, JAX's rows as
#     ``put`` places them (a row slice of the whole input, or replicated);
#   * DisGANMF D's first kernel by JAX's rule as it is: where the items
#     divide over a model axis of 2 or more, I + 1 does not, and the kernel
#     is replicated (LastFM's 17,633 rows); the rank then all-gathers the
#     [b, I_m] profile over model. Where I + 1 divides, the items do not and
#     the rank holds JAX's row slice of the whole input.
#
# ``gather_*`` and the checkpoints give JAX's full layouts.

#: CFGAN D's first kernel in the aligned form (see above)
PAIRED = "paired"


def _put(plan: MeshPlan, t: torch.Tensor, spec, n_cols: int) -> torch.Tensor:
    if spec == PAIRED:
        (i0, i1), = plan.bounds((n_cols,), plan.item_rows)
        return torch.cat([t[i0:i1], t[n_cols + i0 : n_cols + i1]]).contiguous().to(plan.device)
    return plan.put(t, spec)


def _gather(plan: MeshPlan, t: torch.Tensor, spec, shape, n_cols: int) -> torch.Tensor:
    if spec == PAIRED:
        n = plan.n_model if n_cols % plan.n_model == 0 else 1
        parts = comm.all_gather(t.contiguous(), plan, MODEL_AXIS if n > 1 else ())  # c0 d0 c1 d1 ...
        return parts.reshape(n, 2, n_cols // n, *t.shape[1:]).transpose(0, 1).reshape(shape)
    return plan.gather(t.contiguous(), spec, shape)


def _mlp_specs(plan: MeshPlan, n_layers: int, in_items: bool, out_items: bool):
    """The placements of an MLP's weights then biases (JAX ``_shard_mlp``)."""
    ws = []
    for i in range(n_layers):
        if i == 0 and in_items and not (i == n_layers - 1 and out_items):
            ws.append(plan.item_rows)
        elif i == n_layers - 1 and out_items:
            ws.append(plan.item_cols)
        else:
            ws.append(plan.replicated)
    bs = [plan.named(MODEL_AXIS) if (i == n_layers - 1 and out_items) else plan.replicated
          for i in range(n_layers)]
    return ws + bs


def _shard_module(full: nn.Module, specs, plan: MeshPlan, n_cols: int) -> nn.Module:
    """A copy of ``full`` whose every parameter is this rank's shard of it, on
    the plan's device; it keeps its placements, global shapes and item count
    in ``mesh_layout`` for the gathers."""
    out = copy.deepcopy(full).cpu()
    shapes = []
    with torch.no_grad():
        for p, spec in zip(out.parameters(), specs):
            shapes.append(tuple(p.shape))
            p.data = _put(plan, p.data, spec, n_cols)
    out.mesh_layout = (tuple(specs), tuple(shapes), n_cols)
    return out


def _shard_mlp(p, plan: MeshPlan, in_items: bool, out_items: bool, n_cols: int):
    """This rank's shards of an MLP whose first kernel takes an item-wide
    input (``in_items``) and/or whose last layer gives an item-wide output
    (``out_items``); hidden layers replicated (JAX ``_shard_mlp``)."""
    return _shard_module(p, _mlp_specs(plan, len(p.ws), in_items, out_items), plan, n_cols)


def shard_disganmf_params(params, plan: MeshPlan):
    """DisGANMFParams placement: user embeddings over the user axes, item
    embeddings and D's [I + 1, d] first kernel over model (the kernel under
    the degrade rule), the hidden kernels, the biases and the output layer
    replicated."""
    n_layers = len(params.d_ws)
    specs = ([plan.user_rows, plan.item_rows, plan.item_rows] + [plan.replicated] * (n_layers - 1)
             + [plan.replicated] * n_layers + [plan.replicated] * 2)
    return _shard_module(params, specs, plan, params.item_emb.shape[0])


def shard_cfgan_params(params, plan: MeshPlan):
    """CFGANParams placement: G maps items to items (its first kernel
    row-sharded, its last kernel and bias column-sharded over model); D's
    [2I, d] first kernel row-sharded (``PAIRED`` where the items divide),
    every other layer replicated."""
    n_cols = params.G.bs[-1].shape[0]
    d_specs = _mlp_specs(plan, len(params.D.ws), True, False)
    if n_cols % plan.n_model == 0:
        d_specs[0] = PAIRED
    return _shard_module(params, _mlp_specs(plan, len(params.G.ws), True, True) + d_specs, plan, n_cols)


def shard_caae_params(params, plan: MeshPlan):
    """CAAEParams placement: D's user factors over the user axes, its item
    factors and item bias over model, G and G' sharded at their input and
    output layers."""
    n_layers = len(params.G.ws)
    mlp = _mlp_specs(plan, n_layers, True, True)
    specs = [plan.user_rows, plan.item_rows, plan.named(MODEL_AXIS)] + mlp + mlp
    return _shard_module(params, specs, plan, params.d_item_emb.shape[0])


def gather_module(sharded: nn.Module, plan: MeshPlan) -> nn.Module:
    """The full parameters of a ``_shard_module`` copy, in JAX's layouts, on
    every rank (a collective)."""
    specs, shapes, n_cols = sharded.mesh_layout
    out = copy.deepcopy(sharded)
    del out.mesh_layout
    with torch.no_grad():
        for p, spec, shape in zip(out.parameters(), specs, shapes):
            p.data = _gather(plan, p.data, spec, shape, n_cols)
    return out


def map_module_state(state, sharded: nn.Module, fn, optimizers=(), moments=()):
    """A training state with ``fn(tensor, spec, shape, n_cols)`` applied to
    the parameters' state dict (``state["params"]``), to the Adam moments of
    each ``(key, index of its first parameter)`` in ``optimizers`` (the
    optimizer over the parameters from that index on), and to the "m" and
    "v" of each ``(key, parameter index)`` in ``moments`` (TF1 Adam's state);
    the rest as it is."""
    specs, shapes, n_cols = sharded.mesh_layout
    out = dict(state)
    out["params"] = {k: fn(v, s, sh, n_cols) for (k, v), s, sh in zip(state["params"].items(), specs, shapes)}
    for key, first in optimizers:
        sd = state[key]
        out[key] = {"param_groups": sd["param_groups"], "state": {
            i: {k: fn(v, specs[first + int(i)], shapes[first + int(i)], n_cols)
                if k in ("exp_avg", "exp_avg_sq") else v for k, v in st.items()}
            for i, st in sd["state"].items()}}
    for key, j in moments:
        out[key] = {k: fn(v, specs[j], shapes[j], n_cols) if k in ("m", "v") else v for k, v in state[key].items()}
    return out


def gather_module_state(state, sharded: nn.Module, plan: MeshPlan, optimizers=(), moments=()):
    """A sharded training state with every tensor full (a collective): the
    state a one-card fit holds."""
    with torch.no_grad():
        return map_module_state(state, sharded, lambda t, s, sh, n: _gather(plan, t, s, sh, n), optimizers,
                                moments)


def shard_module_state(state, sharded: nn.Module, plan: MeshPlan, optimizers=(), moments=()):
    """This rank's shards of a full training state (any plan's checkpoint,
    or a one-card fit's)."""
    return map_module_state(state, sharded, lambda t, s, sh, n: _put(plan, t, s, n), optimizers, moments)


def init_distributed(seed: int, n_users: int, n_items: int, num_factors: int, emb_dim: int,
                     plan: MeshPlan):
    """Sharded GANMF parameters and the Adam optimizers of D and G over
    them, ``(params, d_opt, g_opt)``: the full tensors are drawn from
    ``seed`` on the host, the same on every rank, and each rank keeps its
    shards."""
    full = init_params(n_users, n_items, num_factors, emb_dim, torch.Generator().manual_seed(seed),
                       torch.device("cpu"))
    params = shard_ganmf_params(full, plan)
    d_opt = torch.optim.Adam(params.d_params(), lr=1.0, betas=ADAM_BETAS, eps=ADAM_EPS)
    g_opt = torch.optim.Adam(params.g_params(), lr=1.0, betas=ADAM_BETAS, eps=ADAM_EPS)
    return params, d_opt, g_opt


# -- where a rank's work lies ------------------------------------------------------

class ShardLayout:
    """This rank's part of a GANMF training step: its rows of the user
    dimension, its item columns, its chunk of each minibatch, and the axes
    each sum runs over."""

    def __init__(self, plan: MeshPlan, n_rows: int, n_cols: int):
        self.plan, self.n_rows, self.n_cols = plan, n_rows, n_cols
        (self.r0, self.r1), = plan.bounds((n_rows,), plan.user_rows)
        (self.i0, self.i1), = plan.bounds((n_cols,), plan.item_rows)
        # only one rank of a set holding the same rows contributes them to a sum
        self.rows_primary = plan.is_primary((n_rows,), plan.user_rows)
        self.user_axes = _names(plan.user_axes)
        self.item_axes = (MODEL_AXIS,) if self.i1 - self.i0 < n_cols else ()
        self.loss_axes = self.user_axes + self.item_axes
        self.user_lead = plan.axis_index(self.user_axes) == 0

    def chunk(self, B: int) -> slice:
        """This user rank's rows of a B-row minibatch."""
        q = -(-B // self.plan.n_user_shards)
        lo = min(self.plan.axis_index(self.user_axes) * q, B)
        return slice(lo, min(lo + q, B))

    def _held(self, uids: torch.Tensor, primary: bool):
        """(local row of each id, clamped; whether this rank holds it)."""
        local = (uids - self.r0).clamp(0, self.r1 - self.r0 - 1)
        held = (uids >= self.r0) & (uids < self.r1)
        return local, held & primary

    def batch_rows(self, urm, uids: torch.Tensor) -> torch.Tensor:
        """[B, I_m] URM rows of the whole batch, in this rank's item columns,
        gathered from their owners (no gradient)."""
        local, held = self._held(uids, self.rows_primary)
        if isinstance(urm, PaddedCSR):
            rows = _padded_shard_rows(urm, local, self.i0, self.i1)
        else:
            rows = urm.index_select(0, local)
        rows = torch.where(held[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        # exact: each entry is one owner's value plus zeros; summed in float32
        return comm.psum(rows.float(), self.plan, self.user_axes).to(rows.dtype)

    def gather_user_rows(self, user_emb: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
        """[B, K] user embeddings of the whole batch, differentiable: the
        backward sends each row's gradient to every rank that holds it."""
        group = self.plan.group(self.user_axes)
        local, held = self._held(uids, self.rows_primary)
        _, holds = self._held(uids, True)
        if group is None:
            return user_emb.index_select(0, local)
        return _GatherRows.apply(user_emb, local, held, holds, group)


def _padded_shard_rows(pc: PaddedCSR, rows: torch.Tensor, i0: int, i1: int) -> torch.Tensor:
    """[B, i1 - i0] dense rows of padded-CSR planes, columns [i0, i1) only."""
    width = i1 - i0
    col = pc.idx.index_select(0, rows) - i0
    col = torch.where((col >= 0) & (col < width), col, width)
    out = torch.zeros((len(rows), width + 1), dtype=pc.val.dtype, device=pc.val.device)
    out.scatter_add_(1, col, pc.val.index_select(0, rows))
    return out[:, :width]


class _GatherRows(torch.autograd.Function):
    """Forward: the rows ``local`` of ``user_emb`` where ``held``, zeros
    elsewhere, summed over ``group`` (each row from its one contributing
    owner). Backward: the gradient summed over ``group`` and added into the
    rows each rank holds (``holds``; replicas of a row each take it)."""

    @staticmethod
    def forward(ctx, user_emb, local, held, holds, group):
        ctx.save_for_backward(local, holds)
        ctx.group, ctx.shape = group, user_emb.shape
        rows = torch.where(held[:, None], user_emb.index_select(0, local), 0.0)
        dist.all_reduce(rows, group=group)
        return rows

    @staticmethod
    def backward(ctx, grad):
        local, holds = ctx.saved_tensors
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        out.index_add_(0, local, torch.where(holds[:, None], grad, 0.0))
        return out, None, None, None, None


# -- the losses of one minibatch on the shards ---------------------------------------

def _cast(tensors, dtype):
    return tensors if dtype is None else [t.to(dtype) for t in tensors]


def _reduce(lay: ShardLayout, x, axes):
    """``comm.reduce_from`` summed in float32, back in ``x``'s dtype."""
    return comm.reduce_from(x.float(), lay.plan, axes).to(x.dtype)


def _copy(lay: ShardLayout, x, axes):
    """``comm.copy_to`` with its backward summed in float32."""
    return comm.copy_to(x.float(), lay.plan, axes).to(x.dtype)


def _encode(lay: ShardLayout, d, x):
    """Row-parallel encoder: partial [b, E] sums over this rank's items."""
    return _reduce(lay, x @ d[0], lay.item_axes) + d[1]


def _decode(lay: ShardLayout, d, enc):
    """Column-parallel decoder: this rank's [b, I_m] columns."""
    return _copy(lay, enc, lay.item_axes) @ d[2] + d[3]


def _sq_sum(a, b, w):
    return ((a.float() - b.float()) ** 2 * w[:, None]).sum()


def param_kinds(module, user_names=("user_emb",)):
    """Each parameter's kind for ``l2_value``: "user" for the named user
    tables, "item" for a tensor split over model (its shard smaller than its
    global shape), else "rep"."""
    shapes = module.mesh_layout[1]
    names = [n for n, _ in module.named_parameters()]
    return [("user" if n in user_names else "item" if tuple(p.shape) != sh else "rep")
            for n, p, sh in zip(names, module.parameters(), shapes)]


def l2_value(lay: ShardLayout, tensors, kinds) -> torch.Tensor:
    """The L2 term, sum(t^2) / 2 over each global tensor, from the shards (no
    gradient): per ``kinds``, user rows summed over the user axes (once per
    row), item-split tensors over model, replicated tensors counted once."""
    total = 0.0
    for t, kind in zip(tensors, kinds):
        s = (t.detach().float() ** 2).sum() / 2.0
        if kind == "user":
            s = comm.psum(s if lay.rows_primary else torch.zeros_like(s), lay.plan, lay.user_axes)
        elif kind == "item":
            s = comm.psum(s, lay.plan, MODEL_AXIS)
        total = total + s
    return total


def shard_d_loss(lay: ShardLayout, p: GANMFParams, uids, real, w, m: float, dtype=None):
    """D's data loss (without L2) on this rank's minibatch chunk, reduced
    over the mesh: the same value on every rank, its gradient this rank's
    part of the global one."""
    cs = lay.chunk(len(uids))
    d = _cast(p.d_params(), dtype)
    real_c, wc = real[cs], w[cs]
    with torch.no_grad():
        U = lay.gather_user_rows(p.user_emb, uids)[cs]
        g = _cast([U, p.item_emb], dtype)
        fake_c = g[0] @ g[1].T
    sums = torch.stack([_sq_sum(real_c, _decode(lay, d, _encode(lay, d, real_c)), wc),
                        _sq_sum(fake_c, _decode(lay, d, _encode(lay, d, fake_c)), wc)])
    real_recon, fake_recon = comm.reduce_from(sums, lay.plan, lay.loss_axes) / (
        torch.clamp(w.sum(), min=1.0) * lay.n_cols)
    return real_recon + torch.clamp(m * real_recon - fake_recon, min=0.0)


def shard_g_loss(lay: ShardLayout, p: GANMFParams, uids, real, w, recon_coefficient: float, dtype=None):
    """G's data loss (without L2) through the frozen D, as ``shard_d_loss``."""
    cs = lay.chunk(len(uids))
    d = _cast(p.d_params(), dtype)
    real_c, wc = real[cs], w[cs]
    U = lay.gather_user_rows(p.user_emb, uids)[cs]
    g = _cast([U, p.item_emb], dtype)
    fake_c = _copy(lay, g[0], lay.item_axes) @ g[1].T
    fake_enc = _encode(lay, d, fake_c)
    fake_dec = _decode(lay, d, fake_enc)
    with torch.no_grad():
        real_enc = _encode(lay, d, real_c)
    denom = torch.clamp(w.sum(), min=1.0)
    recon = comm.reduce_from(_sq_sum(fake_c, fake_dec, wc), lay.plan, lay.loss_axes) / (denom * lay.n_cols)
    # the codes are whole on every model rank: summed over the user axes only
    feat = comm.reduce_from(_sq_sum(real_enc, fake_enc, wc), lay.plan, lay.user_axes) / (
        denom * fake_enc.shape[1])
    return (1.0 - recon_coefficient) * recon + recon_coefficient * feat


def _user_sum(lay: ShardLayout, grads):
    """The data-parallel sum of shard gradients over the user axes, in one
    collective."""
    return comm.psum_many(grads, lay.plan, lay.user_axes)


def d_grads(lay: ShardLayout, p: GANMFParams, uids, real, w, m, d_reg, dtype=None):
    """(D's loss with L2, the gradients of this rank's D shards). The L2
    term's gradient enters on the first user rank only, so that the sum over
    the user axes counts it once."""
    d_params = p.d_params()
    loss = shard_d_loss(lay, p, uids, real, w, m, dtype)
    graph = loss + d_reg * _l2(d_params) if d_reg and lay.user_lead else loss
    grads = _user_sum(lay, torch.autograd.grad(graph, d_params))
    if d_reg:
        loss = loss.detach() + d_reg * l2_value(lay, d_params, param_kinds(p)[2:])
    return loss.detach(), grads


def g_grads(lay: ShardLayout, p: GANMFParams, uids, real, w, recon_coefficient, g_reg, dtype=None):
    """(G's loss with L2, the gradients of this rank's user and item shards):
    the user rows' gradients are whole from the gather's backward (their L2
    term enters on every rank that holds them), the items' are summed over
    the user axes (their L2 term enters on the first user rank only)."""
    loss = shard_g_loss(lay, p, uids, real, w, recon_coefficient, dtype)
    graph = loss
    if g_reg:
        graph = loss + g_reg * _l2(p.g_params() if lay.user_lead else [p.user_emb])
    g_user, g_item = torch.autograd.grad(graph, p.g_params())
    g_item, = _user_sum(lay, [g_item])
    if g_reg:
        loss = loss.detach() + g_reg * l2_value(lay, p.g_params(), param_kinds(p)[:2])
    return loss.detach(), g_user, g_item


# -- the epoch and the step --------------------------------------------------------

def sharded_generator_epoch(
    lay: ShardLayout, params, d_opt: torch.optim.Optimizer, item_opt: torch.optim.Optimizer,
    user_state, urm, perm: torch.Tensor, weights: torch.Tensor, d_step, g_step,
    *, g_lr: float, n_batches: int, batch_size: int, d_steps: int, g_steps: int, lazy_user_adam: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mf_generator_epoch`` (models/ganmf.py) on this rank's shards, in
    place: GANMF's and DisGANMF's, which differ only in their losses.
    ``d_step(uids, real, w)`` gives (D's loss with L2, the gradients of this
    rank's D shards), ``g_step(...)`` (G's loss with L2, the user rows'
    gradients, the item shard's summed over the user axes); the loop runs
    ``d_steps * n_batches`` D minibatches, then ``g_steps * n_batches`` G
    minibatches over the epoch's permutation ``perm`` and ``weights`` (the
    whole batch, the same on every rank). ``urm`` is this rank's URM shard,
    dense [rows_l, I_m] or its rows' padded-CSR planes; the optimizers and
    ``user_state`` hold this rank's shards. Returns the global mean losses
    as device scalars, the same on every rank."""
    debug = debug_enabled()
    user_emb, item_emb = params.g_params()
    d_params = params.d_params()
    names = {id(p): n for n, p in params.named_parameters()}

    def batch(step):
        lo = (step % n_batches) * batch_size
        uids, w = perm[lo : lo + batch_size], weights[lo : lo + batch_size]
        return uids, lay.batch_rows(urm, uids), w

    d_sum = torch.zeros((), dtype=torch.float32, device=perm.device)
    for step in range(d_steps * n_batches):
        loss, grads = d_step(*batch(step))
        apply_grads(d_opt, d_params, grads)
        if debug:
            raise_on_nan(f"D step {step}", loss=loss, **{names[id(p)]: p for p in d_params})
        d_sum += loss

    g_sum = torch.zeros((), dtype=torch.float32, device=perm.device)
    for step in range(g_steps * n_batches):
        uids, real, w = batch(step)
        loss, g_user, g_item = g_step(uids, real, w)
        row_mask = None
        if lazy_user_adam:
            full = torch.zeros(lay.n_rows, dtype=torch.float32, device=w.device)
            full.scatter_reduce_(0, uids, w, reduce="amax")
            row_mask = full[lay.r0 : lay.r1]
        tf1_adam_(user_emb, g_user, user_state, g_lr, row_mask)
        apply_grads(item_opt, [item_emb], [g_item])
        if debug:
            raise_on_nan(f"G step {step}", loss=loss, user_emb=user_emb, item_emb=item_emb)
        g_sum += loss

    d_opt.zero_grad(set_to_none=True)
    item_opt.zero_grad(set_to_none=True)
    return d_sum / (n_batches * d_steps), g_sum / (n_batches * g_steps)


def sharded_ganmf_epoch(
    lay: ShardLayout, params: GANMFParams, d_opt: torch.optim.Optimizer, item_opt: torch.optim.Optimizer,
    user_state, urm, perm: torch.Tensor, weights: torch.Tensor,
    *, g_lr: float, m: float, recon_coefficient: float, d_reg: float, g_reg: float,
    n_batches: int, batch_size: int, d_steps: int, g_steps: int,
    lazy_user_adam: bool = False, compute_dtype: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ganmf_epoch`` (models/ganmf.py) on this rank's shards, in place,
    through ``sharded_generator_epoch``."""
    cd = torch.bfloat16 if compute_dtype == "bf16" else None
    return sharded_generator_epoch(
        lay, params, d_opt, item_opt, user_state, urm, perm, weights,
        lambda uids, real, w: d_grads(lay, params, uids, real, w, m, d_reg, cd),
        lambda uids, real, w: g_grads(lay, params, uids, real, w, recon_coefficient, g_reg, cd),
        g_lr=g_lr, n_batches=n_batches, batch_size=batch_size, d_steps=d_steps, g_steps=g_steps,
        lazy_user_adam=lazy_user_adam)


def make_distributed_ganmf_step(plan: MeshPlan, m: float, recon_coefficient: float,
                                d_reg: float, g_reg: float):
    """Returns step(params, d_opt, g_opt, urm, uids, w, d_lr, g_lr) ->
    (params, d_opt, g_opt, dloss, gloss): one D step then one G step on the
    batch ``uids`` (weights ``w``, the same on every rank), both with Adam in
    optax's form (``init_distributed``'s optimizers), in place. ``params``
    are ``shard_ganmf_params``'s and ``urm`` this rank's
    ``plan.put(urm, plan.urm)``."""

    def step(params: GANMFParams, d_opt, g_opt, urm, uids, w, d_lr, g_lr):
        _, shapes, n_cols = params.mesh_layout
        lay = ShardLayout(plan, shapes[0][0], n_cols)
        real = lay.batch_rows(urm, uids)
        dloss, grads = d_grads(lay, params, uids, real, w, m, d_reg)
        for group in d_opt.param_groups:
            group["lr"] = float(d_lr)
        apply_grads(d_opt, params.d_params(), grads)
        gloss, g_user, g_item = g_grads(lay, params, uids, real, w, recon_coefficient, g_reg)
        for group in g_opt.param_groups:
            group["lr"] = float(g_lr)
        apply_grads(g_opt, params.g_params(), [g_user, g_item])
        return params, d_opt, g_opt, dloss, gloss

    return step
