"""Multi-rank GANMF training: the sharded parameters, step and epoch.

Port of ganmf_tpu/parallel/distributed.py. The placement is the JAX file's:

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

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ganmf_tpu_torch.data.device import PaddedCSR
from ganmf_tpu_torch.models.gan_base import ADAM_BETAS, ADAM_EPS, apply_grads
from ganmf_tpu_torch.models.ganmf import FIELDS, GANMFParams, _l2, init_params, tf1_adam_
from ganmf_tpu_torch.parallel import comm
from ganmf_tpu_torch.parallel.mesh import MODEL_AXIS, MeshPlan, _names
from ganmf_tpu_torch.utils.debug import debug_enabled, raise_on_nan


def ganmf_specs(plan: MeshPlan) -> Dict[str, tuple]:
    """Each GANMF tensor's placement, by field name."""
    return dict(user_emb=plan.user_rows, item_emb=plan.item_rows, enc_w=plan.item_rows,
                enc_b=plan.replicated, dec_w=plan.item_cols, dec_b=plan.named(MODEL_AXIS))


class ShardedGANMFParams(GANMFParams):
    """This rank's shards of the six GANMF tensors, with the global (rows,
    cols) of the training state."""

    def __init__(self, n_rows: int, n_cols: int, tensors):
        super().__init__(*tensors)
        self.n_rows, self.n_cols = n_rows, n_cols

    def global_shape(self, name: str) -> Tuple[int, ...]:
        E, K = self.enc_b.shape[0], self.user_emb.shape[1]
        return dict(user_emb=(self.n_rows, K), item_emb=(self.n_cols, K), enc_w=(self.n_cols, E),
                    enc_b=(E,), dec_w=(E, self.n_cols), dec_b=(self.n_cols,))[name]


def shard_ganmf_params(params: GANMFParams, plan: MeshPlan) -> ShardedGANMFParams:
    """This rank's shards of full GANMF parameters (made the same on every
    rank), on the plan's device."""
    specs = ganmf_specs(plan)
    n_rows, n_cols = params.user_emb.shape[0], params.item_emb.shape[0]
    with torch.no_grad():
        return ShardedGANMFParams(n_rows, n_cols, [
            plan.put(getattr(params, name).detach(), specs[name]) for name in FIELDS])


def gather_ganmf_params(params: ShardedGANMFParams, plan: MeshPlan) -> GANMFParams:
    """The full parameters on every rank (a collective)."""
    return GANMFParams(*gather_tensors(params, plan, [p.detach() for p in params.parameters()], FIELDS))


def gather_tensors(params: ShardedGANMFParams, plan: MeshPlan, tensors, names):
    """Full tensors from shards laid out as the GANMF fields ``names`` (a
    collective)."""
    specs = ganmf_specs(plan)
    with torch.no_grad():
        return [plan.gather(t.contiguous(), specs[n], params.global_shape(n))
                for t, n in zip(tensors, names)]


def shard_tensors(plan: MeshPlan, tensors, names):
    """This rank's shards of full tensors laid out as the GANMF fields ``names``."""
    specs = ganmf_specs(plan)
    return [plan.put(t, specs[n]) for t, n in zip(tensors, names)]


def _map_ganmf_state(state, fn):
    """The GANMF training state (``MFGeneratorRecommender._checkpoint_state``'s
    layout) with ``fn(tensor, field name)`` applied to each parameter, Adam
    moment and TF1 moment; step counts and settings as they are."""
    def opt(sd, names):
        return {"param_groups": sd["param_groups"], "state": {
            i: {k: fn(v, names[int(i)]) if k in ("exp_avg", "exp_avg_sq") else v for k, v in st.items()}
            for i, st in sd["state"].items()}}

    return {
        "params": {k: fn(v, k) for k, v in state["params"].items()},
        "d_state": opt(state["d_state"], D_NAMES),
        "item_state": opt(state["item_state"], ("item_emb",)),
        "user_state": {k: fn(v, "user_emb") if k in ("m", "v") else v for k, v in state["user_state"].items()},
    }


def gather_ganmf_state(state, params: ShardedGANMFParams, plan: MeshPlan):
    """A sharded training state with every tensor full (a collective): the
    state a one-card fit holds, as JAX's checkpoint holds ``np.asarray`` of
    its sharded arrays (ganmf_tpu/utils/checkpoint.py:55-63)."""
    return _map_ganmf_state(state, lambda t, n: gather_tensors(params, plan, [t], [n])[0])


def shard_ganmf_state(state, plan: MeshPlan):
    """This rank's shards of a full training state (from any plan's
    checkpoint, or a one-card fit's)."""
    return _map_ganmf_state(state, lambda t, n: shard_tensors(plan, [t], [n])[0])


def shard_padded_csr(pc: PaddedCSR, plan: MeshPlan) -> PaddedCSR:
    """This rank's rows of padded-CSR storage: both [R, L] planes shard over
    the user axes (every column kept), so a rank holds O(nnz / n_user_shards)."""
    return PaddedCSR(idx=plan.put(pc.idx, plan.user_rows), val=plan.put(pc.val, plan.user_rows))


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


def _l2_sums(lay: ShardLayout, tensors, names) -> torch.Tensor:
    """The L2 term, sum(t^2) / 2 over each global tensor, from the shards:
    item-split tensors summed over model, user rows over the user axes
    (once per row), replicated tensors counted once."""
    total = 0.0
    for t, name in zip(tensors, names):
        s = (t.detach().float() ** 2).sum() / 2.0
        if name == "user_emb":
            s = comm.psum(s if lay.rows_primary else torch.zeros_like(s), lay.plan, lay.user_axes)
        elif name != "enc_b":
            s = comm.psum(s, lay.plan, lay.item_axes)
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
    flat = comm.psum(torch.cat([g.reshape(-1) for g in grads]), lay.plan, lay.user_axes)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


D_NAMES, G_NAMES = ("enc_w", "enc_b", "dec_w", "dec_b"), ("user_emb", "item_emb")


def d_grads(lay: ShardLayout, p: GANMFParams, uids, real, w, m, d_reg, dtype=None):
    """(D's loss with L2, the gradients of this rank's D shards). The L2
    term's gradient enters on the first user rank only, so that the sum over
    the user axes counts it once."""
    d_params = p.d_params()
    loss = shard_d_loss(lay, p, uids, real, w, m, dtype)
    graph = loss + d_reg * _l2(d_params) if d_reg and lay.user_lead else loss
    grads = _user_sum(lay, torch.autograd.grad(graph, d_params))
    if d_reg:
        loss = loss.detach() + d_reg * _l2_sums(lay, d_params, D_NAMES)
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
        loss = loss.detach() + g_reg * _l2_sums(lay, p.g_params(), G_NAMES)
    return loss.detach(), g_user, g_item


# -- the epoch and the step --------------------------------------------------------

def sharded_ganmf_epoch(
    lay: ShardLayout, params: GANMFParams, d_opt: torch.optim.Optimizer, item_opt: torch.optim.Optimizer,
    user_state, urm, perm: torch.Tensor, weights: torch.Tensor,
    *, g_lr: float, m: float, recon_coefficient: float, d_reg: float, g_reg: float,
    n_batches: int, batch_size: int, d_steps: int, g_steps: int,
    lazy_user_adam: bool = False, compute_dtype: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ganmf_epoch`` (models/ganmf.py) on this rank's shards, in place:
    ``d_steps * n_batches`` D minibatches, then ``g_steps * n_batches`` G
    minibatches, over the epoch's permutation ``perm`` and ``weights`` (the
    whole batch, the same on every rank). ``urm`` is this rank's URM shard,
    dense [rows_l, I_m] or its rows' padded-CSR planes; the optimizers and
    ``user_state`` hold this rank's shards. Returns the global mean losses
    as device scalars, the same on every rank."""
    cd = torch.bfloat16 if compute_dtype == "bf16" else None
    debug = debug_enabled()
    user_emb, item_emb = params.g_params()

    def batch(step):
        lo = (step % n_batches) * batch_size
        uids, w = perm[lo : lo + batch_size], weights[lo : lo + batch_size]
        return uids, lay.batch_rows(urm, uids), w

    d_sum = torch.zeros((), dtype=torch.float32, device=perm.device)
    for step in range(d_steps * n_batches):
        loss, grads = d_grads(lay, params, *batch(step), m, d_reg, cd)
        apply_grads(d_opt, params.d_params(), grads)
        if debug:
            raise_on_nan(f"D step {step}", loss=loss, **dict(zip(D_NAMES, params.d_params())))
        d_sum += loss

    g_sum = torch.zeros((), dtype=torch.float32, device=perm.device)
    for step in range(g_steps * n_batches):
        uids, real, w = batch(step)
        loss, g_user, g_item = g_grads(lay, params, uids, real, w, recon_coefficient, g_reg, cd)
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


def make_distributed_ganmf_step(plan: MeshPlan, m: float, recon_coefficient: float,
                                d_reg: float, g_reg: float):
    """Returns step(params, d_opt, g_opt, urm, uids, w, d_lr, g_lr) ->
    (params, d_opt, g_opt, dloss, gloss): one D step then one G step on the
    batch ``uids`` (weights ``w``, the same on every rank), both with Adam in
    optax's form (``init_distributed``'s optimizers), in place. ``params``
    are ``shard_ganmf_params``'s and ``urm`` this rank's
    ``plan.put(urm, plan.urm)``."""

    def step(params: ShardedGANMFParams, d_opt, g_opt, urm, uids, w, d_lr, g_lr):
        lay = ShardLayout(plan, params.n_rows, params.n_cols)
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
