"""CFGAN (CIKM'18): training and serving.

Port of ganmf_tpu/models/cfgan.py with dense URM storage. G is an MLP from a
training profile to scores over every column; D an MLP over
concat(profile, data) to one logit. Glorot-uniform kernels and U(-0.01, 0.01)
biases. Every epoch draws the ZR/PM negative masks: per row, the
k_u = int(n_zeros * ratio) non-interactions with the smallest uniform keys,
an exact-k selection that runs on K2 (ops/select.py) on the card. Then the
D phase and the G phase take their minibatches in natural row order:

    d_loss = BCE(D(cond, real) -> 1) + BCE(D(cond, G(cond) * train_mask) -> 0) + d_reg * L2(D)
    g_loss = BCE(D(cond, fake) -> 1) + g_reg * L2(G) + zr_coefficient * mean_u(sum_i fake^2 * zr_mask)

The JAX package runs the epoch as one jitted scan; here it is an eager loop
of the same steps. Parameters keep the JAX layouts and order (weights
[fan_in, fan_out], biases [fan_out]; G.ws, G.bs, D.ws, D.bs), so a JAX
``saveModel`` zip loads into the port. CFGAN has no factors, so it ranks
through the dense route of models/base.py, as in the JAX package.

Two storages, as in JAX (:144-190, :291-313): "dense" keeps the [U, I] URM
and the epoch's full mask planes on the device; "csr" keeps the padded-CSR
planes, O(nnz), densifies each [B, I] minibatch and draws its masks from
keyed per-row uniforms (ops/keyed.py), through K2 once a minibatch for each
mask the phase needs (PM in the D phase, ZR and PM in the G phase). A row's
uniforms depend only on (seed, epoch, stream, row), so the D and G phases
see the same mask for a row within an epoch, as JAX's ``fold_in`` keys do.
Scoring in csr storage streams the profiles (:384-442).

``fit(mesh_plan=...)`` trains on a mesh of ranks (JAX :324-332), in either
storage and compute dtype: each rank holds its shards of the URM (dense at
``plan.urm``, or its rows of the padded-CSR planes) and of the parameters
(``parallel.distributed.shard_cfgan_params``) and runs
``parallel.adversarial.sharded_cfgan_epoch``, which draws each mask through
K2 on whole rows. On a mesh-trained model ``score_device`` runs the sharded
forward over every training row (this rank's columns of G's output, kept
until the parameters change) and all-gathers the requested rows' columns;
``score_device_columns`` hands the mesh evaluator this rank's columns as
they are. G is never gathered whole but for saving and the checkpoints.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganmf_tpu_torch.data.device import PaddedCSR, dense_from_sparse, padded_csr_from_sparse, padded_rows_dense
from ganmf_tpu_torch.models.gan_base import (  # noqa: F401  (ADAM_* re-exported)
    ADAM_BETAS,
    ADAM_EPS,
    AdversarialRecommender,
    apply_grads,
    make_batches,
    padded_weights,
)
from ganmf_tpu_torch.ops.keyed import keyed_uniforms
from ganmf_tpu_torch.ops.topk import smallest_k_mask
from ganmf_tpu_torch.utils.debug import debug_enabled, raise_on_nan
from ganmf_tpu_torch.utils.profiling import count, span

ACTIVATIONS = {
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "LeakyReLU": F.leaky_relu,  # slope 0.01, as jax.nn.leaky_relu
}


class MLPParams(nn.Module):
    """An MLP's weights [fan_in, fan_out] and biases [fan_out], registered
    weights first, then biases: the JAX NamedTuple's flatten order."""

    def __init__(self, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor]):
        super().__init__()
        self.ws = nn.ParameterList([nn.Parameter(w) for w in ws])
        self.bs = nn.ParameterList([nn.Parameter(b) for b in bs])


class CFGANParams(nn.Module):
    """G then D; ``parameters()`` yields G.ws, G.bs, D.ws, D.bs, the order of
    the JAX ``tree_flatten`` and of the saveModel ``param_i`` numbering."""

    def __init__(self, G: MLPParams, D: MLPParams):
        super().__init__()
        self.G = G
        self.D = D


def _init_mlp(dims, generator: torch.Generator) -> MLPParams:
    ws, bs = [], []
    for l in range(len(dims) - 1):
        scale = math.sqrt(6.0 / (dims[l] + dims[l + 1]))
        ws.append(torch.empty((dims[l], dims[l + 1])).uniform_(-scale, scale, generator=generator))
        bs.append(torch.empty((dims[l + 1],)).uniform_(-0.01, 0.01, generator=generator))
    return MLPParams(ws, bs)


def init_params(g_dims, d_dims, generator: torch.Generator, device: torch.device) -> CFGANParams:
    """Glorot-uniform kernels and U(-0.01, 0.01) biases (JAX :57-66), drawn on
    the host from ``generator`` (a CPU generator), so that a seed gives the
    same weights on every device."""
    return CFGANParams(_init_mlp(g_dims, generator), _init_mlp(d_dims, generator)).to(device)


def params_from_jax(arrays: Union[Sequence[np.ndarray], Mapping], g_layers: int,
                    device: torch.device) -> CFGANParams:
    """The port's parameters from the JAX ones: the leaves in ``tree_flatten``
    order, or the ``param_0..param_n`` dict a JAX ``saveModel`` writes.
    ``g_layers`` is the generator's hidden layer count; D takes the rest."""
    if isinstance(arrays, Mapping):
        n = sum(1 for name in arrays if str(name).startswith("param_"))
        arrays = [arrays[f"param_{i}"] for i in range(n)]
    n_g = 2 * (int(g_layers) + 1)
    if len(arrays) <= n_g or (len(arrays) - n_g) % 2:
        raise ValueError(f"{len(arrays)} arrays do not split into G with {g_layers} hidden layers and D")
    t = [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]
    gl, dl = n_g // 2, (len(t) - n_g) // 2
    G = MLPParams(t[:gl], t[gl:n_g])
    D = MLPParams(t[n_g : n_g + dl], t[n_g + dl :])
    return CFGANParams(G, D).to(device)


def _mlp(p: MLPParams, x: torch.Tensor, hidden_act: str, dtype: Optional[torch.dtype] = None):
    """The MLP, activation after every layer but the last. ``dtype`` casts the
    weights (bf16 compute against f32 master parameters)."""
    act = ACTIVATIONS[hidden_act]
    h = x
    n = len(p.ws)
    for l, (w, b) in enumerate(zip(p.ws, p.bs)):
        if dtype is not None:
            w, b = w.to(dtype), b.to(dtype)
        h = h @ w + b
        if l < n - 1:
            h = act(h)
    return h


def _bce(logits, target: float, w):
    # the loss reduction always runs in f32 (bf16 activations upcast here)
    lg = logits[:, 0].float()
    per = F.binary_cross_entropy_with_logits(lg, torch.full_like(lg, target), reduction="none")
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def _l2(p: nn.Module):
    return sum((t**2).sum() / 2.0 for t in p.parameters())


def negative_mask(block: torch.Tensor, u: torch.Tensor, ratio: float) -> torch.Tensor:
    """Per-row exact-k without-replacement negatives of ``block`` [R, I]:
    k_u = int(n_zeros * ratio) of each row's non-interactions, those with the
    smallest keys ``u`` [R, I] (interactions keyed +inf), as ``block``'s
    dtype. The product is taken in float32 and truncated, as JAX does with
    its float32 ratio; float64 gives another k_u for some pairs (12827 *
    0.4515475140394092 is 5792 in float32, 5791 in float64). A Python scalar
    times a float32 tensor is rounded to float32 and multiplied in float32,
    with no copy to the device (models/caae.py ``nu_sizes``)."""
    interacted = block != 0
    n_zeros = (~interacted).sum(1).to(torch.float32)
    keys = torch.where(interacted, float("inf"), u)
    k_u = (n_zeros * float(ratio)).to(torch.int32)
    return smallest_k_mask(keys, k_u).to(block.dtype)


def sample_negative_masks(urm: torch.Tensor, zr_ratio: float, zp_ratio: float, scheme: str, *,
                          uniforms: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]):
    """The (ZR, PM) negative masks of a dense block (JAX :90-113).

    ``uniforms`` is the (ZR, PM) pair of [R, I] float32 draws in [0, 1); the
    one a scheme does not use may be None, and its mask is zeros."""
    u_zr, u_pm = uniforms
    zr = negative_mask(urm, u_zr, zr_ratio) if scheme in ("ZP", "ZR") else torch.zeros_like(urm)
    pm = negative_mask(urm, u_pm, zp_ratio) if scheme in ("ZP", "PM") else torch.zeros_like(urm)
    return zr, pm


#: Rows a chunk of csr storage's streamed scoring densifies (JAX :394).
STREAM_CHUNK = 2048

#: The keyed streams of the csr storage's two masks.
ZR_STREAM, PM_STREAM = 0, 1


def csr_batch_inputs(urm: PaddedCSR, n_rows: int, n_cols: int, lo: int, size: int, row_uniforms,
                     *, zr_ratio: float, zp_ratio: float, scheme: str, with_zr: bool):
    """(cond, train mask, ZR mask or None) of the minibatch of rows
    [lo, lo + size) from padded-CSR storage (JAX :156-180): the rows densified
    (rows past ``n_rows`` are zeros, as JAX's out-of-range gather gives), and
    each mask drawn from ``row_uniforms(stream, rows)``. The ZR mask is drawn
    only when ``with_zr`` (the G phase). The densify is the span
    ``train.rows``, the draws ``train.masks``."""
    with span("train.rows"):
        rows = torch.arange(lo, lo + size, device=urm.idx.device)
        n = max(0, min(size, n_rows - lo))
        cond = padded_rows_dense(urm, rows[:n], n_cols)
        if n < size:
            cond = F.pad(cond, (0, 0, 0, size - n))
    with span("train.masks"):
        zr = None
        if with_zr:
            zr = (negative_mask(cond, row_uniforms(ZR_STREAM, rows), zr_ratio) if scheme in ("ZP", "ZR")
                  else torch.zeros_like(cond))
        if scheme in ("ZP", "PM"):
            tmask = torch.clamp(cond + negative_mask(cond, row_uniforms(PM_STREAM, rows), zp_ratio), 0.0, 1.0)
        else:
            tmask = cond
    return cond, tmask, zr


def d_loss(D: MLPParams, G: MLPParams, cond, tmask, w, d_reg: float, d_hidden_act: str,
           g_hidden_act: str, dtype: Optional[torch.dtype] = None):
    """D's loss on one minibatch (JAX :192-197); G takes no gradient."""
    with torch.no_grad():
        fake = _mlp(G, cond, g_hidden_act, dtype) * tmask
    d_real = _mlp(D, torch.cat([cond, cond], dim=1), d_hidden_act, dtype)
    d_fake = _mlp(D, torch.cat([cond, fake], dim=1), d_hidden_act, dtype)
    return _bce(d_real, 1.0, w) + _bce(d_fake, 0.0, w) + d_reg * _l2(D)


def g_loss(G: MLPParams, D: MLPParams, cond, tmask, zmask, w, g_reg: float,
           zr_coefficient: float, d_hidden_act: str, g_hidden_act: str,
           dtype: Optional[torch.dtype] = None):
    """G's loss on one minibatch (JAX :199-206), through the frozen D."""
    fake_raw = _mlp(G, cond, g_hidden_act, dtype)
    d_fake = _mlp(D, torch.cat([cond, fake_raw * tmask], dim=1), d_hidden_act, dtype)
    sq = fake_raw.float() ** 2 * zmask.float()
    zr_loss = (sq.sum(1) * w).sum() / torch.clamp(w.sum(), min=1.0)
    return _bce(d_fake, 1.0, w) + g_reg * _l2(G) + zr_coefficient * zr_loss


def cfgan_epoch(
    params: CFGANParams, d_opt: torch.optim.Optimizer, g_opt: torch.optim.Optimizer,
    urm: Union[torch.Tensor, PaddedCSR], uniforms, d_weights: torch.Tensor, g_weights: torch.Tensor,
    *, d_reg: float, g_reg: float, zr_ratio: float, zp_ratio: float, zr_coefficient: float,
    scheme: str, d_hidden_act: str, g_hidden_act: str,
    d_n_batches: int, d_batch: int, g_n_batches: int, g_batch: int, d_steps: int, g_steps: int,
    compute_dtype: str = "f32",
) -> None:
    """One epoch, in place (JAX :124-230): the masks, then
    ``d_steps * d_n_batches`` D minibatches, then ``g_steps * g_n_batches`` G
    minibatches, each in natural row order. ``d_opt`` and ``g_opt`` are Adam
    over D's and G's parameters with the learning rates; L2 is in the loss.
    ``compute_dtype="bf16"`` runs activations and matmuls in bfloat16 against
    the f32 parameters (the URM's values are then bf16 too); losses and L2
    stay f32.

    Dense storage: ``urm`` is the [padded, I] URM and ``uniforms`` the (ZR,
    PM) pair of [padded, I] planes (None for a mask the scheme does not use);
    the masks are drawn over the whole matrix once. csr storage: ``urm`` is
    the training matrix's PaddedCSR and ``uniforms`` a callable
    ``row_uniforms(stream, rows) -> [B, I]``; each minibatch draws its own
    masks (``csr_batch_inputs``). Under ``GANMF_TPU_DEBUG`` every step's loss
    and updated parameters are checked for NaN.

    Each minibatch is a ``train.d_step`` or ``train.g_step`` span (counted
    under ``cfgan.minibatches``) with four children: ``train.rows`` (the
    batch's rows; the csr densify), ``train.masks`` (csr storage: the keyed
    draw and K2 of the batch's masks), ``train.grad`` (the loss and its
    gradient) and ``train.update`` (the optimizer step). Dense storage draws
    the whole epoch's masks first, in one ``train.masks`` span."""
    cd = torch.bfloat16 if compute_dtype == "bf16" else None
    G, D = params.G, params.D
    d_params, g_params = list(D.parameters()), list(G.parameters())
    debug = debug_enabled()

    if isinstance(urm, PaddedCSR):
        n_rows, n_cols = urm.idx.shape[0], G.bs[-1].shape[0]

        def batch_inputs(lo, size, with_zr):
            return csr_batch_inputs(urm, n_rows, n_cols, lo, size, uniforms, zr_ratio=zr_ratio,
                                    zp_ratio=zp_ratio, scheme=scheme, with_zr=with_zr)
    else:
        with span("train.masks"):
            zr_full, pm_full = sample_negative_masks(urm, zr_ratio, zp_ratio, scheme, uniforms=uniforms)
            # train mask: profile with PM-sampled negatives flipped to 1 (CFGAN.py:242-249)
            train_full = torch.clamp(urm + pm_full, 0.0, 1.0) if scheme in ("ZP", "PM") else urm

        def batch_inputs(lo, size, with_zr):
            with span("train.rows"):
                return urm[lo : lo + size], train_full[lo : lo + size], zr_full[lo : lo + size]

    for step in range(d_steps * d_n_batches):
        b = (step % d_n_batches) * d_batch
        count("cfgan.minibatches")
        with span("train.d_step"):
            cond, tmask, _ = batch_inputs(b, d_batch, False)
            with span("train.grad"):
                loss = d_loss(D, G, cond, tmask, d_weights[b : b + d_batch], d_reg, d_hidden_act, g_hidden_act,
                              cd)
                grads = torch.autograd.grad(loss, d_params)
            with span("train.update"):
                apply_grads(d_opt, d_params, grads)
        if debug:
            raise_on_nan(f"CFGAN D step {step}", loss=loss, **dict(D.named_parameters()))

    for step in range(g_steps * g_n_batches):
        b = (step % g_n_batches) * g_batch
        count("cfgan.minibatches")
        with span("train.g_step"):
            cond, tmask, zmask = batch_inputs(b, g_batch, True)
            with span("train.grad"):
                loss = g_loss(G, D, cond, tmask, zmask, g_weights[b : b + g_batch], g_reg, zr_coefficient,
                              d_hidden_act, g_hidden_act, cd)
                grads = torch.autograd.grad(loss, g_params)
            with span("train.update"):
                apply_grads(g_opt, g_params, grads)
        if debug:
            raise_on_nan(f"CFGAN G step {step}", loss=loss, **dict(G.named_parameters()))

    d_opt.zero_grad(set_to_none=True)
    g_opt.zero_grad(set_to_none=True)


class CFGAN(AdversarialRecommender):
    RECOMMENDER_NAME = "CFGAN"

    @property
    def params(self) -> Optional[CFGANParams]:
        return self._params

    @params.setter
    def params(self, value: Optional[CFGANParams]) -> None:
        # new parameters drop the cached generator output and activations
        self._params = value
        self._drop_score_caches()

    def _drop_score_caches(self) -> None:
        self._score_cache = None
        self._penult_cache = None
        self._mesh_cache = None

    def fit(
        self,
        d_nodes: int = 32,
        g_nodes: int = 32,
        d_layers: int = 1,
        g_layers: int = 1,
        scheme: str = "ZR",
        d_hidden_act: str = "linear",
        g_hidden_act: str = "linear",
        epochs: int = 300,
        d_lr: float = 1e-5,
        g_lr: float = 1e-5,
        d_reg: float = 0,
        g_reg: float = 0,
        d_steps: int = 1,
        g_steps: int = 1,
        d_batch_size: int = 32,
        g_batch_size: int = 32,
        zr_ratio: float = 0.0,
        zp_ratio: float = 0.0,
        zr_coefficient: float = 0.0,
        allow_worse=5,
        freq=5,
        after: int = 0,
        metrics=("MAP",),
        validation_evaluator=None,
        sample_every=None,
        validation_set=None,
        mesh_plan=None,
        urm_storage: str = "dense",
        compute_dtype: str = "f32",
    ):
        """Train on the training matrix (JAX :236-360). ``urm_storage``:
        "dense" keeps the URM and the per-epoch masks dense on the model's
        device, their uniform keys from a generator on that device seeded
        with ``seed``; "csr" keeps the padded-CSR planes, O(nnz), and draws
        each minibatch's masks from keyed uniforms (``keyed_uniforms`` of the
        epoch counted from 1). Masked configurations are distributionally
        (not bitwise) equal between the storages; unmasked ones match.
        ``mesh_plan`` (``parallel.make_mesh``'s plan, on the model's device)
        trains on a mesh: every rank calls ``fit`` with the same arguments,
        makes the same draws and keeps its shards; only rank 0 logs, prints
        and writes checkpoints."""
        if mesh_plan is not None and mesh_plan.device != self.device:
            raise ValueError(f"model on {self.device}, its mesh plan on {mesh_plan.device}")
        if urm_storage not in ("dense", "csr"):
            raise ValueError(f"urm_storage must be 'dense' or 'csr', got {urm_storage!r}")
        if compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"compute_dtype must be 'f32' or 'bf16', got {compute_dtype!r}")
        # ratios are fractions in [0, 1]; the root search space's {10..90}
        # integers (RecSysExp.py:480-481) are percentage points: normalize
        if zr_ratio > 1:
            zr_ratio = zr_ratio / 100.0
        if zp_ratio > 1:
            zp_ratio = zp_ratio / 100.0

        self.config = dict(
            d_nodes=d_nodes, g_nodes=g_nodes, d_layers=d_layers, g_layers=g_layers, scheme=scheme,
            d_hidden_act=d_hidden_act, g_hidden_act=g_hidden_act, epochs=epochs, d_lr=d_lr, g_lr=g_lr,
            d_reg=d_reg, g_reg=g_reg, d_steps=d_steps, g_steps=g_steps,
            d_batch_size=d_batch_size, g_batch_size=g_batch_size,
            zr_ratio=zr_ratio, zp_ratio=zp_ratio, zr_coefficient=zr_coefficient,
        )

        train_csr = self._train_matrix()
        n_rows, n_cols = train_csr.shape
        d_n_batches, d_padded = make_batches(n_rows, int(d_batch_size))
        g_n_batches, g_padded = make_batches(n_rows, int(g_batch_size))
        padded = max(d_padded, g_padded)
        self._stream_seen = urm_storage == "csr"
        layout = None
        if mesh_plan is not None:
            from ganmf_tpu_torch.parallel.distributed import ShardLayout

            # csr storage shards the matrix's rows, dense storage the padded URM's
            layout = ShardLayout(mesh_plan, n_rows if self._stream_seen else padded, n_cols)
        if self._stream_seen:
            if layout is None:
                urm = padded_csr_from_sparse(train_csr, self.device)
            else:
                from ganmf_tpu_torch.parallel.distributed import shard_padded_csr

                urm = shard_padded_csr(padded_csr_from_sparse(train_csr, torch.device("cpu")), mesh_plan)
            if compute_dtype == "bf16":
                urm = urm._replace(val=urm.val.to(torch.bfloat16))
        else:
            lo, hi = (0, padded) if layout is None else (layout.r0, layout.r1)
            c0, c1 = (0, n_cols) if layout is None else (layout.i0, layout.i1)
            urm = torch.zeros((hi - lo, c1 - c0), dtype=torch.float32, device=self.device)
            if lo < n_rows:
                urm[: min(hi, n_rows) - lo] = dense_from_sparse(train_csr[lo:hi, c0:c1], self.device)
            if compute_dtype == "bf16":
                urm = urm.to(torch.bfloat16)  # the masks and the condition follow
        self._train_padded = urm if self._stream_seen and layout is None else None
        weights = torch.from_numpy(padded_weights(n_rows, padded)).to(self.device)

        g_dims = [n_cols] + [int(g_nodes)] * int(g_layers) + [n_cols]
        d_dims = [2 * n_cols] + [int(d_nodes)] * int(d_layers) + [1]
        generator = torch.Generator().manual_seed(self.seed)
        self.mesh_plan = mesh_plan
        if mesh_plan is None:
            self.params = init_params(g_dims, d_dims, generator, self.device)
            epoch, lead, extra = cfgan_epoch, (), {}
        else:
            from ganmf_tpu_torch.parallel.adversarial import sharded_cfgan_epoch
            from ganmf_tpu_torch.parallel.distributed import shard_cfgan_params

            self.params = shard_cfgan_params(init_params(g_dims, d_dims, generator, torch.device("cpu")), mesh_plan)
            epoch, lead, extra = sharded_cfgan_epoch, (layout,), dict(n_rows=n_rows)
        self._d_opt = torch.optim.Adam(self.params.D.parameters(), lr=d_lr, betas=ADAM_BETAS, eps=ADAM_EPS)
        self._g_opt = torch.optim.Adam(self.params.G.parameters(), lr=g_lr, betas=ADAM_BETAS, eps=ADAM_EPS)
        self._epoch_gen = torch.Generator(device=self.device).manual_seed(self.seed)
        # the keyed draws' epoch counter (csr storage); checkpoints carry it,
        # so that a resumed fit redraws the masks the cut one would have
        self._mask_epoch = 0
        start_epoch = self.resume_from_checkpoint()  # also restores the generator and the counter

        def epoch_uniforms():
            if not self._stream_seen:
                return self._epoch_uniforms(padded, n_cols, scheme)
            self._mask_epoch += 1
            epoch = self._mask_epoch
            return lambda stream, rows: keyed_uniforms(self.seed, epoch, stream, rows, n_cols)

        def epoch_fn(_):
            epoch(
                *lead, self.params, self._d_opt, self._g_opt, urm, epoch_uniforms(), weights, weights,
                d_reg=d_reg, g_reg=g_reg, zr_ratio=zr_ratio, zp_ratio=zp_ratio,
                zr_coefficient=zr_coefficient, scheme=scheme,
                d_hidden_act=d_hidden_act, g_hidden_act=g_hidden_act,
                d_n_batches=d_n_batches, d_batch=int(d_batch_size),
                g_n_batches=g_n_batches, g_batch=int(g_batch_size),
                d_steps=int(d_steps), g_steps=int(g_steps), compute_dtype=compute_dtype, **extra,
            )
            self._drop_score_caches()

        result = self._run_training_loop(
            epochs, validation_evaluator, validation_set, sample_every,
            allow_worse, freq, list(metrics), after, epoch_fn=epoch_fn, start_epoch=start_epoch,
        )
        self._invalidate_device_cache()
        return result

    def _epoch_uniforms(self, n_rows: int, n_cols: int, scheme: str):
        """The epoch's (ZR, PM) uniform keys, [n_rows, n_cols] each, drawn on
        the model's device; None for the mask the scheme does not use."""
        def draw():
            return torch.rand((n_rows, n_cols), generator=self._epoch_gen, device=self.device)

        u_zr = draw() if scheme in ("ZP", "ZR") else None
        u_pm = draw() if scheme in ("ZP", "PM") else None
        return u_zr, u_pm

    # -- crash resume (full training state) -----------------------------------
    def _mesh_optimizers(self):
        """(optimizer state, index of its first parameter): G's, then D's."""
        return (("g_state", 0), ("d_state", len(list(self.params.G.parameters()))))

    def _checkpoint_state(self):
        """The training state; on a mesh its full tensors, gathered from the
        shards (a collective), so that a checkpoint resumes on any plan."""
        state = {
            "params": self.params.state_dict(),
            "d_state": self._d_opt.state_dict(),
            "g_state": self._g_opt.state_dict(),
            "epoch_gen": self._epoch_gen.get_state(),
            "mask_epoch": torch.tensor(self._mask_epoch, dtype=torch.int64),
        }
        if self.mesh_plan is not None:
            from ganmf_tpu_torch.parallel.distributed import gather_module_state

            state = gather_module_state(state, self.params, self.mesh_plan, self._mesh_optimizers())
        return state

    def _restore_checkpoint_state(self, state):
        if self.mesh_plan is not None:
            from ganmf_tpu_torch.parallel.distributed import shard_module_state

            state = shard_module_state(state, self.params, self.mesh_plan, self._mesh_optimizers())
        self.params.load_state_dict(state["params"])
        self._d_opt.load_state_dict(state["d_state"])
        self._g_opt.load_state_dict(state["g_state"])
        self._epoch_gen.set_state(state["epoch_gen"])
        self._mask_epoch = int(state["mask_epoch"])
        self._drop_score_caches()

    # -- scoring (reference CFGAN.py:342-368) ----------------------------------
    def _g_act(self) -> str:
        if self.params is None or not self.config:
            raise RuntimeError("CFGAN has no parameters: fit it or load them first")
        return self.config["g_hidden_act"]

    @torch.no_grad()
    def _full_generator_output(self) -> torch.Tensor:
        """G applied to every training-orientation profile, cached until the
        parameters change."""
        if self._score_cache is None:
            act = self._g_act()
            self._score_cache = _mlp(self.params.G, self._train_dense(), act)
        return self._score_cache

    def _stream_chunks(self, pc: PaddedCSR):
        """The training rows densified in chunks of ``STREAM_CHUNK`` (float32)."""
        n_rows, n_cols = pc.idx.shape[0], self.params.G.bs[-1].shape[0]
        for lo in range(0, n_rows, STREAM_CHUNK):
            rows = torch.arange(lo, min(lo + STREAM_CHUNK, n_rows), device=pc.idx.device)
            yield padded_rows_dense(pc, rows, n_cols).float()

    @torch.no_grad()
    def _stream_penult(self, pc: PaddedCSR) -> Optional[torch.Tensor]:
        """[R, H] activations of G's penultimate layer over every training row,
        built in chunks and cached until the parameters change (JAX
        :384-403); None when G has no hidden layer."""
        G = self.params.G
        if len(G.ws) < 2:
            return None
        if self._penult_cache is None:
            act = ACTIVATIONS[self._g_act()]
            hidden = list(zip(G.ws, G.bs))[:-1]

            def penult(h):
                for w, b in hidden:  # every layer here is hidden: activated after each
                    h = act(h @ w + b)
                return h

            self._penult_cache = torch.cat([penult(cond) for cond in self._stream_chunks(pc)])
        return self._penult_cache

    @torch.no_grad()
    def _mesh_output(self):
        """[layout, [R, C_m], None]: on a mesh-trained model, G's output over
        every training row in this rank's columns, by the sharded forward
        (chunks of ``STREAM_CHUNK`` rows), kept until the parameters change;
        the last slot takes the whole output in item mode."""
        if self._mesh_cache is None:
            from ganmf_tpu_torch.parallel.adversarial import mlp_shard
            from ganmf_tpu_torch.parallel.distributed import ShardLayout, _padded_shard_rows

            mat = self._train_matrix()
            lay = ShardLayout(self.mesh_plan, *mat.shape)
            pc = padded_csr_from_sparse(mat, self.device)
            act = self._g_act()
            out = torch.cat([
                mlp_shard(lay, self.params.G, _padded_shard_rows(
                    pc, torch.arange(lo, min(lo + STREAM_CHUNK, mat.shape[0]), device=self.device),
                    lay.i0, lay.i1).contiguous(), act)
                for lo in range(0, mat.shape[0], STREAM_CHUNK)])
            self._mesh_cache = [lay, out, None]
        return self._mesh_cache

    @torch.no_grad()
    def _mesh_scores(self, user_ids: torch.Tensor) -> torch.Tensor:
        from ganmf_tpu_torch.parallel.adversarial import rows_full

        cache = self._mesh_output()
        lay, out = cache[0], cache[1]
        if self.mode != "item":
            return rows_full(lay, out.index_select(0, user_ids))
        if cache[2] is None:  # item mode: the whole [items, users] output
            cache[2] = rows_full(lay, out)
        return cache[2].T.index_select(0, user_ids)

    @torch.no_grad()
    def score_device_columns(self, user_ids: torch.Tensor, i0: int, i1: int) -> torch.Tensor:
        """[B, i1 - i0] scores of items [i0, i1): on a mesh-trained model in
        user mode, this rank's own columns of G's output with no gather."""
        if self.mesh_plan is not None and self.mode != "item":
            lay, out = self._mesh_output()[:2]
            if (lay.i0, lay.i1) == (i0, i1):
                return out.index_select(0, user_ids)
        return self.score_device(user_ids)[:, i0:i1]

    @torch.no_grad()
    def score_device(self, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, I] scores for external users, in both modes. In csr storage the
        profiles stream (JAX :412-438): user mode runs G on the users' rows;
        item mode serves columns of G's output over every item row, as
        ``penult @ W_last[:, uid] + b_last[uid]`` from the cached penultimate
        activations, so no [I, U] output is formed. On a mesh-trained model:
        ``_mesh_scores``, a collective every rank calls."""
        if self.mesh_plan is not None:
            return self._mesh_scores(user_ids)
        pc = getattr(self, "_train_padded", None)
        if not (self._stream_seen and pc is not None):
            out = self._full_generator_output()
            if self.mode == "item":
                return out.T.index_select(0, user_ids)
            return out.index_select(0, user_ids)
        G = self.params.G
        if self.mode != "item":
            cond = padded_rows_dense(pc, user_ids, G.bs[-1].shape[0]).float()
            return _mlp(G, cond, self._g_act())
        penult = self._stream_penult(pc)
        if penult is None:  # no hidden layer: G's output over the rows, a chunk at a time
            return torch.cat([_mlp(G, cond, self._g_act()).index_select(1, user_ids)
                              for cond in self._stream_chunks(pc)]).T
        w_last, b_last = G.ws[-1], G.bs[-1]
        return (penult @ w_last.index_select(1, user_ids) + b_last.index_select(0, user_ids)[None, :]).T

    # -- persistence ----------------------------------------------------------
    def loadModel(self, folder_path, file_name=None):
        """Load a zip written by this port's or the JAX package's saveModel,
        and rebuild the parameters from it."""
        data = super().loadModel(folder_path, file_name)
        if "param_0" in data:
            self.params = params_from_jax(data, int(data["config"]["g_layers"]), self.device)
            self.mesh_plan = None  # the full parameters
        return data
