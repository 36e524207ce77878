"""GANMF: GAN-based matrix factorization (the paper's model).

Port of ganmf_tpu/models/ganmf.py. The generator is plain MF (user and item
embedding tables, fake profile u_e @ item_e^T); the discriminator is a
one-hidden-layer autoencoder over profiles with an MSE reconstruction loss:

    dloss = real_recon + max(0, m * real_recon - fake_recon) + d_reg * L2(D)
    gloss = (1 - a) * fake_recon + a * MSE(real_enc, fake_enc) + g_reg * L2(G)

(a = recon_coefficient, the feature-matching weight). One epoch runs
``d_steps * n_batches`` D minibatches, then ``g_steps * n_batches`` G
minibatches, over the epoch's shuffled padded permutation. The JAX package
runs it as one jitted scan; here it is an eager loop of the same steps. Two
Adam forms step the parameters, as in the JAX package: optax's
``scale_by_adam`` (= ``torch.optim.Adam``) for D and the item embeddings, and
TF1's form for the user embeddings (``tf1_adam_``), dense by default or on the
batch's rows only (``lazy_user_adam``).

Scores are the generator's factor product, so the port ranks GANMF through the
fused scorer K1 (its ``_factors_device``), where the JAX package ranks its
dense score block with ``lax.top_k``; the lists and metrics are the same.

The epoch loop (``mf_generator_epoch``) and the model base
(``MFGeneratorRecommender``: storage, optimizers, shuffle stream, crash
resume, scoring) are shared with DisGANMF, which has another discriminator.

``fit(mesh_plan=...)`` trains on a mesh of ranks (ganmf_tpu_torch.parallel):
each rank keeps its shards of the URM and of the parameters, placed as
ganmf_tpu/parallel/distributed.py places them, and runs
``parallel.distributed.sharded_ganmf_epoch``, which computes what
``ganmf_epoch`` computes. Every rank calls ``fit`` (and then the evaluator,
``recommend`` and the rest) as one SPMD program; on a mesh-trained model
``_factors_device``, ``score_device`` and the introspection methods gather
the shards, a collective.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ganmf_tpu_torch.data.device import PaddedCSR, dense_from_sparse, padded_csr_from_sparse, padded_rows_dense
from ganmf_tpu_torch.models.gan_base import (
    ADAM_BETAS,
    ADAM_EPS,
    AdversarialRecommender,
    apply_grads,
    make_batches,
    padded_weights,
    shuffled_padded_perm,
)
from ganmf_tpu_torch.utils.debug import debug_enabled, raise_on_nan
from ganmf_tpu_torch.utils.profiling import span, to_device

#: GANMFParams' tensors, in the JAX NamedTuple's field order
FIELDS = ("user_emb", "item_emb", "enc_w", "enc_b", "dec_w", "dec_b")


class GANMFParams(nn.Module):
    """The six GANMF tensors, in the JAX layouts: user_emb [U, K],
    item_emb [I, K], enc_w [I, E], enc_b [E], dec_w [E, I], dec_b [I]
    (U and I in training orientation)."""

    def __init__(self, user_emb, item_emb, enc_w, enc_b, dec_w, dec_b):
        super().__init__()
        # registration order = FIELDS order = the order of parameters()
        self.user_emb = nn.Parameter(user_emb)
        self.item_emb = nn.Parameter(item_emb)
        self.enc_w = nn.Parameter(enc_w)
        self.enc_b = nn.Parameter(enc_b)
        self.dec_w = nn.Parameter(dec_w)
        self.dec_b = nn.Parameter(dec_b)

    def g_params(self):
        return [self.user_emb, self.item_emb]

    def d_params(self):
        return [self.enc_w, self.enc_b, self.dec_w, self.dec_b]

    def autoencode(self, x: torch.Tensor):
        return _autoencode(self.d_params(), x)


def _glorot_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    # jax.nn.initializers.glorot_uniform on a 2-D shape: fan_in = shape[0],
    # fan_out = shape[1], uniform on +-sqrt(6 / (fan_in + fan_out))
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape, dtype=torch.float32).uniform_(-limit, limit, generator=generator)


def init_params(n_rows: int, n_cols: int, num_factors: int, emb_dim: int,
                generator: torch.Generator, device: torch.device) -> GANMFParams:
    """Glorot-uniform embeddings and autoencoder weights, zero biases (the JAX
    ``_init_params``). Drawn on the host from ``generator`` (a CPU generator),
    so a seed gives the same weights on every device."""
    return GANMFParams(
        user_emb=_glorot_uniform((n_rows, num_factors), generator),
        item_emb=_glorot_uniform((n_cols, num_factors), generator),
        enc_w=_glorot_uniform((n_cols, emb_dim), generator),
        enc_b=torch.zeros(emb_dim),
        dec_w=_glorot_uniform((emb_dim, n_cols), generator),
        dec_b=torch.zeros(n_cols),
    ).to(device)


def params_from_jax(arrays: Union[Sequence[np.ndarray], Mapping], device: torch.device) -> GANMFParams:
    """The port's parameters from the JAX ones: six arrays in ``GANMFParams``
    order, or the ``param_0..param_5`` dict a JAX ``saveModel`` writes."""
    if isinstance(arrays, Mapping):
        arrays = [arrays[f"param_{i}"] for i in range(len(FIELDS))]
    if len(arrays) != len(FIELDS):
        raise ValueError(f"GANMF has {len(FIELDS)} parameter arrays, got {len(arrays)}")
    tensors = [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]
    return GANMFParams(*tensors).to(device)


def _masked_mse(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the valid rows (the reference's
    tf.losses.mean_squared_error is a plain mean; padding rows weigh 0). The
    reduction runs in float32 whatever the activations' dtype."""
    diff = a.float() - b.float()
    return (diff**2 * w[:, None]).sum() / (torch.clamp(w.sum(), min=1.0) * a.shape[1])


def _l2(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    # tf.nn.l2_loss(v) = sum(v^2) / 2, always over the float32 master parameters
    return sum((t.float() ** 2).sum() / 2.0 for t in tensors)


def _cast(tensors, dtype: Optional[torch.dtype]):
    return tensors if dtype is None else [t.to(dtype) for t in tensors]


def _autoencode(d, x):
    """D's (code, reconstruction) of profiles ``x``; ``d`` = (enc_w, enc_b,
    dec_w, dec_b)."""
    enc = x @ d[0] + d[1]
    return enc, enc @ d[2] + d[3]


def _fake(g, uids):
    """The generator's profiles for ``uids``; ``g`` = (user_emb, item_emb)."""
    return g[0].index_select(0, uids) @ g[1].T


def d_loss(p: "GANMFParams", uids, real, w, m: float, d_reg: float,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """D's loss on one minibatch (JAX :107); G takes no gradient.
    ``dtype=torch.bfloat16`` runs the matmuls and the [B, I] activations in
    bfloat16 against the float32 parameters; reductions and L2 stay float32."""
    d = _cast(p.d_params(), dtype)
    real = real if dtype is None else real.to(dtype)
    with torch.no_grad():
        fake = _fake(_cast(p.g_params(), dtype), uids)
    real_recon = _masked_mse(real, _autoencode(d, real)[1], w)
    fake_recon = _masked_mse(fake, _autoencode(d, fake)[1], w)
    loss = real_recon + torch.clamp(m * real_recon - fake_recon, min=0.0)
    if d_reg:
        loss = loss + d_reg * _l2(p.d_params())
    return loss


def g_loss(p: "GANMFParams", uids, real, w, recon_coefficient: float, g_reg: float,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """G's loss on one minibatch (JAX :108-112), through the frozen D."""
    d = _cast(p.d_params(), dtype)
    real = real if dtype is None else real.to(dtype)
    fake = _fake(_cast(p.g_params(), dtype), uids)
    fake_enc, fake_dec = _autoencode(d, fake)
    with torch.no_grad():
        real_enc = real @ d[0] + d[1]
    loss = ((1.0 - recon_coefficient) * _masked_mse(fake, fake_dec, w)
            + recon_coefficient * _masked_mse(real_enc, fake_enc, w))
    if g_reg:
        loss = loss + g_reg * _l2(p.g_params())
    return loss


def _losses(p: "GANMFParams", uids, real, w, m, recon_coefficient, d_reg, g_reg,
            dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dloss, gloss) on one minibatch, as the JAX ``_losses`` returns them."""
    return (d_loss(p, uids, real, w, m, d_reg, dtype),
            g_loss(p, uids, real, w, recon_coefficient, g_reg, dtype))


def user_adam_state(user_emb: torch.Tensor) -> Dict[str, torch.Tensor]:
    """TF1 Adam's state for the user embeddings: the moments and the step
    counter ``t``, a float32 scalar on the device that counts every G step."""
    return {"m": torch.zeros_like(user_emb), "v": torch.zeros_like(user_emb),
            "t": torch.zeros((), dtype=torch.float32, device=user_emb.device)}


@torch.no_grad()
def tf1_adam_(param: torch.Tensor, grad: torch.Tensor, state: Dict[str, torch.Tensor], lr: float,
              row_mask: Optional[torch.Tensor] = None) -> None:
    """One step of TF1's Adam, in place (JAX :121-131, :199-208): eps is added
    to the uncorrected sqrt(v) and the bias corrections fold into
    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t), taken in float32 from ``t``.

    ``row_mask`` ([rows] float, > 0 for the batch's rows) gives TF1's sparse
    form: the moments and the parameter move on those rows only. Without it
    every row moves (TF1 applies lookup gradients densely)."""
    (b1, b2), eps = ADAM_BETAS, ADAM_EPS
    m, v, t = state["m"], state["v"], state["t"]
    t.add_(1.0)
    new_m = b1 * m + (1 - b1) * grad
    new_v = b2 * v + (1 - b2) * grad * grad
    lr_t = lr * torch.sqrt(1 - b2**t) / (1 - b1**t)
    if row_mask is None:
        m.copy_(new_m)
        v.copy_(new_v)
        param.sub_(lr_t * m / (torch.sqrt(v) + eps))
    else:
        rows = (row_mask > 0)[:, None]
        m.copy_(torch.where(rows, new_m, m))
        v.copy_(torch.where(rows, new_v, v))
        param.sub_(torch.where(rows, lr_t * m / (torch.sqrt(v) + eps), 0.0))


def mf_generator_epoch(
    params: nn.Module, d_opt: torch.optim.Optimizer, item_opt: torch.optim.Optimizer,
    user_state: Dict[str, torch.Tensor], urm: Union[torch.Tensor, PaddedCSR],
    perm: torch.Tensor, weights: torch.Tensor, d_loss_fn: Callable, g_loss_fn: Callable,
    *, g_lr: float, n_batches: int, batch_size: int, d_steps: int, g_steps: int,
    lazy_user_adam: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The epoch of an MF generator against a discriminator, in place: GANMF's
    and DisGANMF's (JAX ganmf.py:138-222, disganmf.py:139-221), which differ
    only in their losses. ``d_steps * n_batches`` D minibatches step D with
    ``d_opt``, then ``g_steps * n_batches`` G minibatches step the item
    embeddings with ``item_opt`` and the user embeddings with ``tf1_adam_``
    at ``g_lr``. ``d_loss_fn(uids, real, w)`` and ``g_loss_fn`` give one
    minibatch's losses. Returns the mean losses as device scalars. Under
    ``GANMF_TPU_DEBUG`` each step's loss and updated tensors are checked for
    NaN (one host read a step); otherwise the epoch never reads the device.
    Each minibatch is a ``train.d_step`` or ``train.g_step`` span with three
    children: ``train.rows`` (the batch's rows), ``train.grad`` (the loss and
    its gradient) and ``train.update`` (the optimizer steps)."""
    n_cols = params.item_emb.shape[0]
    d_params, g_params = params.d_params(), params.g_params()
    debug = debug_enabled()
    names = {id(p): n for n, p in params.named_parameters()}

    def batch(step):
        lo = (step % n_batches) * batch_size
        uids, w = perm[lo : lo + batch_size], weights[lo : lo + batch_size]
        if isinstance(urm, PaddedCSR):
            return uids, padded_rows_dense(urm, uids, n_cols), w
        return uids, urm.index_select(0, uids), w

    d_sum = torch.zeros((), dtype=torch.float32, device=perm.device)
    for step in range(d_steps * n_batches):
        with span("train.d_step"):
            with span("train.rows"):
                rows = batch(step)
            with span("train.grad"):
                loss = d_loss_fn(*rows)
                grads = torch.autograd.grad(loss, d_params)
            with span("train.update"):
                apply_grads(d_opt, d_params, grads)
            if debug:
                raise_on_nan(f"D step {step}", loss=loss, **{names[id(p)]: p for p in d_params})
            d_sum += loss.detach()

    g_sum = torch.zeros((), dtype=torch.float32, device=perm.device)
    user_emb, item_emb = g_params
    for step in range(g_steps * n_batches):
        with span("train.g_step"):
            with span("train.rows"):
                uids, real, w = batch(step)
            with span("train.grad"):
                loss = g_loss_fn(uids, real, w)
                g_user, g_item = torch.autograd.grad(loss, g_params)
            with span("train.update"):
                row_mask = None
                if lazy_user_adam:
                    row_mask = torch.zeros(user_emb.shape[0], dtype=torch.float32, device=w.device)
                    row_mask.scatter_reduce_(0, uids, w, reduce="amax")
                tf1_adam_(user_emb, g_user, user_state, g_lr, row_mask)
                apply_grads(item_opt, [item_emb], [g_item])
            if debug:
                raise_on_nan(f"G step {step}", loss=loss, user_emb=user_emb, item_emb=item_emb)
            g_sum += loss.detach()

    d_opt.zero_grad(set_to_none=True)
    item_opt.zero_grad(set_to_none=True)
    return d_sum / (n_batches * d_steps), g_sum / (n_batches * g_steps)


def ganmf_epoch(
    params: "GANMFParams", d_opt: torch.optim.Optimizer, item_opt: torch.optim.Optimizer,
    user_state: Dict[str, torch.Tensor], urm: Union[torch.Tensor, PaddedCSR],
    perm: torch.Tensor, weights: torch.Tensor,
    *, g_lr: float, m: float, recon_coefficient: float, d_reg: float, g_reg: float,
    n_batches: int, batch_size: int, d_steps: int, g_steps: int,
    lazy_user_adam: bool = False, compute_dtype: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch, in place (JAX :138-222); returns the mean D and G losses as
    device scalars, with no read to the host.

    ``perm`` holds the epoch's shuffled padded row ids and ``weights`` 1 for
    real rows, 0 for padding (both on the device, ``n_batches * batch_size``
    long). ``urm`` is the training-orientation URM, dense [rows, cols] or
    padded CSR (each batch densified on the device), in bfloat16 for
    ``compute_dtype="bf16"``. ``d_opt`` is Adam over D's four tensors with
    d_lr, ``item_opt`` Adam over the item embeddings with g_lr; the user
    embeddings step with ``tf1_adam_`` at ``g_lr``, state ``user_state``."""
    cd = torch.bfloat16 if compute_dtype == "bf16" else None
    return mf_generator_epoch(
        params, d_opt, item_opt, user_state, urm, perm, weights,
        lambda uids, real, w: d_loss(params, uids, real, w, m, d_reg, cd),
        lambda uids, real, w: g_loss(params, uids, real, w, recon_coefficient, g_reg, cd),
        g_lr=g_lr, n_batches=n_batches, batch_size=batch_size, d_steps=d_steps, g_steps=g_steps,
        lazy_user_adam=lazy_user_adam)


#: the training state's optimizers (key, index of their first parameter) and
#: TF1 Adam's moments (key, parameter index); ``parameters()`` is user_emb,
#: item_emb, then D's tensors
_MESH_STATE = ((("d_state", 2), ("item_state", 1)), (("user_state", 0),))


class MFGeneratorRecommender(AdversarialRecommender):
    """What GANMF and DisGANMF share: the MF generator's URM storage,
    optimizers, shuffle stream and crash-resume state, and its scores, the
    factor product, ranked through K1."""

    def _training_urm(self, urm_storage: str, compute_dtype: str, layout=None):
        """(URM in training orientation, (rows, cols)): dense on the device,
        or its padded-CSR planes for ``urm_storage="csr"``, in bfloat16 for
        ``compute_dtype="bf16"``. With a mesh ``layout``
        (``parallel.distributed.ShardLayout``) only this rank's shard goes to
        the device: its rows and item columns of the dense URM, or its rows'
        padded-CSR planes."""
        if compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"compute_dtype must be 'f32' or 'bf16', got {compute_dtype!r}")
        train_csr = self._train_matrix()
        rows = train_csr if layout is None else train_csr[layout.r0 : layout.r1]
        if urm_storage == "csr":
            urm = padded_csr_from_sparse(rows, self.device)
            if compute_dtype == "bf16":
                urm = urm._replace(val=urm.val.to(torch.bfloat16))
        elif urm_storage == "dense":
            if layout is None:
                urm = self._train_dense()
            else:
                urm = dense_from_sparse(rows[:, layout.i0 : layout.i1], self.device)
            if compute_dtype == "bf16":
                urm = urm.to(torch.bfloat16)
        else:
            raise ValueError(f"urm_storage must be 'dense' or 'csr', got {urm_storage!r}")
        self._stream_seen = urm_storage == "csr"
        return urm, train_csr.shape

    def _fit_generator(self, n_rows: int, batch_size: int, d_lr: float, g_lr: float,
                       run_epoch: Callable, epochs, loop_args):
        """Make the optimizers, resume from a checkpoint, and run the training
        loop: each epoch draws its permutation from the numpy shuffle stream
        seeded with ``seed`` and calls ``run_epoch(perm, weights, n_batches)``
        with both on the device. Returns the loop's value."""
        self._d_opt = torch.optim.Adam(self.params.d_params(), lr=d_lr, betas=ADAM_BETAS, eps=ADAM_EPS)
        self._item_opt = torch.optim.Adam([self.params.item_emb], lr=g_lr, betas=ADAM_BETAS, eps=ADAM_EPS)
        self._user_adam = user_adam_state(self.params.user_emb)
        start_epoch = self.resume_from_checkpoint()

        n_batches, padded = make_batches(n_rows, int(batch_size))
        weights = torch.from_numpy(padded_weights(n_rows, padded)).to(self.device)
        rng = np.random.RandomState(self.seed)
        # fast-forward the shuffle stream past the completed epochs, so that a
        # resumed run continues the uninterrupted run's permutations
        for _ in range(start_epoch - 1):
            shuffled_padded_perm(rng, n_rows, padded)

        def epoch_fn(epoch):
            # the epoch's permutation goes to the device once, before its steps
            with span("train.shuffle"):
                perm = to_device(shuffled_padded_perm(rng, n_rows, padded), self.device, "train.shuffle",
                                 torch.int64)
            run_epoch(perm, weights, n_batches)

        result = self._run_training_loop(epochs, *loop_args, epoch_fn=epoch_fn, start_epoch=start_epoch)
        self._invalidate_device_cache()
        return result

    # -- crash resume (full training state) -----------------------------------
    def _checkpoint_state(self):
        """The training state; on a mesh its full tensors, gathered from the
        shards (a collective), so that a checkpoint resumes on any plan."""
        state = {
            "params": self.params.state_dict(),
            "d_state": self._d_opt.state_dict(),
            "item_state": self._item_opt.state_dict(),
            "user_state": dict(self._user_adam),
        }
        if self.mesh_plan is not None:
            from ganmf_tpu_torch.parallel.distributed import gather_module_state

            state = gather_module_state(state, self.params, self.mesh_plan, *_MESH_STATE)
        return state

    def _restore_checkpoint_state(self, state):
        if self.mesh_plan is not None:
            from ganmf_tpu_torch.parallel.distributed import shard_module_state

            state = shard_module_state(state, self.params, self.mesh_plan, *_MESH_STATE)
        self.params.load_state_dict(state["params"])
        self._d_opt.load_state_dict(state["d_state"])
        self._item_opt.load_state_dict(state["item_state"])
        for name, value in state["user_state"].items():
            self._user_adam[name].copy_(value)

    def _require_params(self) -> nn.Module:
        """The full parameters: on a mesh-trained model gathered from the
        shards, a collective that every rank calls."""
        if self.params is None:
            raise RuntimeError(f"{self.RECOMMENDER_NAME} has no parameters: fit it or load them first")
        return self._full_params()

    def _factors_device(self):
        """(U, V, cold) with scores = U @ V^T for external users. In item mode
        the model was trained on URM^T, so external users are the rows of
        item_emb and external items those of user_emb (JAX :359-363).

        GANMF and DisGANMF never mask cold users (their JAX score_device does
        not, unlike the MF base at ganmf_tpu/models/base.py:606-618), so every
        user is reported warm: otherwise K1 would drop cold-in-train users
        that the JAX dense path ranks."""
        p = self._require_params()
        if self.mode == "item":
            U, V = p.item_emb, p.user_emb
        else:
            U, V = p.user_emb, p.item_emb
        cold = torch.zeros(self.n_users, dtype=torch.bool, device=self.device)
        return U.detach(), V.detach(), cold

    @torch.no_grad()
    def score_device(self, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, I] scores for external users, in both modes."""
        U, V, _ = self._factors_device()
        return U.index_select(0, user_ids) @ V.T

    # -- introspection (reference GANMF.py:294-307) ---------------------------
    def user_factors(self) -> np.ndarray:
        return self._require_params().user_emb.detach().cpu().numpy()

    def item_factors(self) -> np.ndarray:
        return self._require_params().item_emb.detach().cpu().numpy()


class GANMF(MFGeneratorRecommender):
    RECOMMENDER_NAME = "GANMF"

    def fit(
        self,
        num_factors: int = 10,
        emb_dim: int = 32,
        epochs: int = 300,
        batch_size: int = 32,
        d_lr: float = 1e-4,
        g_lr: float = 1e-4,
        d_steps: int = 1,
        g_steps: int = 1,
        d_reg: float = 0,
        g_reg: float = 0,
        m: float = 1,
        recon_coefficient: float = 1e-2,
        allow_worse=None,
        freq=None,
        after: int = 0,
        metrics=("MAP",),
        sample_every=None,
        validation_evaluator=None,
        validation_set=None,
        lazy_user_adam: bool = False,
        mesh_plan=None,
        urm_storage: str = "dense",
        compute_dtype: str = "f32",
    ):
        """Train on the training matrix (JAX :228-345). Returns the
        reference's fit() value: the last epoch run when early stopping
        stopped the fit, else ``epochs + 1``.

        ``urm_storage``: "dense" keeps the [rows, cols] URM on the device;
        "csr" keeps only its padded-CSR planes (O(nnz)) and densifies each
        [B, cols] minibatch on the device. ``compute_dtype="bf16"`` runs the
        matmuls and activations in bfloat16 against float32 parameters.

        ``mesh_plan`` (``parallel.make_mesh``'s plan, on the model's device)
        trains on a mesh: every rank calls ``fit``, holds its shards of the
        URM and the parameters (JAX :293-303) and runs the sharded epoch;
        the full initial weights are made the same on every rank and each
        keeps its slice. Only rank 0 logs, prints and writes checkpoints."""
        layout = None
        if mesh_plan is not None:
            from ganmf_tpu_torch.parallel.distributed import ShardLayout

            if mesh_plan.device != self.device:
                raise ValueError(f"model on {self.device}, its mesh plan on {mesh_plan.device}")
            layout = ShardLayout(mesh_plan, *self._train_matrix().shape)
        urm, (n_rows, n_cols) = self._training_urm(urm_storage, compute_dtype, layout)
        self.config = dict(
            num_factors=num_factors, emb_dim=emb_dim, epochs=epochs, batch_size=batch_size,
            d_lr=d_lr, g_lr=g_lr, d_steps=d_steps, g_steps=g_steps, d_reg=d_reg, g_reg=g_reg,
            m=m, recon_coefficient=recon_coefficient,
        )
        self.num_factors = int(num_factors)
        self.emb_dim = int(emb_dim)
        generator = torch.Generator().manual_seed(self.seed)
        self.mesh_plan = mesh_plan
        if mesh_plan is None:
            self.params = init_params(n_rows, n_cols, self.num_factors, self.emb_dim, generator, self.device)
            epoch, lead = ganmf_epoch, ()
        else:
            from ganmf_tpu_torch.parallel.distributed import shard_ganmf_params, sharded_ganmf_epoch

            full = init_params(n_rows, n_cols, self.num_factors, self.emb_dim, generator, torch.device("cpu"))
            self.params = shard_ganmf_params(full, mesh_plan)
            epoch, lead = sharded_ganmf_epoch, (layout,)
        # resume (in _fit_generator) restores the loss histories
        self.train_d_loss, self.train_g_loss = [], []

        def run_epoch(perm, weights, n_batches):
            dl, gl = epoch(
                *lead, self.params, self._d_opt, self._item_opt, self._user_adam, urm, perm, weights,
                g_lr=float(g_lr), m=float(m), recon_coefficient=float(recon_coefficient),
                d_reg=float(d_reg), g_reg=float(g_reg), n_batches=n_batches,
                batch_size=int(batch_size), d_steps=int(d_steps), g_steps=int(g_steps),
                lazy_user_adam=bool(lazy_user_adam), compute_dtype=compute_dtype,
            )
            # device scalars: reading them would wait for the epoch
            self.train_d_loss.append(dl)
            self.train_g_loss.append(gl)

        return self._fit_generator(
            n_rows, batch_size, d_lr, g_lr, run_epoch, epochs,
            (validation_evaluator, validation_set, sample_every, allow_worse, freq, list(metrics), after))

    @torch.no_grad()
    def autoencoder_codes(self) -> np.ndarray:
        enc, _ = self._require_params().autoencode(self._train_dense())
        return enc.cpu().numpy()

    # -- persistence ----------------------------------------------------------
    def loadModel(self, folder_path, file_name=None):
        """Load a zip written by this port's or the JAX package's saveModel,
        and rebuild the parameters from it."""
        data = super().loadModel(folder_path, file_name)
        if "param_0" in data:
            self.params = params_from_jax(data, self.device)
            self.mesh_plan = None  # the full parameters
        return data
