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

Not ported: ``urm_storage="csr"`` (per-row keyed draws inside the epoch, which
need a counter-based generator of their own) and ``mesh_plan``.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganmf_tpu_torch.data.device import dense_from_sparse
from ganmf_tpu_torch.models.gan_base import (  # noqa: F401  (ADAM_* re-exported)
    ADAM_BETAS,
    ADAM_EPS,
    AdversarialRecommender,
    apply_grads,
    make_batches,
    padded_weights,
)
from ganmf_tpu_torch.ops.topk import smallest_k_mask

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


def sample_negative_masks(urm: torch.Tensor, zr_ratio: float, zp_ratio: float, scheme: str, *,
                          uniforms: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]):
    """Per-row exact-k without-replacement negative samples (JAX :90-113).

    ``uniforms`` is the (ZR, PM) pair of [R, I] float32 draws in [0, 1); the
    one a scheme does not use may be None. For each row,
    k_u = int(n_zeros * ratio) of its non-interactions are selected: those
    with the smallest keys, interactions keyed +inf. The product is taken in
    float32 and truncated, as JAX does with its float32 ratio; float64 gives
    another k_u for some pairs (12827 * 0.4515475140394092 is 5792 in
    float32, 5791 in float64)."""
    interacted = urm != 0
    n_zeros = (~interacted).sum(1).to(torch.float32)

    def draw(u, ratio):
        keys = torch.where(interacted, float("inf"), u)
        k_u = (n_zeros * torch.tensor(ratio, dtype=torch.float32, device=urm.device)).to(torch.int32)
        return smallest_k_mask(keys, k_u).to(urm.dtype)

    u_zr, u_pm = uniforms
    zr = draw(u_zr, zr_ratio) if scheme in ("ZP", "ZR") else torch.zeros_like(urm)
    pm = draw(u_pm, zp_ratio) if scheme in ("ZP", "PM") else torch.zeros_like(urm)
    return zr, pm


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
    urm: torch.Tensor, uniforms, d_weights: torch.Tensor, g_weights: torch.Tensor,
    *, d_reg: float, g_reg: float, zr_ratio: float, zp_ratio: float, zr_coefficient: float,
    scheme: str, d_hidden_act: str, g_hidden_act: str,
    d_n_batches: int, d_batch: int, g_n_batches: int, g_batch: int, d_steps: int, g_steps: int,
    compute_dtype: str = "f32",
) -> None:
    """One epoch, in place (JAX :124-230, dense storage): the masks, then
    ``d_steps * d_n_batches`` D minibatches, then ``g_steps * g_n_batches`` G
    minibatches, each in natural row order. ``d_opt`` and ``g_opt`` are Adam
    over D's and G's parameters with the learning rates; L2 is in the loss.
    ``compute_dtype="bf16"`` runs activations and matmuls in bfloat16 against
    the f32 parameters (``urm`` is then bf16 too); losses and L2 stay f32."""
    cd = torch.bfloat16 if compute_dtype == "bf16" else None
    G, D = params.G, params.D
    d_params, g_params = list(D.parameters()), list(G.parameters())

    zr_full, pm_full = sample_negative_masks(urm, zr_ratio, zp_ratio, scheme, uniforms=uniforms)
    # train mask: profile with PM-sampled negatives flipped to 1 (CFGAN.py:242-249)
    train_full = torch.clamp(urm + pm_full, 0.0, 1.0) if scheme in ("ZP", "PM") else urm

    for step in range(d_steps * d_n_batches):
        b = (step % d_n_batches) * d_batch
        cond, tmask, w = urm[b : b + d_batch], train_full[b : b + d_batch], d_weights[b : b + d_batch]
        loss = d_loss(D, G, cond, tmask, w, d_reg, d_hidden_act, g_hidden_act, cd)
        apply_grads(d_opt, d_params, torch.autograd.grad(loss, d_params))

    for step in range(g_steps * g_n_batches):
        b = (step % g_n_batches) * g_batch
        cond, tmask, w = urm[b : b + g_batch], train_full[b : b + g_batch], g_weights[b : b + g_batch]
        zmask = zr_full[b : b + g_batch]
        loss = g_loss(G, D, cond, tmask, zmask, w, g_reg, zr_coefficient, d_hidden_act, g_hidden_act, cd)
        apply_grads(g_opt, g_params, torch.autograd.grad(loss, g_params))

    d_opt.zero_grad(set_to_none=True)
    g_opt.zero_grad(set_to_none=True)


class CFGAN(AdversarialRecommender):
    RECOMMENDER_NAME = "CFGAN"

    @property
    def params(self) -> Optional[CFGANParams]:
        return self._params

    @params.setter
    def params(self, value: Optional[CFGANParams]) -> None:
        # new parameters drop the cached generator output
        self._params = value
        self._score_cache = None

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
        """Train on the training matrix (JAX :236-360). The URM and the
        per-epoch masks stay dense on the model's device; the masks' uniform
        keys come from a generator on that device seeded with ``seed``.
        ``urm_storage="csr"`` and ``mesh_plan`` are not ported and raise."""
        if urm_storage != "dense":
            raise NotImplementedError(f"urm_storage={urm_storage!r} is not ported; use 'dense'")
        if mesh_plan is not None:
            raise NotImplementedError("mesh_plan is not ported")
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
        urm = torch.zeros((padded, n_cols), dtype=torch.float32, device=self.device)
        urm[:n_rows] = dense_from_sparse(train_csr, self.device)
        if compute_dtype == "bf16":
            urm = urm.to(torch.bfloat16)  # the masks and the condition follow
        weights = torch.from_numpy(padded_weights(n_rows, padded)).to(self.device)

        g_dims = [n_cols] + [int(g_nodes)] * int(g_layers) + [n_cols]
        d_dims = [2 * n_cols] + [int(d_nodes)] * int(d_layers) + [1]
        self.params = init_params(g_dims, d_dims, torch.Generator().manual_seed(self.seed), self.device)
        self._d_opt = torch.optim.Adam(self.params.D.parameters(), lr=d_lr, betas=ADAM_BETAS, eps=ADAM_EPS)
        self._g_opt = torch.optim.Adam(self.params.G.parameters(), lr=g_lr, betas=ADAM_BETAS, eps=ADAM_EPS)
        self._epoch_gen = torch.Generator(device=self.device).manual_seed(self.seed)
        start_epoch = self.resume_from_checkpoint()  # also restores the generator

        def epoch_fn(epoch):
            cfgan_epoch(
                self.params, self._d_opt, self._g_opt, urm,
                self._epoch_uniforms(padded, n_cols, scheme), weights, weights,
                d_reg=d_reg, g_reg=g_reg, zr_ratio=zr_ratio, zp_ratio=zp_ratio,
                zr_coefficient=zr_coefficient, scheme=scheme,
                d_hidden_act=d_hidden_act, g_hidden_act=g_hidden_act,
                d_n_batches=d_n_batches, d_batch=int(d_batch_size),
                g_n_batches=g_n_batches, g_batch=int(g_batch_size),
                d_steps=int(d_steps), g_steps=int(g_steps), compute_dtype=compute_dtype,
            )
            self._score_cache = None

        return self._run_training_loop(
            epochs, validation_evaluator, validation_set, sample_every,
            allow_worse, freq, list(metrics), after, epoch_fn=epoch_fn, start_epoch=start_epoch,
        )

    def _epoch_uniforms(self, n_rows: int, n_cols: int, scheme: str):
        """The epoch's (ZR, PM) uniform keys, [n_rows, n_cols] each, drawn on
        the model's device; None for the mask the scheme does not use."""
        def draw():
            return torch.rand((n_rows, n_cols), generator=self._epoch_gen, device=self.device)

        u_zr = draw() if scheme in ("ZP", "ZR") else None
        u_pm = draw() if scheme in ("ZP", "PM") else None
        return u_zr, u_pm

    # -- crash resume (full training state) -----------------------------------
    def _checkpoint_state(self):
        return {
            "params": self.params.state_dict(),
            "d_state": self._d_opt.state_dict(),
            "g_state": self._g_opt.state_dict(),
            "epoch_gen": self._epoch_gen.get_state(),
        }

    def _restore_checkpoint_state(self, state):
        self.params.load_state_dict(state["params"])
        self._d_opt.load_state_dict(state["d_state"])
        self._g_opt.load_state_dict(state["g_state"])
        self._epoch_gen.set_state(state["epoch_gen"])

    # -- scoring (reference CFGAN.py:342-368) ----------------------------------
    @torch.no_grad()
    def _full_generator_output(self) -> torch.Tensor:
        """G applied to every training-orientation profile, cached until the
        parameters change."""
        if self._score_cache is None:
            if self.params is None or not self.config:
                raise RuntimeError("CFGAN has no parameters: fit it or load them first")
            self._score_cache = _mlp(self.params.G, self._train_dense(), self.config["g_hidden_act"])
        return self._score_cache

    def score_device(self, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, I] scores for external users, in both modes."""
        out = self._full_generator_output()
        if self.mode == "item":
            return out.T.index_select(0, user_ids)
        return out.index_select(0, user_ids)

    # -- persistence ----------------------------------------------------------
    def loadModel(self, folder_path, file_name=None):
        """Load a zip written by this port's or the JAX package's saveModel,
        and rebuild the parameters from it."""
        data = super().loadModel(folder_path, file_name)
        if "param_0" in data:
            self.params = params_from_jax(data, int(data["config"]["g_layers"]), self.device)
        return data
