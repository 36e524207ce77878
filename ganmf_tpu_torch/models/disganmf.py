"""DisGANMF: GANMF's MF generator against an MLP binary discriminator.

Port of ganmf_tpu/models/disganmf.py. D is an MLP over concat(float(raw row
id), profile) with ``d_layers`` hidden layers of ``d_nodes`` and a linear
1-unit output; its features are the last hidden layer. G is GANMF's MF
generator:

    dloss = BCE(D(real) -> 1) + BCE(D(fake) -> 0) + d_reg * L2(D)
    gloss = BCE(D(fake) -> 0) + recon_coefficient * MSE(real_feat, fake_feat) + g_reg * L2(G)

(the generator reuses the fake -> 0 term verbatim, as the reference does; the
feature-matching MSE carries its learning signal). The epoch is GANMF's loop
(``ganmf.mf_generator_epoch``) with these losses: ``torch.optim.Adam`` for D
and the item embeddings, TF1's Adam (``tf1_adam_``) for the user embeddings,
lazy by default in user mode and dense in item mode. ``fit`` keeps no loss
histories, as the JAX fit does not.

Scores are the generator's factor product, so DisGANMF ranks through K1 with
every user warm, as GANMF does.

``fit(mesh_plan=...)`` trains on a mesh of ranks, each holding its shards as
``parallel.distributed.shard_disganmf_params`` places them, through
``parallel.adversarial.sharded_disganmf_epoch``; as for GANMF, every rank
calls ``fit`` and what follows, and ``_factors_device``, ``score_device`` and
the introspection methods gather the shards (the mesh evaluator then ranks
each item shard through K1).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganmf_tpu_torch.data.device import PaddedCSR
from ganmf_tpu_torch.models.cfgan import ACTIVATIONS
from ganmf_tpu_torch.models.ganmf import (
    MFGeneratorRecommender,
    _cast,
    _fake,
    _glorot_uniform,
    _l2,
    _masked_mse,
    mf_generator_epoch,
)


class DisGANMFParams(nn.Module):
    """The generator's embeddings and D's MLP, in the JAX NamedTuple's field
    order (user_emb [U, K], item_emb [I, K], d_ws, d_bs, out_w [nodes, 1],
    out_b [1]), which is the order of ``parameters()`` and of the saveModel
    ``param_i`` numbering (a module yields its own parameters before its
    children's, so the output layer is a child too). D's first kernel is
    [I + 1, nodes]: its row 0 takes the row id."""

    def __init__(self, user_emb, item_emb, d_ws: Sequence[torch.Tensor], d_bs: Sequence[torch.Tensor],
                 out_w, out_b):
        super().__init__()
        self.user_emb = nn.Parameter(user_emb)
        self.item_emb = nn.Parameter(item_emb)
        self.d_ws = nn.ParameterList([nn.Parameter(w) for w in d_ws])
        self.d_bs = nn.ParameterList([nn.Parameter(b) for b in d_bs])
        self.out = nn.ParameterList([nn.Parameter(out_w), nn.Parameter(out_b)])

    @property
    def out_w(self) -> nn.Parameter:
        return self.out[0]

    @property
    def out_b(self) -> nn.Parameter:
        return self.out[1]

    def g_params(self):
        return [self.user_emb, self.item_emb]

    def d_params(self):
        return [*self.d_ws, *self.d_bs, self.out_w, self.out_b]


def init_params(n_rows: int, n_cols: int, num_factors: int, d_layers: int, d_nodes: int,
                generator: torch.Generator, device: torch.device) -> DisGANMFParams:
    """Glorot-uniform kernels and embeddings, zero biases (JAX :69-85), drawn
    on the host from ``generator`` (a CPU generator), so that a seed gives the
    same weights on every device."""
    d_ws, d_bs, fan_in = [], [], n_cols + 1  # concat(row id, profile)
    for _ in range(d_layers):
        d_ws.append(_glorot_uniform((fan_in, d_nodes), generator))
        d_bs.append(torch.zeros(d_nodes))
        fan_in = d_nodes
    return DisGANMFParams(
        user_emb=_glorot_uniform((n_rows, num_factors), generator),
        item_emb=_glorot_uniform((n_cols, num_factors), generator),
        d_ws=d_ws, d_bs=d_bs,
        out_w=_glorot_uniform((fan_in, 1), generator),
        out_b=torch.zeros(1),
    ).to(device)


def params_from_jax(arrays: Union[Sequence[np.ndarray], Mapping], device: torch.device) -> DisGANMFParams:
    """The port's parameters from the JAX ones: the leaves in ``tree_flatten``
    order (user_emb, item_emb, d_ws..., d_bs..., out_w, out_b), or the
    ``param_0..param_n`` dict a JAX ``saveModel`` writes."""
    if isinstance(arrays, Mapping):
        n = sum(1 for name in arrays if str(name).startswith("param_"))
        arrays = [arrays[f"param_{i}"] for i in range(n)]
    if len(arrays) < 6 or len(arrays) % 2:
        raise ValueError(f"{len(arrays)} arrays do not make DisGANMF's parameters")
    t = [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]
    layers = (len(t) - 4) // 2
    return DisGANMFParams(t[0], t[1], t[2 : 2 + layers], t[2 + layers : 2 + 2 * layers],
                          t[-2], t[-1]).to(device)


def _discriminate(p: DisGANMFParams, uids: torch.Tensor, x: torch.Tensor, act,
                  dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features, logits [B, 1]) of D over concat(float(uid), x) (JAX
    :96-115). With ``dtype=torch.bfloat16`` D's weights are rounded to
    bfloat16, as the JAX package casts the whole parameter tree, but only the
    [B, I] profile product runs in bfloat16: the id column, whose raw value
    bf16 would merge with its 16-32 neighbours, and every [B, nodes] layer
    stay float32."""
    ws, bs = list(p.d_ws), list(p.d_bs)
    out_w, out_b = p.out_w, p.out_b
    if dtype is not None:
        ws, bs = [w.to(dtype).float() for w in ws], [b.to(dtype).float() for b in bs]
        out_w, out_b = out_w.to(dtype).float(), out_b.to(dtype).float()
        w0 = p.d_ws[0].to(dtype)
        id_part = uids[:, None].float() * ws[0][0:1, :]
        h = act((x @ w0[1:, :]).float() + id_part + bs[0])
        layers = zip(ws[1:], bs[1:])
    else:
        h = torch.cat([uids[:, None].to(x.dtype), x], dim=1)
        layers = zip(ws, bs)
    for w, b in layers:
        h = act(h @ w + b)
    return h, h @ out_w + out_b


def _bce(logits: torch.Tensor, target: float, w: torch.Tensor) -> torch.Tensor:
    """optax's sigmoid_binary_cross_entropy, -t log s(x) - (1 - t) log s(-x),
    weighted over the valid rows and reduced in float32 (JAX :118-123)."""
    lg = logits[:, 0].float()
    per = -target * F.logsigmoid(lg) - (1.0 - target) * F.logsigmoid(-lg)
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def d_loss(p: DisGANMFParams, uids, real, w, d_reg: float, act,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """D's loss on one minibatch (JAX :173); G takes no gradient."""
    real = real if dtype is None else real.to(dtype)
    with torch.no_grad():
        fake = _fake(_cast(p.g_params(), dtype), uids)
    loss = (_bce(_discriminate(p, uids, real, act, dtype)[1], 1.0, w)
            + _bce(_discriminate(p, uids, fake, act, dtype)[1], 0.0, w))
    if d_reg:
        loss = loss + d_reg * _l2(p.d_params())
    return loss


def g_loss(p: DisGANMFParams, uids, real, w, recon_coefficient: float, g_reg: float, act,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """G's loss on one minibatch (JAX :174), through the frozen D."""
    real = real if dtype is None else real.to(dtype)
    fake_feat, fake_out = _discriminate(p, uids, _fake(_cast(p.g_params(), dtype), uids), act, dtype)
    with torch.no_grad():
        real_feat, _ = _discriminate(p, uids, real, act, dtype)
    loss = _bce(fake_out, 0.0, w) + recon_coefficient * _masked_mse(real_feat, fake_feat, w)
    if g_reg:
        loss = loss + g_reg * _l2(p.g_params())
    return loss


def disganmf_epoch(
    params: DisGANMFParams, d_opt: torch.optim.Optimizer, item_opt: torch.optim.Optimizer,
    user_state: Dict[str, torch.Tensor], urm: Union[torch.Tensor, PaddedCSR],
    perm: torch.Tensor, weights: torch.Tensor,
    *, g_lr: float, recon_coefficient: float, d_reg: float, g_reg: float,
    n_batches: int, batch_size: int, d_steps: int, g_steps: int, d_hidden_act: str,
    lazy_user_adam: bool = True, compute_dtype: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch, in place (JAX :139-221), with the inputs of
    ``ganmf.ganmf_epoch``; returns the mean D and G losses as device
    scalars. ``d_opt`` is Adam over D's tensors with d_lr."""
    act = ACTIVATIONS[d_hidden_act]
    cd = torch.bfloat16 if compute_dtype == "bf16" else None
    return mf_generator_epoch(
        params, d_opt, item_opt, user_state, urm, perm, weights,
        lambda uids, real, w: d_loss(params, uids, real, w, d_reg, act, cd),
        lambda uids, real, w: g_loss(params, uids, real, w, recon_coefficient, g_reg, act, cd),
        g_lr=g_lr, n_batches=n_batches, batch_size=batch_size, d_steps=d_steps, g_steps=g_steps,
        lazy_user_adam=lazy_user_adam)


class DisGANMF(MFGeneratorRecommender):
    RECOMMENDER_NAME = "DisGANMF"

    def fit(
        self,
        num_factors: int = 10,
        d_layers: int = 1,
        d_nodes: int = 32,
        d_hidden_act: str = "linear",
        epochs: int = 300,
        batch_size: int = 32,
        d_lr: float = 1e-4,
        g_lr: float = 1e-4,
        d_steps: int = 1,
        g_steps: int = 1,
        d_reg: float = 0,
        g_reg: float = 0,
        recon_coefficient: float = 1e-2,
        allow_worse=None,
        freq=None,
        after: int = 0,
        metrics=("MAP",),
        sample_every=None,
        validation_evaluator=None,
        validation_set=None,
        lazy_user_adam=None,
        mesh_plan=None,
        urm_storage: str = "dense",
        compute_dtype: str = "f32",
    ):
        """Train on the training matrix (JAX :227-328), with GANMF's
        ``urm_storage`` and ``compute_dtype``. ``lazy_user_adam=None`` means
        TF1's lazy Adam in user mode and its dense form in item mode
        (:260-261). Returns the reference's fit() value. ``mesh_plan``
        trains on a mesh, as ``GANMF.fit`` does (JAX :287-294)."""
        if d_hidden_act not in ACTIVATIONS:
            raise ValueError(f"d_hidden_act must be one of {sorted(ACTIVATIONS)}, got {d_hidden_act!r}")
        if lazy_user_adam is None:
            lazy_user_adam = self.mode == "user"
        layout = None
        if mesh_plan is not None:
            from ganmf_tpu_torch.parallel.distributed import ShardLayout

            if mesh_plan.device != self.device:
                raise ValueError(f"model on {self.device}, its mesh plan on {mesh_plan.device}")
            layout = ShardLayout(mesh_plan, *self._train_matrix().shape)
        urm, (n_rows, n_cols) = self._training_urm(urm_storage, compute_dtype, layout)
        self.config = dict(
            num_factors=num_factors, d_layers=d_layers, d_nodes=d_nodes, d_hidden_act=d_hidden_act,
            epochs=epochs, batch_size=batch_size, d_lr=d_lr, g_lr=g_lr, d_steps=d_steps,
            g_steps=g_steps, d_reg=d_reg, g_reg=g_reg, recon_coefficient=recon_coefficient,
        )
        generator = torch.Generator().manual_seed(self.seed)
        self.mesh_plan = mesh_plan
        if mesh_plan is None:
            self.params = init_params(n_rows, n_cols, int(num_factors), int(d_layers), int(d_nodes), generator,
                                      self.device)
            epoch, lead = disganmf_epoch, ()
        else:
            from ganmf_tpu_torch.parallel.adversarial import sharded_disganmf_epoch
            from ganmf_tpu_torch.parallel.distributed import shard_disganmf_params

            full = init_params(n_rows, n_cols, int(num_factors), int(d_layers), int(d_nodes), generator,
                               torch.device("cpu"))
            self.params = shard_disganmf_params(full, mesh_plan)
            epoch, lead = sharded_disganmf_epoch, (layout,)

        def run_epoch(perm, weights, n_batches):
            # the epoch's losses are dropped, as the JAX fit drops them (:314)
            epoch(
                *lead, self.params, self._d_opt, self._item_opt, self._user_adam, urm, perm, weights,
                g_lr=float(g_lr), recon_coefficient=float(recon_coefficient), d_reg=float(d_reg),
                g_reg=float(g_reg), n_batches=n_batches, batch_size=int(batch_size),
                d_steps=int(d_steps), g_steps=int(g_steps), d_hidden_act=d_hidden_act,
                lazy_user_adam=bool(lazy_user_adam), compute_dtype=compute_dtype,
            )

        return self._fit_generator(
            n_rows, batch_size, d_lr, g_lr, run_epoch, epochs,
            (validation_evaluator, validation_set, sample_every, allow_worse, freq, list(metrics), after))

    # -- persistence ----------------------------------------------------------
    def loadModel(self, folder_path, file_name=None):
        """Load a zip written by this port's or the JAX package's saveModel,
        and rebuild the parameters from it."""
        data = super().loadModel(folder_path, file_name)
        if "param_0" in data:
            self.params = params_from_jax(data, self.device)
            self.mesh_plan = None  # the full parameters
        return data
