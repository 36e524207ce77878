"""GANMF: GAN-based matrix factorization (the paper's model), serving side.

Port of ganmf_tpu/models/ganmf.py:40-73,356-378. The generator is plain MF
(user and item embedding tables); the discriminator is a one-hidden-layer
autoencoder over profiles. Scores are the generator's factor product, so the
port ranks GANMF through the fused scorer K1 (its ``_factors_device``), where
the JAX package ranks its dense score block with ``lax.top_k``; the lists and
metrics are the same. Training (the epoch and ``fit``) is not ported yet.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Sequence, Union

import numpy as np
import torch
from torch import nn

from ganmf_tpu_torch.models.gan_base import AdversarialRecommender

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

    def autoencode(self, x: torch.Tensor):
        enc = x @ self.enc_w + self.enc_b
        dec = enc @ self.dec_w + self.dec_b
        return enc, dec


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


class GANMF(AdversarialRecommender):
    RECOMMENDER_NAME = "GANMF"

    def fit(self, *args, **kwargs):
        raise NotImplementedError(
            "GANMF training is not ported yet: set params (init_params, params_from_jax or loadModel)")

    def _require_params(self) -> GANMFParams:
        if self.params is None:
            raise RuntimeError("GANMF has no parameters: fit it or load them first")
        return self.params

    def _factors_device(self):
        """(U, V, cold) with scores = U @ V^T for external users. In item mode
        the model was trained on URM^T, so external users are the rows of
        item_emb and external items those of user_emb (JAX :359-363).

        GANMF never masks cold users (its JAX score_device does not, unlike
        the MF base at ganmf_tpu/models/base.py:606-618), so every user is
        reported warm: otherwise K1 would drop cold-in-train users that the
        JAX dense path ranks."""
        p = self._require_params()
        if self.mode == "item":
            U, V = p.item_emb, p.user_emb
        else:
            U, V = p.user_emb, p.item_emb
        cold = torch.zeros(self.n_users, dtype=torch.bool, device=self.device)
        return U.detach(), V.detach(), cold

    # -- scoring (reference GANMF.py:285-292) ---------------------------------
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
        return data
