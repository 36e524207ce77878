"""GANMF's six tensors for the cells that serve and evaluate a trained model.

No training runs in those cells' set-up: the tensors are made on the device
from the seed, in the layouts of the JAX package's ``GANMFParams``
(user_emb [U, K], item_emb [I, K], enc_w [I, E], enc_b [E], dec_w [E, I],
dec_b [I]). The embeddings are given the shape a trained model's have: a
user and an item of one taste cluster share a direction, so that a user's
own cluster ranks first and the held-out items rank high, and the metrics of
an evaluation are far from zero. The autoencoder takes Glorot-uniform
weights and zero biases, as the program's initialisation does.
"""

from __future__ import annotations

import math
from typing import List

import torch

from benchmark.data import derive_seed

#: the weight of an embedding's own noise against its cluster's direction
NOISE = 0.7


def make(n_users: int, n_items: int, num_factors: int, emb_dim: int, user_cluster: torch.Tensor,
         item_cluster: torch.Tensor, seed: int, device: torch.device) -> List[torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, 1))
    K, E = num_factors, emb_dim
    n_clusters = int(max(int(user_cluster.max()), int(item_cluster.max()))) + 1
    centres = torch.randn((n_clusters, K), generator=g, device=device)
    noise = torch.randn((n_users + n_items, K), generator=g, device=device)
    scale = 1.0 / math.sqrt(K)
    user_emb = (centres.index_select(0, user_cluster) + NOISE * noise[:n_users]) * scale
    item_emb = (centres.index_select(0, item_cluster) + NOISE * noise[n_users:]) * scale
    limit = math.sqrt(6.0 / (n_items + E))
    ae = torch.rand((2, n_items * E), generator=g, device=device) * (2 * limit) - limit
    return [user_emb.contiguous(), item_emb.contiguous(), ae[0].view(n_items, E), torch.zeros(E, device=device),
            ae[1].view(E, n_items), torch.zeros(n_items, device=device)]
