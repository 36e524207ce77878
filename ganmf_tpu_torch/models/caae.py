"""CAAE: Adversarial Collaborative Auto-Encoder.

Port of ganmf_tpu/models/caae.py (reference GANRec/CAAE.py). Three networks,
all stepped by plain SGD: D, a BPR-style MF discriminator over (user, positive,
negative) triples with an item bias; G, a sigmoid autoencoder trained with a
REINFORCE reward on sampled items plus a masked reconstruction loss; and G', a
second autoencoder with a reward-only loss.

One epoch (``caae_epoch``, JAX :132-396):
- G and G' reconstruct every profile once; their softmaxes give two-level
  inverse-CDF tables (64 buckets) from which every D-phase negative is drawn
  up front;
- the D phase runs ``d_steps * n_d_chunks`` chunks of ``d_bsize``
  interactions, two updates a chunk (with G's negatives, then G''s). The
  three embedding stores live in one [U + I, K + 1] table (the item bias as
  column K); an update gathers its [3B] rows, takes the gradient of the BPR
  loss with respect to them and adds ``-lr * g`` back. The updates are
  serial, as the JAX scan is. ``d_scatter="direct"`` adds with
  ``index_add_``: on the CPU duplicate rows in operand order, as XLA's
  scatter does, and on CUDA by atomics, whose order varies from run to run.
  ``d_scatter="dedup"`` (JAX :266-315) sorts each update's indices once an
  epoch, sums every duplicate run with one cumulative sum and two gathers,
  and scatters over unique indices (a run's first slot takes its row, every
  other slot a scratch row past the table): no two adds meet, so the D phase
  is deterministic on the card too;
- the G phase draws users without replacement, samples the non-interactions
  Nu by Gumbel-top-k with k_u = int(n_nonint * S) (a float32 product), which
  is the exact-k selection K2 (``ops.topk.smallest_k_mask``) over the negated
  keys with the seen items at +inf, and steps G by SGD;
- the G' phase draws users with replacement and steps G' on its reward.

Every random input of an epoch is a ``CAAEDraws``; ``fit`` makes them on the
model's device from one ``torch.Generator`` seeded with ``seed``, whose state
a crash resume restores. The JAX package draws them with ``jax.random``; its
draws can be passed in instead.

Quirks of the reference kept: G' is built with ``g_layers``/``g_units``;
only the first ``n_d_chunks * d_bsize`` interactions are used, padded with
weight 0; ``n_samples = max(1, 2 * median profile length)``; no item mode.
Scoring gathers the requested users' profiles (the reference's
``_compute_item_score`` slices by batch position, a bug not kept).

``fit(mesh_plan=...)`` trains on a mesh of ranks (JAX :468-472): each rank
holds its block of the URM at ``plan.urm`` and its shards of the parameters
(``parallel.distributed.shard_caae_params``) and runs
``parallel.adversarial.sharded_caae_epoch``, whose D phase runs on the whole
stores on every rank and whose Nu masks go through K2 on whole rows. On a
mesh-trained model the scores are G's sharded reconstruction of every
profile, this rank's columns kept until the parameters change;
``score_device`` all-gathers the requested rows' columns and
``score_device_columns`` hands the mesh evaluator this rank's own.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ganmf_tpu_torch.data.device import dense_from_sparse
from ganmf_tpu_torch.models.cfgan import MLPParams, _l2
from ganmf_tpu_torch.models.gan_base import AdversarialRecommender
from ganmf_tpu_torch.models.ganmf import _glorot_uniform
from ganmf_tpu_torch.ops.topk import smallest_k_mask
from ganmf_tpu_torch.utils.debug import debug_enabled, raise_on_nan

#: Buckets of the two-level inverse-CDF tables (JAX :179).
NB = 64

#: D-phase negatives drawn at a time (bounds the gathered [chunk, NB] rows).
DRAW_CHUNK = 1 << 20


class CAAEParams(nn.Module):
    """D's stores and the two autoencoders, in the JAX NamedTuple's order:
    d_user_emb [U, K], d_item_emb [I, K], d_item_bias [I], then G's and G''s
    weights and biases, which is the order of ``parameters()`` and of the
    saveModel ``param_i`` numbering."""

    def __init__(self, d_user_emb, d_item_emb, d_item_bias, G: MLPParams, Gpr: MLPParams):
        super().__init__()
        self.d_user_emb = nn.Parameter(d_user_emb)
        self.d_item_emb = nn.Parameter(d_item_emb)
        self.d_item_bias = nn.Parameter(d_item_bias)
        self.G = G
        self.Gpr = Gpr


class CAAEDraws(NamedTuple):
    """Every random input of one epoch, on the model's device."""

    perm: torch.Tensor  # [nnz_pad] int64, the interactions' shuffle
    d_uniforms: torch.Tensor  # [2 (G, G'), 2 (bucket, within), n_steps * d_bsize] f32 in [0, 1)
    g_users: torch.Tensor  # [g_steps, m] int64, distinct within a step
    g_gumbel: torch.Tensor  # [g_steps, m, I] f32 in [1e-20, 1)
    g_sample: torch.Tensor  # [g_steps, m * n_samples] f32 in [0, 1)
    gpr_users: torch.Tensor  # [gpr_steps, m] int64
    gpr_sample: torch.Tensor  # [gpr_steps, m * n_samples] f32 in [0, 1)


def _init_mlp(dims, generator: torch.Generator) -> MLPParams:
    """Glorot-uniform kernels and zero biases (JAX :59-64)."""
    ws = [_glorot_uniform((dims[l], dims[l + 1]), generator) for l in range(len(dims) - 1)]
    return MLPParams(ws, [torch.zeros(dims[l + 1]) for l in range(len(dims) - 1)])


def init_params(n_users: int, n_items: int, num_factors: int, g_dims: Sequence[int],
                generator: torch.Generator, device: torch.device) -> CAAEParams:
    """Glorot-uniform embeddings, a zero item bias, and G and G' over
    ``g_dims`` (JAX :453-466), drawn on the host from ``generator`` (a CPU
    generator), so that a seed gives the same weights on every device."""
    return CAAEParams(
        _glorot_uniform((n_users, num_factors), generator), _glorot_uniform((n_items, num_factors), generator),
        torch.zeros(n_items), _init_mlp(g_dims, generator), _init_mlp(g_dims, generator),
    ).to(device)


def params_from_jax(arrays: Union[Sequence[np.ndarray], Mapping], device: torch.device) -> CAAEParams:
    """The port's parameters from the JAX ones: the leaves in ``tree_flatten``
    order, or the ``param_0..param_n`` dict a JAX ``saveModel`` writes. G and
    G' have the same layers, so the count of leaves gives them."""
    if isinstance(arrays, Mapping):
        n = sum(1 for name in arrays if str(name).startswith("param_"))
        arrays = [arrays[f"param_{i}"] for i in range(n)]
    if len(arrays) < 7 or (len(arrays) - 3) % 4:
        raise ValueError(f"{len(arrays)} arrays do not make CAAE's parameters")
    t = [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]
    n = (len(t) - 3) // 4  # layers of each autoencoder
    G = MLPParams(t[3 : 3 + n], t[3 + n : 3 + 2 * n])
    Gpr = MLPParams(t[3 + 2 * n : 3 + 3 * n], t[3 + 3 * n :])
    return CAAEParams(t[0], t[1], t[2], G, Gpr).to(device)


def _autoencode(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """Every layer sigmoid-activated, the reconstruction too (JAX :67-73)."""
    h = x
    for w, b in zip(p.ws, p.bs):
        h = torch.sigmoid(h @ w + b)
    return h


def bucketed_cdf_tables(prob: torch.Tensor, nb: int = NB) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level inverse-CDF tables of each row of ``prob`` [R, C] (JAX
    :84-92): the bucket cdf [R, nb] and the within-bucket cdf [R * nb, s],
    s = ceil(C / nb), the columns padded with zeros."""
    n_rows, n_cols = prob.shape
    s = -(-n_cols // nb)
    p3 = F.pad(prob, (0, nb * s - n_cols)).reshape(n_rows, nb, s)
    return torch.cumsum(p3.sum(-1), dim=1), torch.cumsum(p3, dim=-1).reshape(n_rows * nb, s)


def bucketed_cdf_sample(bcdf: torch.Tensor, wcdf: torch.Tensor, rows: torch.Tensor, u_bucket: torch.Tensor,
                        u_within: torch.Tensor, nb: int, n_cols: int) -> torch.Tensor:
    """One draw per entry of ``rows`` from the bucketed tables, given the two
    uniforms of each draw (JAX :95-109): the bucket is the first whose cdf
    reaches u * total, then the item within it likewise. Bitwise the JAX
    sampler on equal tables and uniforms."""
    s = wcdf.shape[1]
    bb = bcdf.index_select(0, rows)
    r1 = u_bucket * bb[:, -1]
    b = torch.clamp((bb < r1[:, None]).sum(1), max=nb - 1)
    wrow = wcdf.index_select(0, rows * nb + b)
    r2 = u_within * wrow[:, -1]
    j = torch.clamp((wrow < r2[:, None]).sum(1), max=s - 1)
    return torch.clamp(b * s + j, max=n_cols - 1)


def cdf_sample(cdf: torch.Tensor, rows: torch.Tensor, u: torch.Tensor, n_items: int) -> torch.Tensor:
    """One draw per entry of ``rows`` by binary search of ``cdf`` [R, I]: the
    first j with cdf[row, j] >= u * cdf[row, -1] (JAX :112-125), in
    ceil(log2 I) fixed steps. Bitwise the JAX sampler on equal inputs."""
    r = u * cdf[:, -1].index_select(0, rows)
    lo = torch.zeros_like(rows)
    hi = torch.full_like(rows, n_items - 1)
    for _ in range(max(1, int(np.ceil(np.log2(n_items))))):
        mid = (lo + hi) // 2
        go_right = cdf[rows, mid] < r
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return torch.clamp(lo, max=n_items - 1)


def d_local_loss(rows: torch.Tensor, w: torch.Tensor, beta: float) -> torch.Tensor:
    """The BPR loss of one D update on its gathered [3B, K + 1] rows (users,
    positives, negatives; column K is the item bias, zero and unused on user
    rows) (JAX :210-216). The item rows' L2 includes their bias."""
    B = w.shape[0]
    K = rows.shape[1] - 1
    ue, pe, ne = rows[:B, :K], rows[B : 2 * B], rows[2 * B :]
    x = (ue * (pe[:, :K] - ne[:, :K])).sum(1) + (pe[:, K] - ne[:, K])
    log_lik = (F.logsigmoid(x) * w).sum() / torch.clamp(w.sum(), min=1.0)
    reg_rows = 0.5 * ((ue**2).sum(1) + (pe**2).sum(1) + (ne**2).sum(1))
    return -log_lik + beta * (reg_rows * w).sum()


def d_phase_negatives(g_tables, gpr_tables, rows: torch.Tensor, d_uniforms: torch.Tensor,
                      n_items: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every D-phase negative of the epoch, from G's and from G''s tables,
    for the flattened user stream ``rows``, drawn ``DRAW_CHUNK`` at a time."""
    out = []
    for tables, (u_b, u_w) in zip((g_tables, gpr_tables), d_uniforms):
        out.append(torch.cat([
            bucketed_cdf_sample(*tables, rows[lo : lo + DRAW_CHUNK], u_b[lo : lo + DRAW_CHUNK],
                                u_w[lo : lo + DRAW_CHUNK], NB, n_items)
            for lo in range(0, rows.shape[0], DRAW_CHUNK)]))
    return out[0], out[1]


def nu_sizes(n_nonint: torch.Tensor, S: float) -> torch.Tensor:
    """k_u = int(n_nonint * S) as int32, the product taken in float32 as the
    JAX package takes it (:351): float64 truncates some products one lower
    (12827 * 0.4515475140394092 is 5792 in float32, 5791 in float64). A
    Python scalar times a float32 tensor is rounded to float32 and multiplied
    in float32, with no copy to the device."""
    return (n_nonint.to(torch.float32) * float(S)).to(torch.int32)


def _reinforce(recon: torch.Tensor, fake_items: torch.Tensor, reward: torch.Tensor) -> torch.Tensor:
    """-mean(log softmax-probability of each sampled item * its reward)."""
    prob = torch.softmax(recon, dim=1).gather(1, fake_items)
    return -(torch.log(torch.clamp(prob, min=1e-20)) * reward).mean()


def _sgd_(params, grads, lr: float) -> None:
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)


def dedup_plan(idx_all: torch.Tensor, n_rows: int):
    """(perm, scat, end) of each update's index row [n_steps, 3B] (JAX
    :286-293): ``perm`` sorts the row (stably), ``end[p]`` is the last slot of
    the duplicate run through sorted slot p, and ``scat[p]`` is the run's
    table row at its first slot, else the scratch row ``n_rows + p``."""
    nb3 = idx_all.shape[1]
    pos = torch.arange(nb3, device=idx_all.device)
    sort_idx, perm = torch.sort(idx_all, dim=1, stable=True)
    is_start = torch.ones_like(sort_idx, dtype=torch.bool)
    is_start[:, 1:] = sort_idx[:, 1:] != sort_idx[:, :-1]
    # the next run's first slot, after each slot: a reversed running minimum
    nxt = torch.where(is_start, pos, nb3).roll(-1, dims=1)
    nxt[:, -1] = nb3
    nxt = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    end = torch.clamp(nxt - 1, max=nb3 - 1)
    scat = torch.where(is_start, sort_idx, n_rows + pos)
    return perm, scat, end


def _dedup_add_(tab: torch.Tensor, g_rows: torch.Tensor, perm, scat, end, lr: float) -> None:
    """tab[scat] += -lr x (each duplicate run's summed gradient), over unique
    indices (JAX :295-301). The running sum goes along the last dimension of
    the [C, 3B] transpose: CUDA scans an inner dimension in parallel, an outer
    one with a serial loop per column (the same order of additions)."""
    c = torch.cumsum(g_rows.index_select(0, perm).t().contiguous(), dim=1)
    lower = F.pad(c[:, :-1], (1, 0))
    tab.index_add_(0, scat, (-lr * (c.index_select(1, end) - lower)).t())


def d_phase(user_emb: torch.Tensor, item_emb: torch.Tensor, item_bias: torch.Tensor, users: torch.Tensor,
            pos_items: torch.Tensor, weights: torch.Tensor, g_tables, gpr_tables, draws: CAAEDraws,
            *, lr: float, beta: float, d_bsize: int, n_d_chunks: int, d_steps: int, d_scatter: str):
    """The D phase on D's whole stores (JAX :218-321): every negative drawn up
    front from the epoch's tables, then ``2 * d_steps * n_d_chunks`` serial
    updates of the fused [U + I, K + 1] table. Returns (the table after the
    phase, the sum of its losses as a device scalar, d_steps * n_d_chunks)."""
    n_users, n_items, B = user_emb.shape[0], item_emb.shape[0], d_bsize
    dev = user_emb.device
    n_steps = d_steps * n_d_chunks
    u_all = users[: n_d_chunks * B].reshape(n_d_chunks, B).repeat(d_steps, 1)
    pos_all = pos_items[: n_d_chunks * B].reshape(n_d_chunks, B).repeat(d_steps, 1)
    w_all = weights[: n_d_chunks * B].reshape(n_d_chunks, B).repeat(d_steps, 1)
    neg_g, neg_gpr = d_phase_negatives(g_tables, gpr_tables, u_all.reshape(-1), draws.d_uniforms, n_items)
    idx_g_all = torch.cat([u_all, n_users + pos_all, n_users + neg_g.reshape(n_steps, B)], dim=1)
    idx_gpr_all = torch.cat([u_all, n_users + pos_all, n_users + neg_gpr.reshape(n_steps, B)], dim=1)

    debug = debug_enabled()
    dedup = d_scatter == "dedup"
    n_rows = n_users + n_items
    with torch.no_grad():
        tab = torch.cat([F.pad(user_emb, (0, 1)), torch.cat([item_emb, item_bias[:, None]], dim=1)])
        if dedup:
            plans = (dedup_plan(idx_g_all, n_rows), dedup_plan(idx_gpr_all, n_rows))
            tab = F.pad(tab, (0, 0, 0, 3 * B))  # the scratch rows of non-first slots
    d_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for step in range(n_steps):
        w = w_all[step]
        # one update with G's negatives, one with G''s (CAAE.py:255-265)
        for u, idx_all in enumerate((idx_g_all, idx_gpr_all)):
            idxs = idx_all[step]
            rows = tab.index_select(0, idxs).requires_grad_(True)
            loss = d_local_loss(rows, w, beta)
            (g_rows,) = torch.autograd.grad(loss, rows)
            if dedup:
                _dedup_add_(tab, g_rows, *(plan[step] for plan in plans[u]), lr)
            else:
                tab.index_add_(0, idxs, -lr * g_rows)
            if debug:
                raise_on_nan(f"CAAE D step {step}, update {u}", loss=loss, table=tab[:n_rows])
            d_sum += loss.detach()
    return tab[:n_rows], d_sum, n_steps


def caae_epoch(
    params: CAAEParams, urm: torch.Tensor, inter_users: torch.Tensor, inter_items: torch.Tensor,
    inter_weight: torch.Tensor, draws: CAAEDraws,
    *, lr: float, beta: float, lmbda: float, S: float, d_bsize: int, n_d_chunks: int,
    d_steps: int, g_steps: int, gpr_steps: int, m_batch: int, n_samples: int,
    d_scatter: str = "direct",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch, in place (JAX :132-396). ``urm`` is the dense [U, I]
    training URM; ``inter_*`` the [n_d_chunks * d_bsize] interactions (users,
    items, weight 0 on padding); ``d_scatter`` the D phase's scatter,
    "direct" or "dedup". Returns the mean D, G and G' losses as device
    scalars, with no read to the host. Under ``GANMF_TPU_DEBUG`` each step's
    loss and updated tensors are checked for NaN (one host read a step)."""
    n_users, n_items = urm.shape
    dev = urm.device
    n_nonint = (urm == 0).sum(1)

    users = inter_users.index_select(0, draws.perm)
    pos_items = inter_items.index_select(0, draws.perm)
    weights = inter_weight.index_select(0, draws.perm)

    G, Gpr = params.G, params.Gpr
    with torch.no_grad():
        gpr_prob_full = torch.softmax(_autoencode(Gpr, urm), dim=1)
        g_tables = bucketed_cdf_tables(torch.softmax(_autoencode(G, urm), dim=1))
        gpr_tables = bucketed_cdf_tables(gpr_prob_full)

    tab, d_sum, n_steps = d_phase(params.d_user_emb, params.d_item_emb, params.d_item_bias, users, pos_items,
                                  weights, g_tables, gpr_tables, draws, lr=lr, beta=beta, d_bsize=d_bsize,
                                  n_d_chunks=n_d_chunks, d_steps=d_steps, d_scatter=d_scatter)
    K, debug = params.d_user_emb.shape[1], debug_enabled()
    with torch.no_grad():
        params.d_user_emb.copy_(tab[:n_users, :K])
        params.d_item_emb.copy_(tab[n_users:, :K])
        params.d_item_bias.copy_(tab[n_users:, K])

    def reward_logits(uids, items):
        ue = params.d_user_emb.detach().index_select(0, uids)
        fe = params.d_item_emb.detach()[items]
        return torch.einsum("mk,mnk->mn", ue, fe) + params.d_item_bias.detach()[items]

    # draw i of a step belongs to user i // n_samples
    sample_rows = torch.arange(m_batch * n_samples, device=dev) // n_samples
    k_all = nu_sizes(n_nonint, S)

    # ---- G phase ----
    g_params = list(G.parameters())
    g_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for step in range(g_steps):
        uids = draws.g_users[step]
        profiles = urm.index_select(0, uids)
        seen = profiles != 0
        # Nu ~ a weighted sample without replacement of the non-interactions,
        # prob ~ G''s softmax (CAAE.py:277-285): Gumbel-top-k with per-user k
        gumbel = -torch.log(-torch.log(draws.g_gumbel[step] + 1e-20))
        p_gpr = gpr_prob_full.index_select(0, uids)
        keys = torch.where(seen, float("-inf"), torch.log(torch.clamp(p_gpr, min=1e-30)) + gumbel)
        nu = smallest_k_mask(-keys, k_all.index_select(0, uids)) & ~seen
        e_mask = torch.clamp(profiles + nu.to(profiles.dtype), 0.0, 1.0)
        with torch.no_grad():
            cdf = torch.cumsum(torch.softmax(_autoencode(G, profiles), dim=1), dim=1)
            fake_items = cdf_sample(cdf, sample_rows, draws.g_sample[step], n_items).reshape(m_batch, n_samples)
            reward = F.logsigmoid(reward_logits(uids, fake_items) - 1.0)
        recon = _autoencode(G, profiles)
        ae_loss = (((recon - profiles) * e_mask) ** 2).sum()
        loss = lmbda * _reinforce(recon, fake_items, reward) + (1.0 - lmbda) * ae_loss + beta * _l2(G)
        _sgd_(g_params, torch.autograd.grad(loss, g_params), lr)
        if debug:
            raise_on_nan(f"CAAE G step {step}", loss=loss, **dict(G.named_parameters()))
        g_sum += loss.detach()

    # ---- G' phase ----
    gpr_params = list(Gpr.parameters())
    gpr_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for step in range(gpr_steps):
        uids = draws.gpr_users[step]
        profiles = urm.index_select(0, uids)
        recon = _autoencode(Gpr, profiles)
        with torch.no_grad():
            cdf = torch.cumsum(torch.softmax(recon, dim=1), dim=1)
            fake_items = cdf_sample(cdf, sample_rows, draws.gpr_sample[step], n_items).reshape(m_batch, n_samples)
            reward = F.logsigmoid(1.0 - reward_logits(uids, fake_items))
        loss = _reinforce(recon, fake_items, reward) + beta * _l2(Gpr)
        _sgd_(gpr_params, torch.autograd.grad(loss, gpr_params), lr)
        if debug:
            raise_on_nan(f"CAAE G' step {step}", loss=loss, **dict(Gpr.named_parameters()))
        gpr_sum += loss.detach()

    return d_sum / max(1, 2 * n_steps), g_sum / max(1, g_steps), gpr_sum / max(1, gpr_steps)


def draw_epoch(gen: torch.Generator, device: torch.device, nnz_pad: int, n_users: int, n_items: int,
               n_d_draws: int, g_steps: int, gpr_steps: int, m_batch: int, n_samples: int) -> CAAEDraws:
    """An epoch's ``CAAEDraws`` from ``gen``, on ``device``, with no read to
    the host. The permutations sort random 62-bit keys (stable), so that no
    draw leaves the device."""
    def perm(n):
        return torch.sort(torch.randint(0, 1 << 62, (n,), generator=gen, device=device), stable=True).indices

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    g_users = [perm(n_users)[:m_batch] for _ in range(g_steps)]
    return CAAEDraws(
        perm=perm(nnz_pad),
        d_uniforms=rand(2, 2, n_d_draws),
        g_users=torch.stack(g_users) if g_steps else torch.zeros((0, m_batch), dtype=torch.int64, device=device),
        g_gumbel=rand(g_steps, m_batch, n_items).clamp_(min=1e-20),
        g_sample=rand(g_steps, m_batch * n_samples),
        gpr_users=torch.randint(0, n_users, (gpr_steps, m_batch), generator=gen, device=device),
        gpr_sample=rand(gpr_steps, m_batch * n_samples),
    )


class CAAE(AdversarialRecommender):
    RECOMMENDER_NAME = "CAAE"
    SUPPORTS_ITEM_MODE = False  # the reference CAAE ignores mode (CAAE.py:25)

    @property
    def params(self) -> Optional[CAAEParams]:
        return self._params

    @params.setter
    def params(self, value: Optional[CAAEParams]) -> None:
        # new parameters drop the cached scores
        self._params = value
        self._score_cache = None
        self._mesh_cache = None

    def fit(
        self,
        epochs: int = 300,
        d_steps: int = 1,
        g_steps: int = 1,
        gpr_steps: int = 1,
        g_layers: int = 1,
        g_units: int = 20,
        gpr_layers: int = 1,
        gpr_units: int = 20,
        num_factors: int = 10,
        d_bsize: int = 1024,
        m_batch: int = 32,
        lmbda: float = 0.5,
        beta: float = 1e-4,
        lr: float = 1e-4,
        S: float = 0.3,
        allow_worse=None,
        freq=None,
        after: int = 0,
        metrics=("MAP",),
        sample_every=None,
        validation_evaluator=None,
        validation_set=None,
        mesh_plan=None,
        d_scatter: str = "direct",
    ):
        """Train on the training matrix (JAX :403-494). Returns the
        reference's fit() value. ``gpr_layers`` and ``gpr_units`` are taken
        and ignored, as the reference ignores them. ``d_scatter``: the D
        phase's scatter, "direct" (``index_add_``) or "dedup" (sorted runs,
        unique indices; deterministic on the card). ``mesh_plan``
        (``parallel.make_mesh``'s plan, on the model's device) trains on a
        mesh: every rank calls ``fit``, makes the same draws and keeps its
        shards; only rank 0 logs, prints and writes checkpoints."""
        if d_scatter not in ("direct", "dedup"):
            raise ValueError(f"d_scatter must be 'direct' or 'dedup', got {d_scatter!r}")
        if mesh_plan is not None and mesh_plan.device != self.device:
            raise ValueError(f"model on {self.device}, its mesh plan on {mesh_plan.device}")
        self.config = dict(
            epochs=epochs, d_steps=d_steps, g_steps=g_steps, gpr_steps=gpr_steps,
            g_layers=g_layers, g_units=g_units, gpr_layers=gpr_layers, gpr_units=gpr_units,
            num_factors=num_factors, d_bsize=d_bsize, m_batch=m_batch,
            lmbda=lmbda, beta=beta, lr=lr, S=S,
        )
        coo = self.URM_train.tocoo()
        n_d_chunks = max(1, int(np.ceil(coo.nnz / int(d_bsize))))
        pad = n_d_chunks * int(d_bsize) - coo.nnz

        def inter(a, dtype):
            return torch.from_numpy(np.concatenate([a, np.zeros(pad, a.dtype)]).astype(dtype)).to(self.device)

        inter_users, inter_items = inter(coo.row, np.int64), inter(coo.col, np.int64)
        inter_weight = inter(np.ones(coo.nnz, np.float32), np.float32)
        n_samples = max(1, 2 * int(np.median(np.ediff1d(self.URM_train.indptr))))
        m_batch_eff = int(min(m_batch, self.n_users))

        # the reference builds G' with g_layers/g_units too (CAAE.py:136-137)
        g_dims = [self.n_items] + [int(g_units)] * int(g_layers) + [self.n_items]
        generator = torch.Generator().manual_seed(self.seed)
        self.mesh_plan = mesh_plan
        if mesh_plan is None:
            urm = self.device_urm().dense
            self.params = init_params(self.n_users, self.n_items, int(num_factors), g_dims, generator, self.device)
            epoch, lead, tail = caae_epoch, (), (urm,)
        else:
            from ganmf_tpu_torch.parallel.adversarial import sharded_caae_epoch
            from ganmf_tpu_torch.parallel.distributed import ShardLayout, shard_caae_params

            lay = ShardLayout(mesh_plan, self.n_users, self.n_items)
            urm = dense_from_sparse(self.URM_train[lay.r0 : lay.r1, lay.i0 : lay.i1], self.device)
            n_nonint = torch.from_numpy(self.n_items - np.ediff1d(self.URM_train.indptr)).to(self.device)
            full = init_params(self.n_users, self.n_items, int(num_factors), g_dims, generator, torch.device("cpu"))
            self.params = shard_caae_params(full, mesh_plan)
            epoch, lead, tail = sharded_caae_epoch, (lay,), (urm, n_nonint)
        self._epoch_gen = torch.Generator(device=self.device).manual_seed(self.seed)
        start_epoch = self.resume_from_checkpoint()  # also restores the generator
        statics = dict(d_bsize=int(d_bsize), n_d_chunks=n_d_chunks, d_steps=int(d_steps),
                       g_steps=int(g_steps), gpr_steps=int(gpr_steps), m_batch=m_batch_eff,
                       n_samples=n_samples, d_scatter=d_scatter)

        def epoch_fn(_):
            draws = self._epoch_draws(inter_users.shape[0], int(d_steps) * n_d_chunks * int(d_bsize),
                                      int(g_steps), int(gpr_steps), m_batch_eff, n_samples)
            # the epoch's losses are dropped, as the JAX fit keeps none
            epoch(*lead, self.params, *tail, inter_users, inter_items, inter_weight, draws,
                  lr=float(lr), beta=float(beta), lmbda=float(lmbda), S=float(S), **statics)
            self._score_cache = self._mesh_cache = None

        result = self._run_training_loop(
            epochs, validation_evaluator, validation_set, sample_every,
            allow_worse, freq, list(metrics), after, epoch_fn=epoch_fn, start_epoch=start_epoch,
        )
        self._invalidate_device_cache()
        return result

    def _epoch_draws(self, nnz_pad: int, n_d_draws: int, g_steps: int, gpr_steps: int, m_batch: int,
                     n_samples: int) -> CAAEDraws:
        """The next epoch's random inputs, from the model's generator."""
        return draw_epoch(self._epoch_gen, self.device, nnz_pad, self.n_users, self.n_items,
                          n_d_draws, g_steps, gpr_steps, m_batch, n_samples)

    # -- crash resume (full training state; plain SGD keeps no optimizer state) --
    def _checkpoint_state(self):
        """The training state; on a mesh its full tensors, gathered from the
        shards (a collective), so that a checkpoint resumes on any plan."""
        state = {"params": self.params.state_dict(), "epoch_gen": self._epoch_gen.get_state()}
        if self.mesh_plan is not None:
            from ganmf_tpu_torch.parallel.distributed import gather_module_state

            state = gather_module_state(state, self.params, self.mesh_plan)
        return state

    def _restore_checkpoint_state(self, state):
        if self.mesh_plan is not None:
            from ganmf_tpu_torch.parallel.distributed import shard_module_state

            state = shard_module_state(state, self.params, self.mesh_plan)
        self.params.load_state_dict(state["params"])
        self._epoch_gen.set_state(state["epoch_gen"])
        self._score_cache = None

    # -- scoring (reference CAAE.py:380-395, with the requested users) ---------
    @torch.no_grad()
    def _mesh_output(self):
        """(layout, [U, I_m]): on a mesh-trained model, G's sharded
        reconstruction of every profile in this rank's columns, kept until
        the parameters change."""
        if self._mesh_cache is None:
            from ganmf_tpu_torch.parallel.adversarial import mlp_shard
            from ganmf_tpu_torch.parallel.distributed import ShardLayout, _padded_shard_rows

            lay = ShardLayout(self.mesh_plan, self.n_users, self.n_items)
            rows = _padded_shard_rows(self._padded_urm(), torch.arange(self.n_users, device=self.device),
                                      lay.i0, lay.i1).contiguous()
            self._mesh_cache = (lay, mlp_shard(lay, self.params.G, rows, "sigmoid", act_last=True))
        return self._mesh_cache

    @torch.no_grad()
    def score_device_columns(self, user_ids: torch.Tensor, i0: int, i1: int) -> torch.Tensor:
        """[B, i1 - i0] scores of items [i0, i1): on a mesh-trained model,
        this rank's own columns with no gather."""
        if self.mesh_plan is not None:
            lay, out = self._mesh_output()
            if (lay.i0, lay.i1) == (i0, i1):
                return out.index_select(0, user_ids)
        return self.score_device(user_ids)[:, i0:i1]

    @torch.no_grad()
    def score_device(self, user_ids: torch.Tensor) -> torch.Tensor:
        """[B, I] scores: G's reconstruction of the users' profiles, computed
        for every user once and cached until the parameters change. On a
        mesh-trained model this rank's columns are all-gathered, a collective
        every rank calls."""
        if self.params is not None and self.mesh_plan is not None:
            from ganmf_tpu_torch.parallel.adversarial import rows_full

            lay, out = self._mesh_output()
            return rows_full(lay, out.index_select(0, user_ids))
        if self._score_cache is None:
            if self.params is None:
                raise RuntimeError("CAAE has no parameters: fit it or load them first")
            self._score_cache = _autoencode(self.params.G, self.device_urm().dense)
        return self._score_cache.index_select(0, user_ids)

    # -- persistence ----------------------------------------------------------
    def loadModel(self, folder_path, file_name=None):
        """Load a zip written by this port's or the JAX package's saveModel,
        and rebuild the parameters from it."""
        data = super().loadModel(folder_path, file_name)
        if "param_0" in data:
            self.params = params_from_jax(data, self.device)
            self.mesh_plan = None  # the full parameters
        return data
