"""IRGAN: adversarial matrix factorization with dynamic negative sampling.

Port of ganmf_tpu/models/irgan.py, which completes the reference's
vestigial kernel (GANRec/Cython/IRGAN_Cython.pyx:43): a generator and a
discriminator, each an MF scorer ``u @ V.T + item_bias``; generator
pretraining by dynamic negative sampling (DNS_K candidates drawn from the
generator's temperature softmax over the unseen items, the best-scoring one
taken as j-, then a pairwise sigmoid update); then adversarial epochs, where D
learns to rank true positives above the generator's samples and G steps by
REINFORCE over its full softmax with D's pairwise advantage as the reward.
The JAX module's notes on the reference's quirks (its anti-regularization,
its CDF over raw scores) hold here too.

Every epoch runs over interaction chunks of ``batch_size`` (the JAX
``lax.scan`` bodies, :99-190): a [C, I] score block from one float32 product,
the chunk's seen items masked to -1e30 by a scatter of its padded-CSR rows,
and row-wise ``index_add_`` updates. JAX samples with
``jax.random.categorical``, which is the argmax of Gumbel noise of shape
(samples, C, I) plus the logits; the epochs here take that noise as an input,
one chunk at a time (``noise_stream`` draws it from a ``torch.Generator`` on
the model's device), so that an epoch can be run from the JAX package's
noise. No epoch's noise is made at once: one G chunk at LastFM's 17632 items
and 16 samples is 289 MB.

On a CUDA device ``index_add_`` sums a chunk's duplicate rows by atomics, in
no fixed order, and a Gumbel argmax at a near tie may go either way between
two summation orders.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple

import numpy as np
import torch

from ganmf_tpu_torch.data.device import padded_csr_from_sparse
from ganmf_tpu_torch.models.base import MatrixFactorizationRecommender
from ganmf_tpu_torch.models.early_stopping import IncrementalTrainingEarlyStopping

NEG_INF = -1e30  # the masked logit (JAX :56)


class IRGANState(NamedTuple):
    """JAX's ``_IRGANState`` (:59-65)."""

    Gu: torch.Tensor  # generator user factors [U, K]
    Gv: torch.Tensor  # generator item factors [I, K]
    Gb: torch.Tensor  # generator item bias    [I]
    Du: torch.Tensor  # discriminator user factors [U, K]
    Dv: torch.Tensor  # discriminator item factors [I, K]
    Db: torch.Tensor  # discriminator item bias    [I]


def _f32(x) -> float:
    """x rounded to float32, as JAX traces a Python scalar."""
    return float(np.float32(x))


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1), as
    ``jax.random.gumbel`` draws it, on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))


def noise_stream(generator: torch.Generator, shape, n_chunks: int):
    """``n_chunks`` Gumbel blocks of ``shape``, each drawn when it is taken."""
    return (gumbel(shape, generator) for _ in range(n_chunks))


def masked_logits(Uf, Vf, b, u, pad_rows, n_items: int, temperature: float):
    """(logits, scores) of a user chunk (JAX :68-76): scores = U[u] V^T + b,
    and logits = scores / temperature with the user's observed items at
    -1e30. ``pad_rows`` [U, L] holds each user's items padded with
    ``n_items``. [C, I] each."""
    scores = Uf.index_select(0, u) @ Vf.T + b[None, :]
    rows = pad_rows.index_select(0, u)
    seen = torch.zeros((len(u), n_items + 1), dtype=torch.bool, device=u.device)
    seen = seen.scatter_(1, rows, True)[:, :n_items]
    return torch.where(seen, NEG_INF, scores / _f32(temperature)), scores


def pairwise_update(Uf, Vf, b, u, i, j, lr: float, reg: float) -> None:
    """Ascent on log sigmoid(x_uij) with weight decay, x_uij = u.(v_i - v_j)
    + b_i - b_j, in place, by five ``index_add_`` calls in JAX's order
    (:79-93): the factor rows are read before any update, b_j after b's i
    update."""
    lr, reg = _f32(lr), _f32(reg)
    Uu, Vi, Vj = Uf.index_select(0, u), Vf.index_select(0, i), Vf.index_select(0, j)
    b_i = b.index_select(0, i)
    x = torch.sum(Uu * (Vi - Vj), dim=1) + b_i - b.index_select(0, j)
    g = torch.sigmoid(-x)  # d/dx log sigmoid(x)
    Uf.index_add_(0, u, lr * (g[:, None] * (Vi - Vj) - reg * Uu))
    Vf.index_add_(0, i, lr * (g[:, None] * Uu - reg * Vi))
    Vf.index_add_(0, j, lr * (-g[:, None] * Uu - reg * Vj))
    b.index_add_(0, i, lr * (g - reg * b_i))
    b.index_add_(0, j, lr * (-g - reg * b.index_select(0, j)))


def _chunk(arr: torch.Tensor, c: int, chunk: int) -> torch.Tensor:
    return arr[c * chunk : (c + 1) * chunk]


@torch.no_grad()
def dns_pretrain_epoch(state: IRGANState, u_arr, i_arr, pad_rows, noise: Iterable, *, lr: float, reg: float,
                       temperature: float, n_items: int, chunk: int) -> IRGANState:
    """One generator pretraining epoch (JAX :99-124): for each chunk of
    interactions, DNS_K candidates from the generator's softmax (the argmax of
    the chunk's [DNS_K, C, I] Gumbel noise from ``noise`` plus the logits),
    the best-scoring one as j-, then the pairwise update of G. Returns a new
    state and leaves ``state`` as it was."""
    Gu, Gv, Gb = (t.clone() for t in state[:3])
    for c, gum in enumerate(noise):
        u, i = _chunk(u_arr, c, chunk), _chunk(i_arr, c, chunk)
        logits, scores = masked_logits(Gu, Gv, Gb, u, pad_rows, n_items, temperature)
        cand = torch.argmax(gum + logits[None], dim=-1).T  # [C, DNS_K]
        best = torch.argmax(torch.gather(scores, 1, cand), dim=1)
        j = torch.gather(cand, 1, best[:, None])[:, 0]
        pairwise_update(Gu, Gv, Gb, u, i, j, lr, reg)
    return state._replace(Gu=Gu, Gv=Gv, Gb=Gb)


@torch.no_grad()
def adversarial_epoch(state: IRGANState, u_arr, i_arr, pad_rows, d_noise: List[Iterable],
                      g_noise: List[Iterable], *, d_lr: float, g_lr: float, d_reg: float, g_reg: float,
                      temperature: float, n_items: int, chunk: int) -> IRGANState:
    """One adversarial epoch (JAX :131-190): a D pass over the chunks for
    each stream of ``d_noise`` (pairwise updates on (u, i+, j~G), j the argmax
    of [C, I] Gumbel noise plus G's logits), then a G pass for each stream of
    ``g_noise`` (REINFORCE over G's softmax from S samples a row, [S, C, I]
    noise: the surrogate's logit gradient is (reward - baseline) *
    (onehot(j) - p), pulled back by two products a chunk), each G pass ending
    in a full-table weight decay of Gv and Gb. Returns a new state and leaves
    ``state`` as it was."""
    Gu, Gv, Gb, Du, Dv, Db = (t.clone() for t in state)
    glr, greg = _f32(g_lr), _f32(g_reg)
    # float32 arithmetic, as JAX computes 1 - g_lr * g_reg from traced scalars
    decay = float(np.float32(1.0) - np.float32(glr) * np.float32(greg))

    for stream in d_noise:
        for c, gum in enumerate(stream):
            u, i = _chunk(u_arr, c, chunk), _chunk(i_arr, c, chunk)
            logits, _ = masked_logits(Gu, Gv, Gb, u, pad_rows, n_items, temperature)
            j = torch.argmax(gum + logits, dim=-1)
            pairwise_update(Du, Dv, Db, u, i, j, d_lr, d_reg)

    for stream in g_noise:
        for c, gum in enumerate(stream):
            u, i = _chunk(u_arr, c, chunk), _chunk(i_arr, c, chunk)
            S, C = gum.shape[0], len(u)
            logits, _ = masked_logits(Gu, Gv, Gb, u, pad_rows, n_items, temperature)
            p = torch.softmax(logits, dim=-1)  # [C, I]
            j = torch.argmax(gum + logits[None], dim=-1)  # [S, C]

            d_scores = Du.index_select(0, u) @ Dv.T + Db[None, :]  # [C, I]
            d_pos = torch.gather(d_scores, 1, i[:, None])  # [C, 1]
            adv = torch.gather(d_scores, 1, j.T) - d_pos  # [C, S]
            reward = torch.logaddexp(adv, torch.zeros_like(adv))  # softplus: G's payoff for fooling D
            reward = reward - torch.mean(reward, dim=1, keepdim=True)  # baseline

            # the rewards scattered onto the sampled ids, duplicates summed
            rows = torch.arange(C, device=u.device)[None, :].expand(S, C)
            onehot_sum = torch.zeros((C, n_items), dtype=torch.float32, device=u.device)
            onehot_sum.index_put_((rows, j), reward.T, accumulate=True)
            # d surrogate / d logits, averaged over the S samples
            dlogits = (onehot_sum - torch.sum(reward, dim=1)[:, None] * p) / float(
                np.float32(S) * np.float32(temperature))

            Gu_u = Gu.index_select(0, u)
            dGu = glr * (dlogits @ Gv - greg * Gu_u)
            Gv = Gv + glr * (dlogits.T @ Gu_u)
            Gb = Gb + glr * torch.sum(dlogits, dim=0)
            Gu.index_add_(0, u, dGu)
        # full-table weight decay once a G pass (the REINFORCE update touches
        # every Gv row, so row-targeted decay has no meaning)
        Gv, Gb = Gv * decay, Gb * decay
    return IRGANState(Gu, Gv, Gb, Du, Dv, Db)


def state_from_jax(state) -> IRGANState:
    """The port's state from the arrays of JAX's ``_IRGANState`` (as numpy
    arrays or anything ``np.asarray`` takes), on the CPU."""
    return IRGANState(*(torch.from_numpy(np.array(x, dtype=np.float32)) for x in state))


class IRGAN_Recommender(MatrixFactorizationRecommender, IncrementalTrainingEarlyStopping):
    """IRGAN MF with dynamic-negative-sampling pretraining (JAX :193-331).

    Serving scores are the generator's ``u @ V.T + b``: the bias folds into
    the factors as a ones column times a bias column, so K1 ranks it like any
    factor model."""

    RECOMMENDER_NAME = "IRGAN_Recommender"

    def fit(
        self,
        epochs: int = 300,
        pre_train_epochs: int = 100,
        num_factors: int = 10,
        init_delta: float = 0.05,
        batch_size: int = 256,
        DNS_K: int = 5,
        DNS_lr: float = 0.05,
        D_lr: float = 1e-4,
        G_lr: float = 1e-4,
        d_steps: int = 1,
        g_steps: int = 1,
        temperature: float = 0.2,
        disc_reg: float = 1e-4,
        gen_reg: float = 1e-4,
        g_samples: int = 16,
        random_seed: int = 1234,
        **earlystopping_kwargs,
    ):
        # as in the JAX fit, which has no mesh_plan parameter, any other
        # keyword (mesh_plan too) goes to the early-stopping loop, which
        # raises TypeError for it; a fit with epochs=0 never reads them
        # the permutation and the uniform init come from the host RandomState,
        # in the JAX fit's order: the starting tables are JAX's bitwise
        rng = np.random.RandomState(random_seed)
        K = int(num_factors)
        self.num_factors = K
        urm = self.URM_train
        self._pad = padded_csr_from_sparse(urm, self.device).idx  # [U, L] padded with n_items

        coo = urm.tocoo()
        order = rng.permutation(coo.nnz)
        u_arr, i_arr = coo.row[order].astype(np.int64), coo.col[order].astype(np.int64)
        chunk = int(batch_size)
        n_chunks = max(1, int(np.ceil(coo.nnz / chunk)))
        extra = n_chunks * chunk - coo.nnz
        if extra > 0:  # wrap-around padding keeps every chunk full
            u_arr = np.concatenate([u_arr, u_arr[:extra]])
            i_arr = np.concatenate([i_arr, i_arr[:extra]])
        self._u_arr = torch.from_numpy(u_arr).to(self.device)
        self._i_arr = torch.from_numpy(i_arr).to(self.device)
        self._chunk, self._n_chunks = chunk, n_chunks

        def table(shape):
            return torch.from_numpy(rng.uniform(-init_delta, init_delta, shape).astype(np.float32)).to(self.device)

        zeros = torch.zeros(self.n_items, dtype=torch.float32, device=self.device)
        self._state = IRGANState(
            Gu=table((self.n_users, K)), Gv=table((self.n_items, K)), Gb=zeros,
            Du=table((self.n_users, K)), Dv=table((self.n_items, K)), Db=zeros.clone(),
        )
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(random_seed)
        self._hp = dict(
            DNS_lr=float(DNS_lr), D_lr=float(D_lr), G_lr=float(G_lr), d_steps=int(d_steps), g_steps=int(g_steps),
            DNS_K=int(DNS_K), temperature=float(temperature), disc_reg=float(disc_reg), gen_reg=float(gen_reg),
            g_samples=int(g_samples),
        )

        # phase 1: DNS generator pretraining, with no early stopping (the
        # reference kernel's pretraining loop has none either)
        for _ in range(int(pre_train_epochs)):
            self._state = dns_pretrain_epoch(
                self._state, self._u_arr, self._i_arr, self._pad, self._pretrain_noise(),
                lr=self._hp["DNS_lr"], reg=self._hp["gen_reg"], temperature=self._hp["temperature"],
                n_items=self.n_items, chunk=chunk)

        # phase 2: adversarial epochs under early stopping
        self._update_best_model()
        if int(epochs) > 0:
            self._train_with_early_stopping(int(epochs), algorithm_name=self.RECOMMENDER_NAME, **earlystopping_kwargs)
        else:  # a pretraining-only fit serves the pretrained generator
            self.epochs_best = 0
        self.USER_factors = self.USER_factors_best
        self.ITEM_factors = self.ITEM_factors_best
        self.use_bias = False

    # -- the noise of an epoch, drawn a chunk at a time ------------------------
    def _pretrain_noise(self):
        return noise_stream(self._generator, (self._hp["DNS_K"], self._chunk, self.n_items), self._n_chunks)

    def _adversarial_noise(self):
        """(d_noise, g_noise): a stream a D pass and a stream a G pass, drawn
        in the order the epoch takes them."""
        d = [noise_stream(self._generator, (self._chunk, self.n_items), self._n_chunks)
             for _ in range(self._hp["d_steps"])]
        g = [noise_stream(self._generator, (self._hp["g_samples"], self._chunk, self.n_items), self._n_chunks)
             for _ in range(self._hp["g_steps"])]
        return d, g

    def _run_epoch(self, num_epoch):
        d_noise, g_noise = self._adversarial_noise()
        self._state = adversarial_epoch(
            self._state, self._u_arr, self._i_arr, self._pad, d_noise, g_noise,
            d_lr=self._hp["D_lr"], g_lr=self._hp["G_lr"], d_reg=self._hp["disc_reg"], g_reg=self._hp["gen_reg"],
            temperature=self._hp["temperature"], n_items=self.n_items, chunk=self._chunk)

    # -- crash resume (the state and the generator's state) -------------------
    def _checkpoint_state(self):
        return {"state": self._state._asdict(), "generator": self._generator.get_state()}

    def _restore_checkpoint_state(self, state):
        self._state = IRGANState(**{k: v.to(self.device) for k, v in state["state"].items()})
        self._generator.set_state(state["generator"])

    def _gen_factors(self):
        """The generator's factors with the item bias folded in (JAX
        :311-319): [Gu | 1] @ [Gv | Gb]^T = Gu Gv^T + Gb, on the device."""
        Gu, Gv, Gb = self._state.Gu, self._state.Gv, self._state.Gb
        return (torch.cat([Gu, torch.ones_like(Gu[:, :1])], dim=1),
                torch.cat([Gv, Gb[:, None]], dim=1))

    def _prepare_model_for_validation(self):
        self.USER_factors, self.ITEM_factors = self._gen_factors()
        self.use_bias = False

    def _update_best_model(self):
        self.USER_factors_best, self.ITEM_factors_best = self._gen_factors()
