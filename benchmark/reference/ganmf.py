"""GANMF's training epoch in plain float32 PyTorch (user mode).

From the paper's model as the reference implementation trains it:

    D: dloss = R(real) + max(0, m R(real) - R(fake)) + d_reg L2(D)
    G: gloss = (1 - a) R(fake) + a MSE(enc(real), enc(fake)) + g_reg L2(G)

where R(x) is the mean squared error of D's autoencoder reconstruction of
profiles x, fake = U_b V^T, a the feature-matching coefficient and L2 the
sum of squares over 2. An epoch shuffles the rows (numpy's ``shuffle`` on a
``RandomState`` seeded with the model's seed; the last batch is padded with
row 0 at weight 0, and means run over the valid rows), runs ``d_steps``
passes of D minibatches, then ``g_steps`` passes of G minibatches. D and the
item embeddings step with Adam in its bias-corrected form, the user
embeddings with TF1's Adam (eps on the uncorrected sqrt(v), the corrections
folded into the rate), densely over all rows. The initial tensors are
Glorot-uniform (zero biases), drawn in the order user_emb, item_emb, enc_w,
dec_w from a CPU ``torch.Generator`` seeded with the model's seed, as the
JAX package's layout and the port's initialisation define them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import scipy.sparse as sps
import torch

from benchmark.reference import set_tf32

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
LEAVES = ("user_emb", "item_emb", "enc_w", "enc_b", "dec_w", "dec_b")
D_LEAVES = ("enc_w", "enc_b", "dec_w", "dec_b")


def initial_params(n_rows: int, n_cols: int, num_factors: int, emb_dim: int, seed: int) -> Dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)

    def glorot(shape):
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        return torch.empty(shape, dtype=torch.float32).uniform_(-limit, limit, generator=g)

    user = glorot((n_rows, num_factors))
    item = glorot((n_cols, num_factors))
    enc_w = glorot((n_cols, emb_dim))
    dec_w = glorot((emb_dim, n_cols))
    return {"user_emb": user, "item_emb": item, "enc_w": enc_w, "enc_b": torch.zeros(emb_dim),
            "dec_w": dec_w, "dec_b": torch.zeros(n_cols)}


def epoch_order(rng: np.random.RandomState, n_rows: int, padded: int) -> np.ndarray:
    perm = np.arange(n_rows)
    rng.shuffle(perm)
    out = np.zeros(padded, dtype=np.int64)
    out[:n_rows] = perm
    return out


def _mse(a, b, w):
    return (((a - b) ** 2) * w[:, None]).sum() / (torch.clamp(w.sum(), min=1.0) * a.shape[1])


def _l2(ts):
    return sum((t ** 2).sum() / 2.0 for t in ts)


class Trainer:
    """GANMF trained from its seed on a 0/1 ``urm`` (scipy CSR, user mode)."""

    def __init__(self, urm: sps.csr_matrix, fit: dict, seed: int, device: torch.device):
        set_tf32(False)
        self.fit, self.device = fit, device
        n_rows, n_cols = urm.shape
        self.n_rows, self.n_cols = n_rows, n_cols
        coo = urm.tocoo()
        self.profiles = torch.zeros((n_rows, n_cols), dtype=torch.uint8, device=device)
        self.profiles[torch.from_numpy(coo.row.astype(np.int64)).to(device),
                      torch.from_numpy(coo.col.astype(np.int64)).to(device)] = 1
        self.params = {k: v.to(device) for k, v in
                       initial_params(n_rows, n_cols, fit["num_factors"], fit["emb_dim"], seed).items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = {k: 0 for k in self.params}
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        B = int(fit["batch_size"])
        self.n_batches = -(-n_rows // B)
        self.weights = torch.zeros(self.n_batches * B, device=device)
        self.weights[:n_rows] = 1.0

    def resume(self, state: Dict[str, torch.Tensor], epochs_done: int) -> None:
        """Continues from another run's training state after ``epochs_done``
        epochs: ``state`` holds each leaf (``p.<leaf>``), its Adam moments
        (``m.<leaf>``, ``v.<leaf>``) and its step count (``t.<leaf>``); the
        shuffle stream is advanced past those epochs' permutations."""
        self.params = {k: state[f"p.{k}"].to(self.device, torch.float32).clone() for k in LEAVES}
        self.m = {k: state[f"m.{k}"].to(self.device, torch.float32).clone() for k in LEAVES}
        self.v = {k: state[f"v.{k}"].to(self.device, torch.float32).clone() for k in LEAVES}
        self.t = {k: int(round(float(state[f"t.{k}"]))) for k in LEAVES}
        self.rng = np.random.RandomState(self.seed)
        padded = self.n_batches * int(self.fit["batch_size"])
        for _ in range(epochs_done):
            epoch_order(self.rng, self.n_rows, padded)

    def _adam(self, name: str, grad: torch.Tensor, lr: float) -> None:
        m, v = self.m[name], self.v[name]
        self.t[name] += 1
        t = self.t[name]
        m.mul_(BETA1).add_(grad, alpha=1 - BETA1)
        v.mul_(BETA2).add_(grad * grad, alpha=1 - BETA2)
        p = self.params[name]
        if name == "user_emb":  # TF1's form
            lr_t = lr * math.sqrt(1 - BETA2 ** t) / (1 - BETA1 ** t)
            p.sub_(lr_t * m / (torch.sqrt(v) + EPS))
        else:
            p.sub_(lr * (m / (1 - BETA1 ** t)) / (torch.sqrt(v / (1 - BETA2 ** t)) + EPS))

    def _batch(self, order: torch.Tensor, step: int):
        B = int(self.fit["batch_size"])
        lo = (step % self.n_batches) * B
        uids = order[lo:lo + B]
        return uids, self.profiles.index_select(0, uids).float(), self.weights[lo:lo + B]

    def run_epoch(self) -> Tuple[float, float]:
        """One epoch; returns the mean D and G losses."""
        f = self.fit
        P = self.params
        padded = self.n_batches * int(f["batch_size"])
        order = torch.from_numpy(epoch_order(self.rng, self.n_rows, padded)).to(self.device)
        m_, a = float(f["m"]), float(f["recon_coefficient"])
        d_reg, g_reg = float(f["d_reg"]), float(f.get("g_reg", 0.0))
        d_steps, g_steps = int(f.get("d_steps", 1)), int(f.get("g_steps", 1))
        # the mean losses are float32 sums, as the configuration's precision states
        d_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for step in range(d_steps * self.n_batches):
            uids, real, w = self._batch(order, step)
            D = [P[k].detach().requires_grad_(True) for k in D_LEAVES]
            with torch.no_grad():
                fake = P["user_emb"][uids] @ P["item_emb"].T
            rr = _mse(real, (real @ D[0] + D[1]) @ D[2] + D[3], w)
            fr = _mse(fake, (fake @ D[0] + D[1]) @ D[2] + D[3], w)
            loss = rr + torch.clamp(m_ * rr - fr, min=0.0)
            if d_reg:
                loss = loss + d_reg * _l2(D)
            grads = torch.autograd.grad(loss, D)
            with torch.no_grad():
                for k, gk in zip(D_LEAVES, grads):
                    self._adam(k, gk, float(f["d_lr"]))
            d_sum += loss.detach()
        g_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for step in range(g_steps * self.n_batches):
            uids, real, w = self._batch(order, step)
            user = P["user_emb"].detach().requires_grad_(True)
            item = P["item_emb"].detach().requires_grad_(True)
            with torch.no_grad():
                real_enc = real @ P["enc_w"] + P["enc_b"]
            fake = user[uids] @ item.T
            fake_enc = fake @ P["enc_w"] + P["enc_b"]
            fake_dec = fake_enc @ P["dec_w"] + P["dec_b"]
            loss = (1 - a) * _mse(fake, fake_dec, w) + a * _mse(real_enc, fake_enc, w)
            if g_reg:
                loss = loss + g_reg * _l2([user, item])
            g_user, g_item = torch.autograd.grad(loss, [user, item])
            with torch.no_grad():
                self._adam("user_emb", g_user, float(f["g_lr"]))
                self._adam("item_emb", g_item, float(f["g_lr"]))
            g_sum += loss.detach()
        return float(d_sum / (d_steps * self.n_batches)), float(g_sum / (g_steps * self.n_batches))
