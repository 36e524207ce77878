"""CFGAN's training epoch in plain float32 PyTorch (user mode, scheme ZR).

From Chae et al., "CFGAN: A Generic Collaborative Filtering Framework based
on Generative Adversarial Networks" (CIKM 2018), as the reference
implementation (GANRec/CFGAN.py) trains it, with c a row's 0/1 profile, z its
ZR mask and w its weight:

    G(c) = W2 tanh(W1 c + b1) + b2                 (g_layers hidden layers)
    D(x) = an MLP over x = [c, data] to one logit  (d_layers hidden layers)
    dloss = BCE(D([c, c]) -> 1) + BCE(D([c, G(c) * c]) -> 0) + d_reg L2(D)
    gloss = BCE(D([c, G(c) * c]) -> 1) + g_reg L2(G) + a sum_i G(c)_i^2 z_i

each term a mean over the minibatch's rows weighted by w, L2 the sum of
squares over 2 of every weight and bias, a the ZR coefficient. An epoch runs
``d_steps`` passes of D minibatches (G frozen), then ``g_steps`` passes of G
minibatches (D frozen), rows in their natural order; each network steps
with Adam (bias-corrected, eps added to sqrt(v / (1 - beta2^t))), as
``torch.optim.Adam`` computes it.

Departures from GANRec/CFGAN.py, each as the measured program makes it:

- The ZR negatives. The reference draws each row's k_u non-interactions per
  epoch with its Cython ``random_choice`` (GANRec/Cython/cython_utils.pyx
  ``compute_masks``). Here a row takes the k_u columns with the smallest
  keyed uniforms (below), interactions keyed +inf, ties to the lowest
  column, with k_u = int(n_zeros * zr_ratio), the product in float32 and
  truncated. It is the same distribution (uniform without replacement) with
  other numbers. The keys depend only on (seed, epoch, stream, row,
  column), so a row's mask does not depend on the minibatch it is drawn in.
- ``compute_masks`` uses ``zr_ratio`` where ``zp_ratio`` was meant for the
  PM mask. Only the PM and ZP schemes would see that; this reference runs
  ZR alone, whose train mask is the profile itself.
- The last minibatch of each phase is padded with zero rows at weight 0
  (the means run over the valid rows); the reference's last one is short.
- Kernels are Glorot-uniform and biases U(-0.01, 0.01), drawn from a CPU
  ``torch.Generator`` seeded with the model's seed: G's layers, then D's,
  each kernel before its bias (the reference draws with TF's
  initializers).
- Adam puts eps outside the bias-corrected sqrt(v); TF1's AdamOptimizer
  puts it on the uncorrected one.

The keyed uniforms, written here from the algorithm: word (c mod 4) of
Philox4x32-10 (Salmon et al., SC'11) at counter (c div 4, row, epoch,
stream) and key (seed mod 2^32, seed div 2^32 mod 2^32), mapped to
(x >> 8) * 2^-24, a float32 in [0, 1). The ZR mask's stream is 0.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np
import scipy.sparse as sps
import torch

from benchmark.reference import set_tf32

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
ZR_STREAM = 0
ACTIVATIONS = {"linear": lambda x: x, "tanh": torch.tanh}

_U32 = 0xFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)  # Philox4x32's round multipliers
_BUMP = (0x9E3779B9, 0xBB67AE85)  # its key schedule's increments


def _mul_wide(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of the 64-bit product m * x, for x holding
    32-bit words in int64: x is taken in 16-bit halves so that no partial
    product passes 2^48."""
    lo_part = m * (x & 0xFFFF)
    hi_part = m * (x >> 16)
    low = lo_part + ((hi_part & 0xFFFF) << 16)
    return ((hi_part >> 16) + (low >> 32)) & _U32, low & _U32


def philox(counter: List[torch.Tensor], key: Tuple[int, int]) -> List[torch.Tensor]:
    """Philox4x32 with 10 rounds on four int64 tensors of 32-bit words."""
    x0, x1, x2, x3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _BUMP[0]) & _U32, (k1 + _BUMP[1]) & _U32
        hi0, lo0 = _mul_wide(_MUL[0], x0)
        hi1, lo1 = _mul_wide(_MUL[1], x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return [x0, x1, x2, x3]


def uniforms(seed: int, epoch: int, stream: int, rows: torch.Tensor, n_cols: int) -> torch.Tensor:
    """[len(rows), n_cols] float32 keyed uniforms in [0, 1), on the rows'
    device."""
    quads = -(-n_cols // 4)
    shape = (rows.shape[0], quads)
    dev = rows.device

    def const(v):
        return torch.full(shape, int(v) & _U32, dtype=torch.int64, device=dev)

    counter = [torch.arange(quads, dtype=torch.int64, device=dev).expand(shape),
               (rows.to(torch.int64) & _U32)[:, None].expand(shape), const(epoch), const(stream)]
    words = torch.stack(philox(counter, (int(seed) & _U32, (int(seed) >> 32) & _U32)), dim=2)
    return (words.reshape(rows.shape[0], 4 * quads)[:, :n_cols] >> 8).to(torch.float32) * 2.0 ** -24


def zr_mask(cond: torch.Tensor, u: torch.Tensor, ratio: float) -> torch.Tensor:
    """Each row's k_u = int(n_zeros * ratio) non-interactions with the
    smallest keys ``u``, ties to the lowest column: a bool [R, I]."""
    interacted = cond != 0
    n_zeros = (~interacted).sum(1).to(torch.float32)
    k = (n_zeros * torch.tensor(ratio, dtype=torch.float32, device=cond.device)).to(torch.int64)
    order = torch.sort(torch.where(interacted, math.inf, u), dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(cond.shape[1], device=cond.device).expand_as(order).contiguous())
    return rank < k[:, None]


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every product of the epoch (a seam for the tests' rounded control)."""
    return a @ b


def _mlp(ws, bs, x, act: str):
    fn = ACTIVATIONS[act]
    h = x
    for layer, (w, b) in enumerate(zip(ws, bs)):
        h = _matmul(h, w) + b
        if layer < len(ws) - 1:
            h = fn(h)
    return h


def _bce(logits: torch.Tensor, target: float, w: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of the logits [R, 1] against ``target``, in its
    stable form max(x, 0) - x t + log(1 + exp(-|x|)), weighted mean."""
    x = logits[:, 0]
    per = torch.clamp(x, min=0.0) - x * target + torch.log1p(torch.exp(-torch.abs(x)))
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def _l2(ts: Iterable[torch.Tensor]) -> torch.Tensor:
    return sum((t ** 2).sum() / 2.0 for t in ts)


def layer_dims(n_cols: int, fit: dict) -> Tuple[List[int], List[int]]:
    """G's and D's widths, input first."""
    g = [n_cols] + [int(fit["g_nodes"])] * int(fit["g_layers"]) + [n_cols]
    d = [2 * n_cols] + [int(fit["d_nodes"])] * int(fit["d_layers"]) + [1]
    return g, d


def leaf_names(fit: dict) -> List[str]:
    """The leaves by name, G's kernels, G's biases, D's kernels, D's biases."""
    g, d = int(fit["g_layers"]) + 1, int(fit["d_layers"]) + 1
    return ([f"G.ws.{i}" for i in range(g)] + [f"G.bs.{i}" for i in range(g)]
            + [f"D.ws.{i}" for i in range(d)] + [f"D.bs.{i}" for i in range(d)])


def initial_params(n_cols: int, fit: dict, seed: int) -> Dict[str, torch.Tensor]:
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for net, dims in zip("GD", layer_dims(n_cols, fit)):
        for i in range(len(dims) - 1):
            limit = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
            out[f"{net}.ws.{i}"] = torch.empty((dims[i], dims[i + 1])).uniform_(-limit, limit, generator=gen)
            out[f"{net}.bs.{i}"] = torch.empty((dims[i + 1],)).uniform_(-0.01, 0.01, generator=gen)
    return {k: out[k] for k in leaf_names(fit)}


class Trainer:
    """CFGAN trained from its seed on a 0/1 ``urm`` (scipy CSR, user mode)."""

    def __init__(self, urm: sps.csr_matrix, fit: dict, seed: int, device: torch.device):
        if fit.get("scheme", "ZR") != "ZR":
            raise ValueError("the reference trains the ZR scheme")
        set_tf32(False)
        self.fit, self.seed, self.device = fit, int(seed), device
        self.n_rows, self.n_cols = urm.shape
        coo = urm.tocoo()
        self.profiles = torch.zeros((self.n_rows, self.n_cols), dtype=torch.uint8, device=device)
        self.profiles[torch.from_numpy(coo.row.astype(np.int64)).to(device),
                      torch.from_numpy(coo.col.astype(np.int64)).to(device)] = 1
        self.names = leaf_names(fit)
        self.params = {k: v.to(device) for k, v in initial_params(self.n_cols, fit, self.seed).items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = {k: 0 for k in self.params}
        self.epoch = 0  # the keyed draws' epoch counter: epochs run so far

    def resume(self, state: Dict[str, torch.Tensor], epochs_done: int) -> None:
        """Continues from another run's training state after ``epochs_done``
        epochs: ``state`` holds each leaf (``p.<leaf>``), its Adam moments
        (``m.<leaf>``, ``v.<leaf>``) and its step count (``t.<leaf>``);
        ``epochs_done`` is the keyed draws' epoch counter."""
        self.params = {k: state[f"p.{k}"].to(self.device, torch.float32).clone() for k in self.names}
        self.m = {k: state[f"m.{k}"].to(self.device, torch.float32).clone() for k in self.names}
        self.v = {k: state[f"v.{k}"].to(self.device, torch.float32).clone() for k in self.names}
        self.t = {k: int(round(float(state[f"t.{k}"]))) for k in self.names}
        self.epoch = int(epochs_done)

    def _adam(self, name: str, grad: torch.Tensor, lr: float) -> None:
        m, v, p = self.m[name], self.v[name], self.params[name]
        self.t[name] += 1
        t = self.t[name]
        m.mul_(BETA1).add_(grad, alpha=1 - BETA1)
        v.mul_(BETA2).add_(grad * grad, alpha=1 - BETA2)
        denom = torch.sqrt(v) / math.sqrt(1 - BETA2 ** t) + EPS
        p.sub_((lr / (1 - BETA1 ** t)) * m / denom)

    def _batch(self, lo: int, size: int):
        """(row ids, profiles as float32, weights) of rows [lo, lo + size):
        rows past the matrix are zeros at weight 0."""
        rows = torch.arange(lo, lo + size, device=self.device)
        n = max(0, min(size, self.n_rows - lo))
        cond = torch.zeros((size, self.n_cols), dtype=torch.float32, device=self.device)
        cond[:n] = self.profiles[lo:lo + n].float()
        w = (rows < self.n_rows).to(torch.float32)
        return rows, cond, w

    def _net(self, net: str, leaves=None):
        p = self.params if leaves is None else leaves
        k = sum(1 for n in self.names if n.startswith(f"{net}.ws."))
        return [p[f"{net}.ws.{i}"] for i in range(k)], [p[f"{net}.bs.{i}"] for i in range(k)]

    def run_epoch(self, keep_masks: Iterable[int] = ()) -> Tuple[List[float], List[float]]:
        """One epoch; returns each D and each G minibatch's loss. The ZR masks
        of the G minibatches whose index is in ``keep_masks`` are kept in
        ``kept_masks`` (bool, on the CPU)."""
        f = self.fit
        self.epoch += 1
        keep = set(keep_masks)
        self.kept_masks: Dict[int, torch.Tensor] = {}
        d_batch, g_batch = int(f["d_batch_size"]), int(f["g_batch_size"])
        d_n, g_n = -(-self.n_rows // d_batch), -(-self.n_rows // g_batch)
        d_reg, g_reg = float(f.get("d_reg", 0.0)), float(f.get("g_reg", 0.0))
        d_act, g_act = f.get("d_hidden_act", "linear"), f.get("g_hidden_act", "linear")
        d_losses, g_losses = [], []
        for step in range(int(f.get("d_steps", 1)) * d_n):
            _, cond, w = self._batch((step % d_n) * d_batch, d_batch)
            leaves = {k: self.params[k].detach().requires_grad_(True) for k in self.names if k[0] == "D"}
            dw, db = self._net("D", leaves)
            with torch.no_grad():
                fake = _mlp(*self._net("G"), cond, g_act) * cond
            d_real = _mlp(dw, db, torch.cat([cond, cond], dim=1), d_act)
            d_fake = _mlp(dw, db, torch.cat([cond, fake], dim=1), d_act)
            loss = _bce(d_real, 1.0, w) + _bce(d_fake, 0.0, w) + d_reg * _l2(dw + db)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                for k, g in zip(leaves, grads):
                    self._adam(k, g, float(f["d_lr"]))
            d_losses.append(loss.detach())
        for step in range(int(f.get("g_steps", 1)) * g_n):
            rows, cond, w = self._batch((step % g_n) * g_batch, g_batch)
            zmask = zr_mask(cond, uniforms(self.seed, self.epoch, ZR_STREAM, rows, self.n_cols),
                            float(f["zr_ratio"]))
            if step in keep:
                self.kept_masks[step] = zmask.cpu()
            leaves = {k: self.params[k].detach().requires_grad_(True) for k in self.names if k[0] == "G"}
            gw, gb = self._net("G", leaves)
            fake = _mlp(gw, gb, cond, g_act)
            d_fake = _mlp(*self._net("D"), torch.cat([cond, fake * cond], dim=1), d_act)
            zr = ((fake ** 2 * zmask.to(torch.float32)).sum(1) * w).sum() / torch.clamp(w.sum(), min=1.0)
            loss = _bce(d_fake, 1.0, w) + g_reg * _l2(gw + gb) + float(f["zr_coefficient"]) * zr
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                for k, g in zip(leaves, grads):
                    self._adam(k, g, float(f["g_lr"]))
            g_losses.append(loss.detach())
        return ([float(x) for x in torch.stack(d_losses).cpu()], [float(x) for x in torch.stack(g_losses).cpu()])
