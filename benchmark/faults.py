"""Faults planted under the timed path, for the tests that show that the
comparison catches them (and for reading a fault's numbers on the card).

- ``unchanged``: an epoch that returns its state unchanged;
- ``half_batch``: half of each minibatch left out of the training losses,
  the mean taken over the rest; in an evaluation, half of the users left
  out, the means taken over the rest;
- ``altered``: the first item of each ranked list replaced where K1
  produces it.

The faults patch the program's modules for the duration of the ``with``.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def _half(w: torch.Tensor) -> torch.Tensor:
    w = w.clone()
    w[w.shape[0] // 2:] = 0.0
    return w


@contextlib.contextmanager
def plant(name: str):
    from ganmf_tpu_torch.eval import evaluator
    from ganmf_tpu_torch.models import base, ganmf

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "unchanged":
        def epoch(params, *args, **kwargs):
            z = torch.zeros((), device=params.user_emb.device)
            return z, z

        patch(ganmf, "ganmf_epoch", epoch)
    elif name == "half_batch":
        d_loss, g_loss = ganmf.d_loss, ganmf.g_loss
        patch(ganmf, "d_loss", lambda p, uids, real, w, *a, **k: d_loss(p, uids, real, _half(w), *a, **k))
        patch(ganmf, "g_loss", lambda p, uids, real, w, *a, **k: g_loss(p, uids, real, _half(w), *a, **k))
        init = evaluator.EvaluatorHoldout.__init__

        def half_init(self, *a, **k):
            init(self, *a, **k)
            self.usersToEvaluate = self.usersToEvaluate[::2]

        patch(evaluator.EvaluatorHoldout, "__init__", half_init)
    elif name == "altered":
        def altering(topk):
            def fn(U, V, mask, k, *a, **kw):
                vals, ids = topk(U, V, mask, k, *a, **kw)
                ids = ids.clone()
                ids[:, 0] = (ids[:, 0] + 1) % V.shape[0]
                return vals, ids
            return fn

        patch(evaluator, "masked_topk_scores", altering(evaluator.masked_topk_scores))
        patch(base, "masked_topk_scores", altering(base.masked_topk_scores))
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
