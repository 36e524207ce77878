"""Training-state checkpointing.

Port of ``TrainCheckpointer`` (ganmf_tpu/utils/checkpoint.py:34-93) without
orbax: the state (parameters, optimizer states, the epoch generator's state;
any nesting of dicts, lists and tensors) is written with ``torch.save`` every
``every_n_epochs`` epochs and read back with ``torch.load(weights_only=True)``,
so a fit() can resume mid-run. The loss histories go to a side file of their
own, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch


class TrainCheckpointer:
    """Save and restore a training state every N epochs, keeping the newest
    ``max_to_keep``."""

    def __init__(self, directory: str, every_n_epochs: int = 10, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.every = max(1, every_n_epochs)
        self.max_to_keep = max(1, max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, kind: str, epoch: int) -> str:
        return os.path.join(self.directory, f"{kind}_{epoch}.pt")

    def _epochs(self):
        return sorted(
            int(f[5:-3]) for f in os.listdir(self.directory)
            if f.startswith("ckpt_") and f.endswith(".pt")
        )

    def due(self, epoch: int) -> bool:
        """True for the epochs whose state is saved."""
        return epoch % self.every == 0

    def maybe_save(self, epoch: int, state: Any, aux: Optional[dict] = None) -> bool:
        if not self.due(epoch):
            return False
        self.save(epoch, state, aux=aux)
        return True

    def save(self, epoch: int, state: Any, aux: Optional[dict] = None) -> None:
        if aux:
            # variable-length side data (loss histories), written first so a
            # checkpoint that exists always has its aux beside it
            _atomic_save({k: torch.as_tensor(np.asarray(v)) for k, v in aux.items()},
                         self._path("aux", epoch))
        _atomic_save(state, self._path("ckpt", epoch))
        for old in self._epochs()[: -self.max_to_keep]:
            for kind in ("ckpt", "aux"):
                if os.path.exists(self._path(kind, old)):
                    os.remove(self._path(kind, old))

    def restore_aux(self, epoch: int) -> Optional[dict]:
        path = self._path("aux", epoch)
        if not os.path.isfile(path):
            return None
        data = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in data.items()}

    def latest_epoch(self) -> Optional[int]:
        steps = self._epochs()
        return steps[-1] if steps else None

    def restore(self, epoch: int, template: Any = None) -> Any:
        """The state saved at ``epoch``, with its tensors on the CPU. The
        template of the JAX interface is not needed: the model copies the
        tensors into its own."""
        return torch.load(self._path("ckpt", epoch), map_location="cpu", weights_only=True)


def _atomic_save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
