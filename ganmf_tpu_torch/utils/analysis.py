"""Loss-curve plots (reference Utils_.plot_loss_acc, Utils_.py:109).

A copy of ``_plt`` and ``plot_loss`` from ganmf_tpu/utils/analysis.py, which
use no framework. Plotting needs matplotlib; without it a plot is skipped with
a message, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def plot_loss(dict_values: Dict[str, List[float]], save_path: str, xlabel: str = "epochs",
              ylabel: Optional[str] = None, scale: str = "linear", title: str = ""):
    """Loss/metric curves to a PNG (reference Utils_.plot_loss_acc :109)."""
    plt = _plt()
    if plt is None:
        print("matplotlib unavailable; skipping plot", save_path)
        return
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, values in dict_values.items():
        ax.plot(range(1, len(values) + 1), values, label=name)
    ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.set_yscale(scale)
    ax.legend()
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
