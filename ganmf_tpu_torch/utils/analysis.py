"""Analysis helpers: gini coefficient, cosine similarities, dense views,
loss/metric plotting, dataset statistics (reference Utils_.py:91-310).

A copy of ganmf_tpu/utils/analysis.py, which uses no framework. Plotting needs
matplotlib; without it a plot is skipped with a message, as in the JAX
package."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.sparse as sps


def gini(array: np.ndarray) -> float:
    """Gini coefficient (reference Utils_.py:267-279)."""
    array = np.asarray(array, dtype=np.float64).flatten()
    if np.amin(array) < 0:
        array -= np.amin(array)
    array = array + 1e-7
    array = np.sort(array)
    index = np.arange(1, array.shape[0] + 1)
    n = array.shape[0]
    return float((np.sum((2 * index - n - 1) * array)) / (n * np.sum(array)))


def dense_spmatrix(matrix) -> np.ndarray:
    """Dense float32 view of a sparse matrix (reference Utils_.py:281-289)."""
    if sps.issparse(matrix):
        return np.asarray(matrix.todense(), dtype=np.float32)
    return np.asarray(matrix, dtype=np.float32)


def cosine_sim(matrix: np.ndarray) -> np.ndarray:
    """Row-to-row cosine similarity (reference Utils_.py:99-106)."""
    similarity = np.dot(matrix, matrix.T)
    inv_sq = 1.0 / np.diag(similarity)
    inv_sq[np.isinf(inv_sq)] = 0.0
    s = np.sqrt(inv_sq)
    return (similarity * s).T * s


def cos_sim_pairs(list_vec1: Sequence[np.ndarray], list_vec2: Sequence[np.ndarray]) -> float:
    """Mean element-wise cosine similarity between two lists of vectors
    (reference Utils_.py:91-96)."""
    sims = []
    for v1, v2 in zip(list_vec1, list_vec2):
        n = np.linalg.norm(v1) * np.linalg.norm(v2)
        sims.append(float(np.dot(v1, v2) / n) if n else 0.0)
    return float(np.mean(sims))


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


def plot_metric_vs_param(xs: Sequence[float], series: Dict[str, Sequence[float]], save_path: str,
                         xlabel: str, ylabel: str = ""):
    """Metric-vs-hyperparameter curves (AblationStudy/MFLearned plots)."""
    plt = _plt()
    if plt is None:
        print("matplotlib unavailable; skipping plot", save_path)
        return
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, ys in series.items():
        ax.plot(xs, ys, marker="o", label=name)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend()
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def describe_urm(urm, name: str = "URM") -> Dict[str, float]:
    """Dataset statistics (reference DataReader.describe :794-853)."""
    urm = urm.tocsr()
    n_users, n_items = urm.shape
    user_counts = np.ediff1d(urm.indptr)
    item_counts = np.ediff1d(urm.tocsc().indptr)
    stats = {
        "name": name,
        "n_users": int(n_users),
        "n_items": int(n_items),
        "interactions": int(urm.nnz),
        "density": urm.nnz / (n_users * n_items),
        "user_interactions_mean": float(user_counts.mean()),
        "user_interactions_median": float(np.median(user_counts)),
        "item_interactions_mean": float(item_counts.mean()),
        "item_interactions_gini": gini(item_counts),
        "cold_users": int((user_counts == 0).sum()),
        "cold_items": int((item_counts == 0).sum()),
    }
    return stats


def estimate_sparse_size(n_rows: int, n_cols: int, density: float, dtype_bytes: int = 4,
                         index_bytes: int = 4) -> float:
    """Estimated CSR memory footprint in MB
    (reference Utils/estimate_sparse_size.py)."""
    nnz = n_rows * n_cols * density
    data = nnz * dtype_bytes
    indices = nnz * index_bytes
    indptr = (n_rows + 1) * index_bytes
    return (data + indices + indptr) / 2**20
