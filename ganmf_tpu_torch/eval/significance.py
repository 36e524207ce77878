"""K-fold result repository and significance testing.

Rebuild of Base/Evaluation/KFoldResultRepository.py: collect per-fold
result dicts and run paired t-tests between repositories with Bonferroni
correction (reference :20-60).

A copy of ganmf_tpu/eval/significance.py, which needs only numpy and
scipy.stats.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
from scipy import stats


class KFoldResultRepository:
    def __init__(self, n_folds: int, allow_overwrite: bool = False):
        assert n_folds > 0
        self._n_folds = n_folds
        self._allow_overwrite = allow_overwrite
        self._results: List[Optional[Dict]] = [None] * n_folds

    def set_results_in_fold(self, fold_index: int, results_dict: Dict):
        if self._results[fold_index] is not None and not self._allow_overwrite:
            raise ValueError(f"fold {fold_index} already set")
        self._results[fold_index] = dict(results_dict)

    def get_results(self) -> List[Dict]:
        return list(self._results)

    def get_fold_values(self, metric: str) -> np.ndarray:
        vals = []
        for r in self._results:
            assert r is not None, "missing fold results"
            vals.append(r[metric])
        return np.asarray(vals, dtype=np.float64)

    def run_significance_test(self, other: "KFoldResultRepository", metrics: Optional[List[str]] = None,
                              alpha: float = 0.05):
        """Paired two-sided t-tests with Bonferroni correction.

        Returns {metric: {p_value, significant, mean_diff}}.
        """
        assert self._n_folds == other._n_folds
        first = next(r for r in self._results if r is not None)
        metrics = metrics or list(first.keys())
        corrected_alpha = alpha / len(metrics)

        out = {}
        for metric in metrics:
            a = self.get_fold_values(metric)
            b = other.get_fold_values(metric)
            t_stat, p = stats.ttest_rel(a, b)
            out[metric] = {
                "t_statistic": float(t_stat),
                "p_value": float(p),
                "significant": bool(p < corrected_alpha),
                "mean_diff": float(np.mean(a - b)),
                "corrected_alpha": corrected_alpha,
            }
        return out


def compute_k_fold_significance(list_of_repositories: List[KFoldResultRepository],
                                metrics: Optional[List[str]] = None, alpha: float = 0.05):
    """All-pairs significance tests (reference KFoldResultRepository_Test usage)."""
    results = {}
    for i, repo_a in enumerate(list_of_repositories):
        for j, repo_b in enumerate(list_of_repositories):
            if j <= i:
                continue
            results[(i, j)] = repo_a.run_significance_test(repo_b, metrics=metrics, alpha=alpha)
    return results
