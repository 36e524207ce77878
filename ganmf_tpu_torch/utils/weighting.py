"""IR feature weighting: Okapi BM25 and TF-IDF row reweighting
(reference Base/IR_feature_weighting.py:13-65).

A copy of ganmf_tpu/utils/weighting.py, which imports nothing of JAX."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps


def okapi_BM_25(data_matrix, K1: float = 1.2, B: float = 0.75):
    assert B > 0 and B < 1
    assert K1 > 0

    data_matrix = sps.coo_matrix(data_matrix)
    N = float(data_matrix.shape[0])
    idf = np.log(N / (1 + np.bincount(data_matrix.col, minlength=data_matrix.shape[1])))

    row_sums = np.ravel(data_matrix.sum(axis=1))
    average_length = row_sums.mean()
    length_norm = (1.0 - B) + B * row_sums / average_length

    data_matrix.data = data_matrix.data * (K1 + 1.0) / (
        K1 * length_norm[data_matrix.row] + data_matrix.data
    ) * idf[data_matrix.col]
    return data_matrix.tocsr()


def TF_IDF(data_matrix):
    data_matrix = sps.coo_matrix(data_matrix)
    N = float(data_matrix.shape[0])
    idf = np.log(N / (1 + np.bincount(data_matrix.col, minlength=data_matrix.shape[1])))

    row_sums = np.ravel(data_matrix.sum(axis=1))
    data_matrix.data = data_matrix.data / row_sums[data_matrix.row] * idf[data_matrix.col]
    return data_matrix.tocsr()
