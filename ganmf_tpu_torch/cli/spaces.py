"""Per-algorithm hyperparameter search spaces.

A copy of ganmf_tpu/cli/spaces.py: the reference harness's dimensions
(RecSysExp.py:444-549), with the conditional emb_dim / d_nodes dimensions
(:340-346) and the num_factors clamp (:354-361) applied by
``RecSysExp.tune``. The CFGAN zr/zp ratios are fractions (the reference's
{10..90} percentage integers are normalized by the model; saved best params
already use fractions).
"""

from __future__ import annotations

from ganmf_tpu_torch.tune.space import Categorical, Integer, Real

PURESVD = [Integer(1, 250, name="num_factors")]

IALS = [
    Integer(1, 250, name="num_factors"),
    Categorical(["linear", "log"], name="confidence_scaling"),
    Real(1e-3, 50, prior="log-uniform", name="alpha"),
    Real(1e-5, 1e-2, prior="log-uniform", name="reg"),
    Real(1e-3, 10.0, prior="log-uniform", name="epsilon"),
]

SLIMBPR = [
    Integer(5, 1000, name="topK"),
    Categorical([1500], name="epochs"),
    Categorical([True, False], name="symmetric"),
    Categorical(["sgd", "adagrad", "adam"], name="sgd_mode"),
    Real(1e-9, 1e-3, prior="log-uniform", name="lambda_i"),
    Real(1e-9, 1e-3, prior="log-uniform", name="lambda_j"),
    Real(1e-4, 1e-1, prior="log-uniform", name="learning_rate"),
]

CFGAN = [
    Categorical([300], name="epochs"),
    Categorical([1, 2, 3, 4, 5], name="d_steps"),
    Categorical([1, 2, 3, 4, 5], name="g_steps"),
    Categorical([1, 2, 3, 4, 5], name="d_layers"),
    Categorical([1, 2, 3, 4, 5], name="g_layers"),
    Categorical(["ZR", "PM", "ZP"], name="scheme"),
    Categorical([0.005, 0.001, 0.0005, 0.0001], name="d_lr"),
    Categorical([0.005, 0.001, 0.0005, 0.0001], name="g_lr"),
    Categorical([32, 64, 128, 256], name="d_batch_size"),
    Categorical([32, 64, 128, 256], name="g_batch_size"),
    Categorical([0.5, 0.25, 0.1, 0.05, 0.01], name="zr_coefficient"),
    Real(1e-6, 1e-1, prior="log-uniform", name="d_reg"),
    Real(1e-6, 1e-1, prior="log-uniform", name="g_reg"),
    Categorical([0.1, 0.3, 0.5, 0.7, 0.9], name="zr_ratio"),
    Categorical([0.1, 0.3, 0.5, 0.7, 0.9], name="zp_ratio"),
]

CAAE = [
    Categorical([300], name="epochs"),
    Categorical([5, 10, 15, 20], name="d_steps"),
    Categorical([5, 10, 15, 20], name="g_steps"),
    Categorical([5, 10, 15, 20], name="gpr_steps"),
    Categorical([1, 2, 3, 4, 5], name="g_layers"),
    Categorical([1, 2, 3, 4, 5], name="gpr_layers"),
    Categorical([20, 50, 100, 150, 200], name="g_units"),
    Categorical([20, 50, 100, 150, 200], name="gpr_units"),
    Integer(5, 250, name="num_factors"),
    Categorical([32, 64, 128, 256], name="m_batch"),
    Categorical([1024 * i for i in range(1, 11)], name="d_bsize"),
    Categorical([1e-4, 5e-4, 1e-3, 5e-3], name="lr"),
    Categorical([1e-4, 1e-3, 1e-2, 1e-1], name="beta"),
    Categorical([i / 10 for i in range(1, 10)], name="S"),
    Categorical([i / 10 for i in range(1, 10)], name="lmbda"),
]

GANMF = [
    Categorical([300], name="epochs"),
    Integer(1, 250, name="num_factors"),
    Categorical([64, 128, 256, 512, 1024], name="batch_size"),
    Integer(1, 10, name="m"),
    Real(1e-4, 1e-2, prior="log-uniform", name="d_lr"),
    Real(1e-4, 1e-2, prior="log-uniform", name="g_lr"),
    Real(1e-6, 1e-4, prior="log-uniform", name="d_reg"),
    Real(1e-2, 0.5, prior="uniform", name="recon_coefficient"),
]

DISGANMF = [
    Categorical([300], name="epochs"),
    Categorical(["linear", "tanh", "relu", "sigmoid"], name="d_hidden_act"),
    Integer(1, 5, name="d_layers"),
    Integer(5, 250, name="num_factors"),
    Categorical([64, 128, 256, 512, 1024], name="batch_size"),
    Real(1e-4, 1e-2, prior="log-uniform", name="d_lr"),
    Real(1e-4, 1e-2, prior="log-uniform", name="g_lr"),
    Real(1e-6, 1e-4, prior="log-uniform", name="d_reg"),
    Real(1e-2, 0.5, prior="uniform", name="recon_coefficient"),
]

ITEMKNN = [
    Integer(5, 1000, name="topK"),
    Integer(0, 1000, name="shrink"),
    Categorical([True, False], name="normalize"),
]

P3ALPHA = [
    Integer(5, 1000, name="topK"),
    Real(0, 2, prior="uniform", name="alpha"),
    Categorical([True, False], name="normalize_similarity"),
]

DICT_DIMENSIONS = {
    "TopPop": [],
    "Random": [],
    "PureSVD": PURESVD,
    "ALS": IALS,
    "SLIMBPR": SLIMBPR,
    "ItemKNN": ITEMKNN,
    "P3Alpha": P3ALPHA,
    "CFGAN": CFGAN,
    "CAAE": CAAE,
    "GANMF": GANMF,
    "DisGANMF": DISGANMF,
}


def similarity_extra_dimensions(similarity: str):
    """Similarity-conditional dimensions (RecSysExp.py:111-126)."""
    if similarity == "asymmetric":
        return [Real(0, 2, prior="uniform", name="asymmetric_alpha"), Categorical([True], name="normalize")]
    if similarity == "tversky":
        return [
            Real(0, 2, prior="uniform", name="tversky_alpha"),
            Real(0, 2, prior="uniform", name="tversky_beta"),
            Categorical([True], name="normalize"),
        ]
    if similarity == "euclidean":
        return [
            Categorical([True, False], name="normalize"),
            Categorical([True, False], name="normalize_avg_row"),
            Categorical(["lin", "log", "exp"], name="similarity_from_distance_mode"),
        ]
    return []
