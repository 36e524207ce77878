from ganmf_tpu_torch.models.base import (  # noqa: F401
    ItemSimilarityRecommender,
    MatrixFactorizationRecommender,
    Recommender,
    UserSimilarityRecommender,
    check_matrix,
)
from ganmf_tpu_torch.models.ganmf import GANMF, GANMFParams, init_params, params_from_jax  # noqa: F401
from ganmf_tpu_torch.models.cfgan import CFGAN, CFGANParams, MLPParams  # noqa: F401
from ganmf_tpu_torch.models.disganmf import DisGANMF, DisGANMFParams  # noqa: F401
from ganmf_tpu_torch.models.caae import CAAE, CAAEParams  # noqa: F401
from ganmf_tpu_torch.models.puresvd import PureSVDRecommender  # noqa: F401
from ganmf_tpu_torch.models.ials import IALSRecommender  # noqa: F401
from ganmf_tpu_torch.models.toppop import GlobalEffects, Random, TopPop  # noqa: F401
from ganmf_tpu_torch.models.itemknn import (  # noqa: F401
    ItemKNNCBFRecommender,
    ItemKNNCFRecommender,
    ItemKNNCustomSimilarityRecommender,
    ItemKNNSimilarityHybridRecommender,
    UserKNNCFRecommender,
)
from ganmf_tpu_torch.models.p3alpha import P3alphaRecommender, RP3betaRecommender  # noqa: F401
from ganmf_tpu_torch.models.slim_bpr import SLIM_BPR, SLIM_BPR_Cython  # noqa: F401
from ganmf_tpu_torch.models.mf_sgd import (  # noqa: F401
    MatrixFactorization_AsySVD,
    MatrixFactorization_BPR,
    MatrixFactorization_FunkSVD,
)
from ganmf_tpu_torch.models.irgan import IRGAN_Recommender  # noqa: F401
from ganmf_tpu_torch.models.extras import (  # noqa: F401
    EASE_R_Recommender,
    NMFRecommender,
    PredefinedListRecommender,
)

#: the adversarial models ported so far, as the JAX package's GAN_MODELS
GAN_MODELS = (GANMF, DisGANMF, CFGAN, CAAE)
