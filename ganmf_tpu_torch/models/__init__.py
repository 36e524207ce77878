from ganmf_tpu_torch.models.base import Recommender, check_matrix  # noqa: F401
from ganmf_tpu_torch.models.ganmf import GANMF, GANMFParams, init_params, params_from_jax  # noqa: F401
from ganmf_tpu_torch.models.cfgan import CFGAN, CFGANParams, MLPParams  # noqa: F401

#: the adversarial models ported so far (the JAX package's GAN_MODELS also
#: holds DisGANMF and CAAE)
GAN_MODELS = (GANMF, CFGAN)
