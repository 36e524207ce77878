from ganmf_tpu_torch.tune.space import Categorical, Integer, Real  # noqa: F401
from ganmf_tpu_torch.tune.gp import OptimizeResult, dummy_minimize, gp_minimize  # noqa: F401
