"""Global seeding helpers.

A copy of ganmf_tpu/utils/seeding.py, which uses no framework. The reference
harness seeds python and numpy before dataset splitting and before every model
build (reference: RecSysExp.py:104-108). The numpy RNG drives host-side work
(splitting, the epoch shuffles); each model seeds its own torch generators.
"""

import random

import numpy as np

GLOBAL_SEED = 1337


def set_seed(seed: int) -> None:
    """Seed python and numpy global RNGs (host-side reproducibility)."""
    random.seed(seed)
    np.random.seed(seed)
