"""Experiment-harness entry points of the port (the JAX package's
ganmf_tpu/cli). ``run_best_main`` is the ``ganmf-torch-run-best`` console
script (pyproject.toml); ``python -m ganmf_tpu_torch.cli.run_best ...`` works
from a checkout.
"""

import sys


def run_best_main() -> None:
    from ganmf_tpu_torch.cli.run_best import main

    main(sys.argv[1:])
