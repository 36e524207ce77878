"""Experiment-harness entry points of the port (the JAX package's
ganmf_tpu/cli). ``experiment_main`` and ``run_best_main`` are the
``ganmf-torch-exp`` and ``ganmf-torch-run-best`` console scripts
(pyproject.toml); ``python -m ganmf_tpu_torch.cli.experiment ...`` and
``python -m ganmf_tpu_torch.cli.run_best ...`` work from a checkout.
"""

import sys


def experiment_main() -> None:
    from ganmf_tpu_torch.cli.experiment import main

    main(sys.argv[1:])


def run_best_main() -> None:
    from ganmf_tpu_torch.cli.run_best import main

    main(sys.argv[1:])
