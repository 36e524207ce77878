"""Experiment-harness entry points of the port (the JAX package's
ganmf_tpu/cli). ``experiment_main``, ``run_best_main``, ``ablation_main`` and
``describe_main`` are the ``ganmf-torch-exp``, ``ganmf-torch-run-best``,
``ganmf-torch-ablation`` and ``ganmf-torch-describe`` console scripts
(pyproject.toml); ``python -m ganmf_tpu_torch.cli.<module> ...`` works from a
checkout, ``mf_learned`` among them.
"""

import sys


def experiment_main() -> None:
    from ganmf_tpu_torch.cli.experiment import main

    main(sys.argv[1:])


def run_best_main() -> None:
    from ganmf_tpu_torch.cli.run_best import main

    main(sys.argv[1:])


def ablation_main() -> None:
    from ganmf_tpu_torch.cli.ablation import main

    main(sys.argv[1:])


def describe_main() -> None:
    from ganmf_tpu_torch.cli.describe import main

    main(sys.argv[1:])
