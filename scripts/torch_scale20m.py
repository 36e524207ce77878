#!/usr/bin/env python3
"""ML-20M at scale on one CUDA card: the port's counterpart of
scripts/scale20m.py and scripts/scale20m_explicit.py.

    python3 scripts/torch_scale20m.py [stage ...] [--out PATH] [--data-dir DIR] [--split-dir DIR]

A thin wrapper of ``ganmf_tpu_torch.cli.scale20m`` (its docstring lists the
stages, their settings and the receipt). It writes the stand-in's
ratings.csv under $GANMF_TPU_DATA (default datasets/all_datasets) when it is
missing, the implicit five-way split under experiments/datasets, and the
rows to chiprun_out/scale20m.json; the exit code is nonzero when the receipt
fails. It needs a card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ganmf_tpu_torch.cli.scale20m import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
