#!/usr/bin/env python3
"""Training past the card's memory on one CUDA card: the port's counterpart
of scripts/beyond_hbm_demo.py.

    DEMO_USERS=262144 DEMO_ITEMS=131072 python3 scripts/torch_beyond_hbm.py [model ...] [--out PATH]

A thin wrapper of ``ganmf_tpu_torch.cli.beyond_hbm`` (its docstring lists the
models, their settings and the rows). It takes the JAX script's arguments and
environment variables (DEMO_USERS, DEMO_ITEMS, DEMO_NNZ_PER_USER), prints its
JSON lines with each model's peak device memory, the card and the storage
taken, and writes them to chiprun_out/beyond_hbm.json; the exit code is
nonzero when a model's peak passes the module's bound. It needs a card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ganmf_tpu_torch.cli.beyond_hbm import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
