#!/usr/bin/env python3
"""Online-serving latency on one CUDA card: the port's counterpart of
scripts/serving_latency.py.

    python3 scripts/torch_serving_latency.py [dataset ...] [--out PATH]

A thin wrapper of ``ganmf_tpu_torch.cli.serving_latency`` (its docstring
lists the families, the datasets and the rows): p50 and p99 of
``recommend()`` at b=1 and b=32 for the MF, ItemKNN and GANMF families on
the ML-1M-shaped and LastFM-shaped splits, each timed list checked against
an untimed call's. It prints one line a row and writes them to
chiprun_out/serving_latency.json, no PERF.json row. It needs a card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ganmf_tpu_torch.cli.serving_latency import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
