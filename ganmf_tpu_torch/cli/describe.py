"""Dataset statistics CLI (reference DataReader.describe, :794-853).

Port of ganmf_tpu/cli/describe.py, on the port's ``load_urms``. Host work
only: no device is used.

Usage: python -m ganmf_tpu_torch.cli.describe <dataset>
"""

from __future__ import annotations

import json
import sys

from ganmf_tpu_torch.cli.experiment import load_urms
from ganmf_tpu_torch.utils.analysis import describe_urm


def main(args):
    if not args or "--help" in args or "-h" in args:
        print("usage: ganmf-torch-describe <dataset>")
        return
    dataset = args[0]
    splits = load_urms(dataset)
    for name, urm in [
        ("train", splits.train),
        ("test", splits.test),
        ("validation", splits.validation),
        ("train_small", splits.train_small),
        ("early_stop", splits.early_stop),
    ]:
        print(json.dumps(describe_urm(urm, f"{dataset}/{name}"), indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
