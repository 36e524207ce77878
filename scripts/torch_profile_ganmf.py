#!/usr/bin/env python3
"""Where the time goes in the port's GANMF epoch on one CUDA card.

    python3 scripts/torch_profile_ganmf.py [--out build/profile_ganmf]

Builds GANMF at chip_smoke.py's ML-1M best params (num_factors=250,
emb_dim=992, batch_size=64) on its ML-1M-shaped synthetic split, fits one
epoch, then, in user and item mode, traces one more epoch (the same
ganmf_epoch the fit runs, on the next permutation) with torch.profiler. It
prints the wall time, the device time by kernel name, the device busy share
and the host operators with the most self time. The chrome traces go to
--out.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from torch_profile_serving import profile  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_ganmf")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from ganmf_tpu_torch.models import GANMF
    from ganmf_tpu_torch.models import ganmf as pgm
    from ganmf_tpu_torch.models.gan_base import make_batches, padded_weights, shuffled_padded_perm
    from ganmf_tpu_torch.utils.device import cuda_device

    card = chip_smoke.card_line()
    dev = cuda_device()
    p = chip_smoke.GANMF_PARAMS
    train, _ = chip_smoke.ml1m_split()
    for mode in ("user", "item"):
        model = GANMF(train, mode=mode, seed=chip_smoke.SEED, is_experiment=True, device=dev)
        model.fit(**p, epochs=1)
        n_rows = model._train_matrix().shape[0]
        n_batches, padded = make_batches(n_rows, p["batch_size"])
        urm = model._train_dense()
        w = torch.from_numpy(padded_weights(n_rows, padded)).to(dev)
        rng = np.random.RandomState(chip_smoke.SEED)

        def epoch():
            perm = torch.from_numpy(shuffled_padded_perm(rng, n_rows, padded)).to(dev, torch.int64)
            pgm.ganmf_epoch(model.params, model._d_opt, model._item_opt, model._user_adam, urm, perm, w,
                            g_lr=p["g_lr"], m=p["m"], recon_coefficient=p["recon_coefficient"],
                            d_reg=p["d_reg"], g_reg=0.0, n_batches=n_batches,
                            batch_size=p["batch_size"], d_steps=1, g_steps=1)

        print(f"GANMF {mode} mode: {n_batches} D and {n_batches} G minibatches an epoch")
        profile(f"ganmf_epoch_{mode}", epoch, args.out, card, host_ops=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
