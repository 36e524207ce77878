#!/usr/bin/env python3
"""Where the time goes in the port's CFGAN epoch and evaluation on one CUDA card.

    python3 scripts/torch_profile_cfgan.py [--out build/profile_cfgan]

Builds CFGAN at chip_smoke.py's published LastFM width (g_nodes=1024,
d_layers=5) on its LastFM-shaped synthetic split, fits one epoch, then, in
user and item mode, traces one more epoch (the same cfgan_epoch the fit
runs, with fresh draws) and one holdout evaluation with torch.profiler. For
each it prints the wall time, the device time by kernel name, the device
busy share, and the host operators with the most self time. The chrome
traces go to --out.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from torch_profile_serving import profile  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_cfgan")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import CFGAN
    from ganmf_tpu_torch.models import cfgan as pcf
    from ganmf_tpu_torch.utils.device import cuda_device

    card = chip_smoke.card_line()
    dev = cuda_device()
    train, test = chip_smoke.lastfm_split()
    for mode in ("user", "item"):
        model = CFGAN(train, mode=mode, seed=chip_smoke.SEED, is_experiment=True, device=dev)
        model.fit(**chip_smoke.CFGAN_PARAMS, epochs=1)
        urm, w, kw, _, _ = chip_smoke.cfgan_epoch_inputs(model._train_matrix())
        urm, w = urm.to(dev), w.to(dev)

        def epoch():
            uniforms = model._epoch_uniforms(urm.shape[0], urm.shape[1], kw["scheme"])
            pcf.cfgan_epoch(model.params, model._d_opt, model._g_opt, urm, uniforms, w, w, **kw)
            model.params = model.params  # drop the cached scores, as fit() does

        ev = EvaluatorHoldout(test, chip_smoke.CUTOFFS, device=dev)
        profile(f"cfgan_epoch_{mode}", epoch, args.out, card, host_ops=8)
        profile(f"cfgan_evaluate_{mode}", lambda: ev.evaluateRecommender(model), args.out, card,
                host_ops=8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
