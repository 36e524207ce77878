#!/usr/bin/env python3
"""Where the time goes in the port's DisGANMF and CAAE epochs on one CUDA card.

    python3 scripts/torch_profile_models.py [--out build/profile_models]

DisGANMF at chip_smoke.py's tuned LastFM params on its LastFM-shaped split,
in user and item mode: fits one epoch, then traces one more (the epoch the fit
runs, on the next permutation). CAAE at the reference's ML-1M best params on
the ML-1M-shaped split: traces one whole epoch (its draws included, as fit
makes them) and its D phase alone (the epoch with g_steps = gpr_steps = 0:
the epoch-start tables, every negative and the serialized updates), whose
idle share is the host's share of the D phase. Each is traced with
torch.profiler after two warm calls; see scripts/torch_profile_serving.py for
what is printed. The chrome traces go to --out.
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
    ap.add_argument("--out", default="build/profile_models")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from ganmf_tpu_torch.data.device import dense_from_sparse
    from ganmf_tpu_torch.models import DisGANMF
    from ganmf_tpu_torch.models import caae as pca
    from ganmf_tpu_torch.models import disganmf as pdg
    from ganmf_tpu_torch.models.gan_base import make_batches, padded_weights, shuffled_padded_perm
    from ganmf_tpu_torch.utils.device import cuda_device

    card = chip_smoke.card_line()
    dev = cuda_device()

    p = chip_smoke.DISGANMF_PARAMS
    train, _ = chip_smoke.lastfm_split()
    for mode in ("user", "item"):
        model = DisGANMF(train, mode=mode, seed=chip_smoke.SEED, is_experiment=True, device=dev)
        model.fit(**p, epochs=1)
        n_rows = model._train_matrix().shape[0]
        n_batches, padded = make_batches(n_rows, p["batch_size"])
        urm = model._train_dense()
        w = torch.from_numpy(padded_weights(n_rows, padded)).to(dev)
        rng = np.random.RandomState(chip_smoke.SEED)

        def epoch():
            perm = torch.from_numpy(shuffled_padded_perm(rng, n_rows, padded)).to(dev, torch.int64)
            pdg.disganmf_epoch(model.params, model._d_opt, model._item_opt, model._user_adam, urm, perm, w,
                               g_lr=p["g_lr"], recon_coefficient=p["recon_coefficient"], d_reg=p["d_reg"],
                               g_reg=0.0, n_batches=n_batches, batch_size=p["batch_size"], d_steps=1,
                               g_steps=1, d_hidden_act=p["d_hidden_act"], lazy_user_adam=mode == "user")

        print(f"DisGANMF {mode} mode: {n_batches} D and {n_batches} G minibatches an epoch")
        profile(f"disganmf_epoch_{mode}", epoch, args.out, card, host_ops=10)

    c = chip_smoke.CAAE_PARAMS
    train, _ = chip_smoke.ml1m_split()
    n_users, n_items = train.shape
    coo = train.tocoo()
    n_chunks = int(np.ceil(coo.nnz / c["d_bsize"]))
    pad = n_chunks * c["d_bsize"] - coo.nnz
    users, items = (torch.from_numpy(np.concatenate([a, np.zeros(pad, a.dtype)]).astype(np.int64)).to(dev)
                    for a in (coo.row, coo.col))
    weight = torch.from_numpy(np.concatenate([np.ones(coo.nnz), np.zeros(pad)]).astype(np.float32)).to(dev)
    n_samples = max(1, 2 * int(np.median(np.ediff1d(train.indptr))))
    urm = dense_from_sparse(train, dev)
    g_dims = [n_items] + [c["g_units"]] * c["g_layers"] + [n_items]
    params = pca.init_params(n_users, n_items, c["num_factors"], g_dims,
                             torch.Generator().manual_seed(chip_smoke.SEED), dev)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    for name, steps in (("caae_epoch", 1), ("caae_d_phase", 0)):
        def epoch(steps=steps):
            draws = pca.draw_epoch(gen, dev, len(weight), n_users, n_items, c["d_steps"] * n_chunks * c["d_bsize"],
                                   steps, steps, 32, n_samples)
            pca.caae_epoch(params, urm, users, items, weight, draws, lr=c["lr"], beta=c["beta"], lmbda=0.5,
                           S=chip_smoke.CAAE_S, d_bsize=c["d_bsize"], n_d_chunks=n_chunks, d_steps=c["d_steps"],
                           g_steps=steps, gpr_steps=steps, m_batch=32, n_samples=n_samples)

        print(f"CAAE: {2 * c['d_steps'] * n_chunks} D updates of {3 * c['d_bsize']} rows, {steps} G and "
              f"{steps} G' steps")
        profile(name, epoch, args.out, card, host_ops=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
