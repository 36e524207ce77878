"""Training past the card's memory: the port's counterpart of
scripts/beyond_hbm_demo.py.

    python -m ganmf_tpu_torch.cli.beyond_hbm [model ...] [--out PATH]

The data is the JAX script's synthetic URM (``synthetic.synthetic_urm``:
DEMO_NNZ_PER_USER uniform item draws a user, duplicates merged) of DEMO_USERS
x DEMO_ITEMS (environment variables, default 131,072 x 65,536 and 100, as in
the JAX script), whose dense float32 form is U x I x 4 bytes. Each model
trains on ``urm_storage="csr"`` through its ``fit``, at the JAX script's
settings (scripts/beyond_hbm_demo.py:68-120), user mode, seed 1:

- ``ganmf``: K=64, emb_dim 256, batch 64;
- ``disganmf``: K=64, d_nodes 256, batch 128;
- ``cfgan``: d_nodes 64, g_nodes 256, ZR, zr_ratio 0.3, zr_coefficient 0.1,
  batches 128 (K2 and the keyed draw once a G minibatch);
- ``mfbpr`` (only when asked for, as in JAX): K=64, batch 256;
- ``ials``: K=64, alpha 5.

The steady epoch is the port's own synchronized clock: a GAN model's fit of
``GAN_EPOCHS`` epochs, each timed between synchronizes, gives the median of
the epochs after the first (the JAX script's fit-length differencing over
the same epochs); MF-BPR and IALS fit one epoch, then run ``_run_epoch`` once
untimed and twice timed, and give the faster (JAX's ``timeit(n=2)``).

Standard output: the JAX script's JSON lines (the shape line, then one line a
model, in the JAX script's order) with three more fields a model: ``peak_gib``
(``max_memory_allocated`` since a reset before the model is made; None on
the CPU), ``card`` (the card's name and power limit) and ``storage`` (the
URM storage the fit took). Every row, with each fit's walls, goes to
``--out`` (default chiprun_out/beyond_hbm.json; never PERF.json). The exit
code is nonzero when a model's peak passes ``PEAK_BOUND_GIB``, below the 32
GiB of a bool [U, I] mask at the largest shape the card runs. It runs on the
card unless ``main`` is given the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from ganmf_tpu_torch.cli.scale20m import (RouteError, begin, card_line, ials_storage, peak_gib, stop_clock,
                                          with_epoch_walls)
from ganmf_tpu_torch.data.synthetic import synthetic_urm
from ganmf_tpu_torch.utils.device import as_device

DEFAULT_USERS, DEFAULT_ITEMS, DEFAULT_NNZ_PER_USER = 131072, 65536, 100
SEED = 1  # the JAX script's models' seed
GAN_EPOCHS = 3  # the JAX script's epoch_time(n_epochs=3)
TIMED_EPOCHS = 2  # its timeit(n=2), after one untimed epoch
PEAK_BOUND_GIB = 16
# the JAX script's settings (scripts/beyond_hbm_demo.py:68-120)
GANMF_PARAMS = dict(num_factors=64, emb_dim=256, batch_size=64, urm_storage="csr")
DISGANMF_PARAMS = dict(num_factors=64, d_nodes=256, batch_size=128, urm_storage="csr")
CFGAN_PARAMS = dict(d_nodes=64, g_nodes=256, scheme="ZR", zr_ratio=0.3, zr_coefficient=0.1, d_batch_size=128,
                    g_batch_size=128, urm_storage="csr", allow_worse=None, freq=None)
MFBPR_PARAMS = dict(epochs=1, num_factors=64, batch_size=256, urm_storage="csr")
IALS_PARAMS = dict(epochs=1, num_factors=64, alpha=5.0, urm_storage="csr")


def demo_shape():
    """(users, items, interactions a user) from DEMO_USERS, DEMO_ITEMS and
    DEMO_NNZ_PER_USER, the JAX script's defaults where unset."""
    return (int(os.environ.get("DEMO_USERS", DEFAULT_USERS)), int(os.environ.get("DEMO_ITEMS", DEFAULT_ITEMS)),
            int(os.environ.get("DEMO_NNZ_PER_USER", DEFAULT_NNZ_PER_USER)))


def shape_row(train) -> dict:
    """The JAX script's first line (scripts/beyond_hbm_demo.py:47-60)."""
    U, I = train.shape
    return {"users": U, "items": I, "nnz": int(train.nnz), "dense_urm_gb": round(U * I * 4 / 2**30, 1),
            "padded_csr_gb_approx": round((train.nnz * 8 / 2**30) * 1.5, 2)}


def with_run_epoch_walls(model_class, device: torch.device):
    """``model_class`` whose ``_run_epoch`` appends its synchronized wall to
    ``epoch_walls`` (MF-BPR and IALS: their fits and the timed epochs)."""

    class Timed(model_class):
        epoch_walls = None

        def _run_epoch(self, num_epoch):
            if self.epoch_walls is None:
                self.epoch_walls = []
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            super()._run_epoch(num_epoch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self.epoch_walls.append(time.perf_counter() - t0)

    Timed.__name__ = Timed.__qualname__ = model_class.__name__
    return Timed


def _row(bench: str, s_per_epoch: float, device, card: str, storage: str) -> dict:
    return {"bench": bench, "s_per_epoch": round(s_per_epoch, 2), "peak_gib": peak_gib(device), "card": card,
            "storage": storage}


def _gan(model_class, name: str, params: dict, train, device, card: str, epochs: int):
    """A GAN model's csr fit of ``epochs`` epochs: (row, detail, model)."""
    U, I = train.shape
    begin(device)
    m = with_epoch_walls(model_class, device)(train, mode="user", seed=SEED, is_experiment=True, device=device)
    t0 = time.perf_counter()
    m.fit(epochs=epochs, **params)
    fit_s = stop_clock(device, next(m.params.parameters()).sum()) - t0
    if not m._urm_streams():
        raise RouteError(f"{name} must train on csr storage")
    steady = float(np.median(m.epoch_walls[1:] or m.epoch_walls))
    row = _row(f"{name} beyond-HBM csr epoch (U={U}, I={I})", steady, device, card, "csr (padded rows)")
    return row, {"fit_s": fit_s, "epoch_walls": m.epoch_walls, "s_per_epoch": steady}, m


def ganmf(train, device, card: str, epochs: int = GAN_EPOCHS):
    from ganmf_tpu_torch.models import GANMF

    return _gan(GANMF, "GANMF", GANMF_PARAMS, train, device, card, epochs)


def disganmf(train, device, card: str, epochs: int = GAN_EPOCHS):
    from ganmf_tpu_torch.models import DisGANMF

    return _gan(DisGANMF, "DisGANMF", DISGANMF_PARAMS, train, device, card, epochs)


def cfgan(train, device, card: str, epochs: int = GAN_EPOCHS):
    from ganmf_tpu_torch.models import CFGAN

    return _gan(CFGAN, "CFGAN", CFGAN_PARAMS, train, device, card, epochs)


def _timed_epochs(m, device, value, timed_epochs: int) -> float:
    """After the fit's epoch: one untimed ``_run_epoch`` and ``timed_epochs``
    timed ones, the fastest; the fit's epoch alone when ``timed_epochs`` is
    0."""
    if timed_epochs:
        for _ in range(timed_epochs + 1):
            m._run_epoch(0)
        stop_clock(device, value())
        return min(m.epoch_walls[-timed_epochs:])
    return m.epoch_walls[0]


def mfbpr(train, device, card: str, timed_epochs: int = TIMED_EPOCHS):
    from ganmf_tpu_torch.models import MatrixFactorization_BPR

    U, I = train.shape
    begin(device)
    m = with_run_epoch_walls(MatrixFactorization_BPR, device)(train, device=device)
    t0 = time.perf_counter()
    m.fit(**MFBPR_PARAMS)
    fit_s = stop_clock(device, m._state.U.sum()) - t0
    if m._tables.urm is not None:
        raise RouteError("MF-BPR must train on csr storage")
    s = _timed_epochs(m, device, lambda: m._state.U.sum(), timed_epochs)
    row = _row(f"MF-BPR beyond-HBM csr epoch (U={U}, I={I}, K=64)", s, device, card, "csr (padded rows)")
    return row, {"fit_s": fit_s, "epoch_walls": m.epoch_walls, "s_per_epoch": s}, m


def ials(train, device, card: str, timed_epochs: int = TIMED_EPOCHS):
    """IALS on csr storage; each orientation's storage is checked against
    JAX's rule."""
    from ganmf_tpu_torch.models import IALSRecommender

    U, I = train.shape
    begin(device)
    m = with_run_epoch_walls(IALSRecommender, device)(train, device=device)
    t0 = time.perf_counter()
    m.fit(**IALS_PARAMS)
    fit_s = stop_clock(device, m._U_dev.sum()) - t0
    kinds = ials_storage(m)
    s = _timed_epochs(m, device, lambda: m._U_dev.sum(), timed_epochs)
    storage = f"csr: users {kinds['users']}, items {kinds['items']}"
    row = _row(f"IALS beyond-HBM csr epoch (U={U}, I={I}, K=64)", s, device, card, storage)
    return row, {"fit_s": fit_s, "epoch_walls": m.epoch_walls, "s_per_epoch": s,
                 "chunks": [m._chunk_u, m._chunk_i], "cg_reads": sum(r for _, r in m.cg_log[-1])}, m


#: the JAX script's order (each model runs when named, whatever the order given)
STAGES = {"ganmf": ganmf, "disganmf": disganmf, "cfgan": cfgan, "mfbpr": mfbpr, "ials": ials}
DEFAULT_MODELS = ("ganmf", "disganmf", "cfgan", "ials")


def main(argv=None, device=None) -> int:
    """Run the models (the JAX script's default list, or those named) on the
    card (``device``: a caller may ask for the CPU); returns the exit code,
    nonzero when a model's peak passes ``PEAK_BOUND_GIB``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("models", nargs="*", metavar="model",
                    help=f"any of {', '.join(STAGES)} (default: {' '.join(DEFAULT_MODELS)})")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "beyond_hbm.json"))
    args = ap.parse_args(argv)
    unknown = sorted(set(args.models) - set(STAGES))
    if unknown:
        ap.error(f"unknown models {unknown}; the models are {', '.join(STAGES)}")
    which = args.models or DEFAULT_MODELS
    device = as_device(device)
    card = card_line() if device.type == "cuda" else str(device)

    U, I, per_user = demo_shape()
    t0 = time.perf_counter()
    train = synthetic_urm(U, I, per_user)
    synth_s = time.perf_counter() - t0
    print(json.dumps(shape_row(train)), flush=True)
    rows, detail = [], {"synthesize_s": synth_s}
    for name, stage in STAGES.items():
        if name not in which:
            continue
        row, detail[name], m = stage(train, device, card)
        del m
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    over = [r["bench"] for r in rows if r["peak_gib"] is not None and r["peak_gib"] >= PEAK_BOUND_GIB]
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    result: Dict[str, object] = {"card": card, "shape": shape_row(train), "rows": rows, "detail": detail,
                                 "peak_bound_gib": PEAK_BOUND_GIB, "over_bound": over}
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    if over:
        print(f"peak device memory at or past {PEAK_BOUND_GIB} GiB: {over}", file=sys.stderr, flush=True)
    return 1 if over else 0


if __name__ == "__main__":
    sys.exit(main())
