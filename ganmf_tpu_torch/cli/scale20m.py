"""ML-20M at scale on one card: the port's counterpart of scripts/scale20m.py
and scripts/scale20m_explicit.py.

    python -m ganmf_tpu_torch.cli.scale20m [stage ...] [--out PATH] [--data-dir DIR] [--split-dir DIR]

The data is the ML-20M stand-in (``ganmf_tpu_torch.data.synthetic``: 138,493
users x 26,744 items, about 20M ratings, made from its seed where no
ratings.csv is found), parsed, reindexed, k-core filtered and split by the
port's reader: ``load_urms("20M")``'s steps, each timed, and one parse for
both the implicit split and the explicit one (``implicit=False``, seed 1337,
``min_ratings_user=2``, as scripts/scale20m_explicit.py:39-51 makes it).

Stages, at the JAX scripts' settings (each a function of the split, the
evaluator and the device, which a test can call small on the CPU):

- ``toppop``;
- ``puresvd``: K=128 on the route past ``_DENSE_URM_BYTE_LIMIT`` (the
  resident bf16 matrix, or the streamed products), evaluated, then
  ``serve_all(cutoff=20)``;
- ``ials``: K=96, alpha 5, reg 1e-2, csr storage, 6 epochs, then one timed
  ``_run_epoch`` (bench.py's row);
- ``itemknn``: cosine, topK 300, shrink 0, on JAX's route past the dense
  limit (the resident bf16 Gram where the device holds it, else the streamed
  one; timed alone first, with its share of the bf16 tensor-core peak), and
  evaluated through W's bf16 planes (from 20,000 items on);
- ``ganmf``: K=128, E=128, batch 512, csr storage, user mode, seed 1337, 30
  epochs (each epoch synchronized and timed);
- ``cfgan``: one csr epoch at CFGAN's published LastFM params (no metrics);
- ``ials_explicit`` and ``funksvd_explicit`` on the explicit split, with
  RMSE.

Each stage checks the route JAX's script takes and raises where another is
taken. Every clock stops after a synchronize and a value read back; each
model is evaluated twice (cutoffs 5/10/20/50, the explicit stages 5/10/20)
and the second evaluation is reported. Each stage's row goes to standard
output as one JSON line and all of them to ``--out`` (default
chiprun_out/scale20m.json, never SCALE20M.json). The card's name and power
limit come first; the receipt comes last and makes the exit code nonzero
when it fails: every personalized implicit model's MAP@20 above TopPop's,
every evaluation scoring all of ``usersToEvaluate``, IALS's explicit RMSE
finite, FunkSVD's below 1.01 x the global-mean RMSE (the stand-in's rating
values are iid, so the global mean is the floor no model beats).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.cli.experiment import DATASET_KWARGS, SEED
from ganmf_tpu_torch.data import synthetic
from ganmf_tpu_torch.data.splits import URM_SUFFIXES, SplitSet, load_reference_splits, make_experiment_splits, \
    save_experiment_splits
from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.utils.device import as_device

CUTOFFS = [5, 10, 20, 50]
EXPLICIT_CUTOFFS = [5, 10, 20]
# the JAX scripts' settings (scripts/scale20m.py:105-205, scripts/scale20m_explicit.py:94-109)
PURESVD_PARAMS = dict(num_factors=128)
IALS_PARAMS = dict(epochs=6, num_factors=96, alpha=5.0, reg=1e-2, urm_storage="csr")
ITEMKNN_PARAMS = dict(topK=300, shrink=0, similarity="cosine")
GANMF_PARAMS = dict(num_factors=128, emb_dim=128, batch_size=512, d_lr=1e-4, g_lr=1e-4, recon_coefficient=0.05,
                    m=5, urm_storage="csr", epochs=30)
IALS_EXPLICIT_PARAMS = dict(IALS_PARAMS, confidence_scaling="linear")
FUNKSVD_EXPLICIT_PARAMS = dict(epochs=16, num_factors=64, learning_rate=5e-3, sgd_mode="adagrad", batch_size=4096,
                               urm_storage="csr")  # samples_per_epoch: the split's train nnz
# CFGAN's published best params, user mode on LastFM (scripts/parity_check.py:46-54)
CFGAN_PARAMS = dict(
    g_nodes=1024, g_layers=1, g_hidden_act="tanh",
    d_nodes=4, d_layers=5, d_hidden_act="linear",
    scheme="ZR", zr_ratio=0.4515475140394092, zr_coefficient=0.05049684341469494,
    d_batch_size=128, g_batch_size=1024,
    d_lr=1e-4, g_lr=0.00018640602403973558, d_reg=1e-4, g_reg=1e-4, d_steps=1, g_steps=1,
)
#: the models the receipt holds above TopPop (the implicit split's)
PERSONALIZED = ("PureSVD", "IALS", "ItemKNN_cosine", "GANMF")
FUNKSVD_FLOOR_SHARE = 1.01
EVALS = 2  # evaluations a model: the second is reported
F32_FLOPS = 67e12  # an H100 SXM's float32 rate outside the tensor cores (NVIDIA's data sheet)
BF16_FLOPS = 989e12  # its dense bf16 tensor-core rate (the same data sheet)


class RouteError(RuntimeError):
    """A stage took another route than the JAX scale script's."""


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


# -- data -------------------------------------------------------------------------

def default_data_dir() -> str:
    return os.environ.get("GANMF_TPU_DATA", os.path.join("datasets", "all_datasets"))


def read_urm(data_dir: str, log: Callable = print):
    """(full URM, seconds, parser) of the stand-in's ratings.csv under
    ``data_dir``: ``Movielens("20M")``'s parse and reindex, without its
    split. Raises FileNotFoundError when the file is missing: nothing is
    downloaded."""
    from ganmf_tpu_torch.data.datasets import Movielens
    from ganmf_tpu_torch.ops import host

    path = synthetic.ratings_path(data_dir)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} is missing: write it with ganmf_tpu_torch.data.synthetic.synthesize "
                                "(nothing is downloaded)")
    parser = "native" if host.get_lib() is not None else "python"
    log(f"parsing {path} ({os.path.getsize(path) / 1e6:.0f} MB) with the {parser} parser"
        + ("" if parser == "native" else f" (the host engine: {host.build_error})"))
    t0 = time.perf_counter()
    reader = Movielens(version="20M", data_dir=data_dir, **dict(DATASET_KWARGS, split=False))
    return reader.urm, time.perf_counter() - t0, parser


def load_splits(data_dir: str, split_dir: Optional[str] = None, explicit: bool = False, log: Callable = print):
    """(implicit SplitSet, explicit SplitSet or None, walls and parser).

    The implicit split is ``load_urms("20M")``'s: loaded from ``split_dir``
    when its five files are there, else built from the parsed URM with seed
    1337 and saved there. The explicit one (``explicit=True``) is built from
    the same URM with ``implicit=False``."""
    info: Dict[str, object] = {}
    implicit = urm = None
    if split_dir is not None and all(os.path.isfile(os.path.join(split_dir, "20M" + s)) for s in URM_SUFFIXES):
        t0 = time.perf_counter()
        implicit = load_reference_splits("20M", split_dir)
        info["load_s"] = time.perf_counter() - t0
        log(f"implicit split loaded from {split_dir} in {info['load_s']:.2f} s")
    if implicit is None or explicit:
        urm, info["read_s"], info["parser"] = read_urm(data_dir, log)
        log(f"parsed and reindexed: {urm.shape[0]:,} x {urm.shape[1]:,}, {urm.nnz:,} ratings in "
            f"{info['read_s']:.2f} s")
    if implicit is None:
        t0 = time.perf_counter()
        implicit = make_experiment_splits(urm, seed=SEED)
        info["split_s"] = time.perf_counter() - t0
        log(f"implicit five-way split in {info['split_s']:.2f} s")
        if split_dir is not None:
            t0 = time.perf_counter()
            save_experiment_splits(implicit, "20M", split_dir)
            info["save_s"] = time.perf_counter() - t0
            log(f"saved under {split_dir} in {info['save_s']:.2f} s")
    explicit_split = None
    if explicit:
        t0 = time.perf_counter()
        explicit_split = make_experiment_splits(urm, seed=SEED, implicit=False)
        info["explicit_split_s"] = time.perf_counter() - t0
        log(f"explicit five-way split in {info['explicit_split_s']:.2f} s")
    return implicit, explicit_split, info


# -- timing -----------------------------------------------------------------------

def stop_clock(device: torch.device, value) -> float:
    """The clock after the device finished: a synchronize, then ``value`` (a
    tensor) read back."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    float(value.detach())
    return time.perf_counter()


def begin(device: torch.device) -> None:
    """Start a stage: the device's peak memory counter reset."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device) -> Optional[float]:
    """The device's peak memory since ``begin``, in GiB (None on the CPU)."""
    return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None


def evaluate(ev: EvaluatorHoldout, model):
    """(results, walls) of ``EVALS`` evaluations (each ends in the
    evaluator's host copy of its sums)."""
    walls = []
    for _ in range(EVALS):
        t0 = time.perf_counter()
        results, _ = ev.evaluateRecommender(model)
        walls.append(time.perf_counter() - t0)
    return results, walls


def with_epoch_walls(model_class, device: torch.device):
    """``model_class`` whose fit times each epoch between synchronizes into
    ``epoch_walls``."""

    class Timed(model_class):
        def _run_training_loop(self, *args, epoch_fn, **kwargs):
            self.epoch_walls = []

            def run(epoch):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                epoch_fn(epoch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                self.epoch_walls.append(time.perf_counter() - t0)

            return super()._run_training_loop(*args, epoch_fn=run, **kwargs)

    Timed.__name__ = Timed.__qualname__ = model_class.__name__
    return Timed


def row(results, fit_s, walls, ev, route, device, **extra) -> dict:
    """A stage's row: the metrics at 20 (and RMSE on explicit ratings), the
    fit and the second evaluation's walls, the users scored and the route."""
    at20 = results[20]
    eval_s = walls[-1]
    out = {"MAP@20": float(at20["MAP"]), "NDCG@20": float(at20["NDCG"]), "RECALL@20": float(at20["RECALL"])}
    if not np.all(ev.URM_test.data == 1.0):
        out["RMSE"] = float(at20["RMSE"])
    out.update(fit_s=fit_s, eval_s=eval_s, eval_first_s=walls[0], eval_users_per_s=ev.users_scored / eval_s,
               n_eval_users=ev.users_scored, users_to_evaluate=len(ev.usersToEvaluate), route=route,
               peak_gib=peak_gib(device), **extra)
    return out


# -- stages -----------------------------------------------------------------------

def toppop(split: SplitSet, ev, device):
    from ganmf_tpu_torch.models import TopPop

    begin(device)
    m = TopPop(split.train, device=device)
    t0 = time.perf_counter()
    m.fit()
    fit_s = stop_clock(device, m._pop_device.sum()) - t0
    results, walls = evaluate(ev, m)
    return row(results, fit_s, walls, ev, "dense ranking", device), m


def puresvd(split: SplitSet, ev, device, omega=None, **overrides):
    """PureSVD past ``_DENSE_URM_BYTE_LIMIT`` (scripts/scale20m.py:123), then
    ``serve_all(cutoff=20)`` twice, the second timed. ``omega`` is the fit's
    test matrix (drawn from its seed when None)."""
    from ganmf_tpu_torch.models import PureSVDRecommender

    begin(device)
    m = PureSVDRecommender(split.train, device=device)
    if not m._urm_streams():
        raise RouteError("PureSVD must take the route past _DENSE_URM_BYTE_LIMIT (resident or streamed)")
    route = m.fit_route()
    t0 = time.perf_counter()
    m.fit(**dict(PURESVD_PARAMS, **overrides), omega=omega)
    fit_s = stop_clock(device, m._factors_device()[0].sum()) - t0
    results, walls = evaluate(ev, m)
    serve = []
    for _ in range(2):
        t0 = time.perf_counter()
        ids, scores = m.serve_all(cutoff=20)  # host arrays: the device finished
        serve.append(time.perf_counter() - t0)
    if ids.shape != (m.n_users, 20) or not np.isfinite(scores[:, 0]).all():
        raise RuntimeError(f"serve_all gave {ids.shape} ids, or a user without a finite first score")
    return row(results, fit_s, walls, ev, route, device, serve_s=serve[-1], serve_first_s=serve[0],
               serve_users_per_s=m.n_users / serve[-1]), m


def ials_storage(m) -> Dict[str, str]:
    """Each orientation's storage ("padded" or "flat") of an IALS model fit
    on csr storage; raises RouteError where it is not the one JAX's rule
    gives (padded planes of 8 bytes a slot past ``_PAD_PLANE_BYTE_LIMIT``
    take flat CSR, ganmf_tpu/models/ials.py:333-347)."""
    from ganmf_tpu_torch.models import ials as ials_mod

    kinds = {}
    for name, csr in (("users", m.URM_train), ("items", m.URM_train.T.tocsr())):
        L = max(int(np.ediff1d(csr.indptr).max()) if csr.shape[0] else 0, 1)
        want = "flat" if 8 * csr.shape[0] * L > ials_mod._PAD_PLANE_BYTE_LIMIT else "padded"
        kinds[name] = getattr(m, f"_store_{name}")[0]
        if kinds[name] != want:
            raise RouteError(f"IALS's {name} took {kinds[name]} storage where JAX's rule gives {want}")
    return kinds


def ials(split: SplitSet, ev, device, **overrides):
    """IALS on csr storage, then one timed ``_run_epoch`` (bench.py:227-237).
    Each orientation's storage is the one JAX's rule picks, and at least one
    is flat CSR, the form a head-heavy orientation takes at scale."""
    from ganmf_tpu_torch.models import IALSRecommender

    params = dict(IALS_PARAMS, **overrides)
    begin(device)
    m = IALSRecommender(split.train, device=device)
    t0 = time.perf_counter()
    m.fit(**params)
    fit_s = stop_clock(device, m._U_dev.sum()) - t0
    kinds = ials_storage(m)
    if "flat" not in kinds.values():
        raise RouteError(f"IALS took no flat-CSR storage ({kinds})")
    t0 = time.perf_counter()
    m._run_epoch(0)
    epoch_s = stop_clock(device, m._U_dev.sum()) - t0
    cg = m.cg_log[-1]
    results, walls = evaluate(ev, m)
    route = f"csr: users {kinds['users']}, items {kinds['items']}"
    return row(results, fit_s, walls, ev, route, device, epoch_s=epoch_s, cg_chunks=len(cg),
               cg_iterations=sum(it for it, _ in cg), cg_reads=sum(r for _, r in cg)), m


def itemknn(split: SplitSet, ev, device, **overrides):
    """ItemKNN on JAX's route past the dense limit (scripts/scale20m.py:188-189
    asserts only "not dense"): its Gram is first built alone and timed. On
    the binary split that route is resident or streamed, bf16 products
    either way; the evaluation scores through W's bf16 planes where the
    catalog has ``_SIM_SPLIT_MIN_ITEMS`` items."""
    from ganmf_tpu_torch.models import ItemKNNCFRecommender
    from ganmf_tpu_torch.ops import similarity

    n_rows, n_cols = split.train.shape
    X = sps.csr_matrix(split.train, dtype=np.float32)
    binary = bool(X.nnz == 0 or np.all(X.data == 1.0))
    row_len = max(int(np.ediff1d(X.indptr).max()), 1)
    route = similarity.build_route(n_rows, n_cols, binary=binary, row_len=row_len, device=device)
    if route not in ("resident", "streamed"):
        raise RouteError(f"ItemKNN must take the resident or the streamed Gram past the dense limit, took {route}")
    begin(device)
    ones = torch.ones(n_rows, dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    G, _, got = similarity.build_gram(X, ones, False, device, binary)
    gram_s = stop_clock(device, G[0, 0]) - t0
    del G
    if got != route:
        raise RouteError(f"ItemKNN's Gram took {got} where build_route gives {route}")
    # the product over the rows padded to its chunk: 2 R I^2 FLOP
    rows = -(-n_rows // similarity._STREAM_CHUNK) * similarity._STREAM_CHUNK
    gram_flop = 2.0 * rows * n_cols * n_cols
    m = ItemKNNCFRecommender(split.train, device=device)
    t0 = time.perf_counter()
    m.fit(**dict(ITEMKNN_PARAMS, **overrides))
    W = m._device_w
    fit_s = stop_clock(device, W.sum() if isinstance(W, torch.Tensor) else torch.tensor(m.W_sparse.nnz)) - t0
    planes = isinstance(m._w_device(), torch.Tensor) and m._splits_w()
    results, walls = evaluate(ev, m)
    peak = BF16_FLOPS if binary else F32_FLOPS
    return row(results, fit_s, walls, ev, f"{route} {'bf16' if binary else 'float32'} Gram, "
               f"{'bf16 planes' if planes else 'float32'} scoring", device, gram_s=gram_s, gram_flop=gram_flop,
               gram_peak_share=gram_flop / gram_s / peak, gram_peak="bf16" if binary else "float32"), m


def ganmf(split: SplitSet, ev, device, **overrides):
    """GANMF on csr storage, user mode, seed 1337; the steady epoch is the
    median of the synchronized epochs after the first."""
    from ganmf_tpu_torch.models import GANMF

    params = dict(GANMF_PARAMS, **overrides)
    begin(device)
    m = with_epoch_walls(GANMF, device)(split.train, mode="user", seed=SEED, is_experiment=True, device=device)
    t0 = time.perf_counter()
    m.fit(**params)
    fit_s = stop_clock(device, m.params.user_emb.sum()) - t0
    if not m._urm_streams():
        raise RouteError("GANMF must train on csr storage")
    steady = m.epoch_walls[1:] or m.epoch_walls
    results, walls = evaluate(ev, m)
    return row(results, fit_s, walls, ev, "csr", device, epoch_s=float(np.median(steady)),
               first_epoch_s=m.epoch_walls[0], epochs=len(m.epoch_walls)), m


def cfgan(split: SplitSet, device):
    """One CFGAN csr epoch at the published LastFM params (ROADMAP's third
    ML-20M row), user mode: its synchronized wall and the fit's launches of
    K2 and the keyed draw, no metrics."""
    from ganmf_tpu_torch.models import CFGAN
    from ganmf_tpu_torch.utils.profiling import counters

    begin(device)
    m = with_epoch_walls(CFGAN, device)(split.train, seed=SEED, is_experiment=True, device=device)
    before = counters()
    t0 = time.perf_counter()
    m.fit(**CFGAN_PARAMS, epochs=1, urm_storage="csr")
    fit_s = stop_clock(device, next(m.params.parameters()).sum()) - t0
    if not m._urm_streams():
        raise RouteError("CFGAN must train on csr storage")
    after = counters()
    k2, drawn = (after.get(k, 0) - before.get(k, 0) for k in ("k2.launches", "keyed.launches"))
    return {"fit_s": fit_s, "epoch_s": m.epoch_walls[0], "k2_launches": k2, "keyed_launches": drawn,
            "route": "csr", "peak_gib": peak_gib(device)}, m


def global_mean_rmse(split: SplitSet) -> float:
    """The RMSE of predicting the training mean at every held-out pair."""
    mu = float(split.train.data.mean())
    return float(np.sqrt(np.mean((split.test.data - mu) ** 2)))


def ials_explicit(split: SplitSet, ev, device, **overrides):
    r, m = ials(split, ev, device, **dict(IALS_EXPLICIT_PARAMS, **overrides))
    return dict(r, global_mean_rmse=global_mean_rmse(split)), m


def funksvd_explicit(split: SplitSet, ev, device, **overrides):
    """FunkSVD on the rating values, csr storage, an epoch of train-nnz
    samples."""
    from ganmf_tpu_torch.models import MatrixFactorization_FunkSVD

    params = dict(FUNKSVD_EXPLICIT_PARAMS, samples_per_epoch=split.train.nnz, **overrides)
    begin(device)
    m = MatrixFactorization_FunkSVD(split.train, device=device)
    t0 = time.perf_counter()
    m.fit(**params)
    fit_s = stop_clock(device, m._state.U.sum()) - t0
    results, walls = evaluate(ev, m)
    return row(results, fit_s, walls, ev, "csr", device, global_mean_rmse=global_mean_rmse(split)), m


#: stage name -> (row key, function, split it runs on)
STAGES = {
    "toppop": ("TopPop", toppop, "implicit"),
    "puresvd": ("PureSVD", puresvd, "implicit"),
    "ials": ("IALS", ials, "implicit"),
    "itemknn": ("ItemKNN_cosine", itemknn, "implicit"),
    "ganmf": ("GANMF", ganmf, "implicit"),
    "cfgan": ("CFGAN_csr", cfgan, "implicit"),
    "ials_explicit": ("IALS_explicit", ials_explicit, "explicit"),
    "funksvd_explicit": ("FunkSVD_explicit", funksvd_explicit, "explicit"),
}


# -- the receipt ------------------------------------------------------------------

def receipt(rows: Dict[str, dict], log: Callable = print) -> bool:
    """The JAX scripts' receipt on the rows present: each personalized
    implicit model above TopPop on MAP@20, every evaluation over all of
    ``usersToEvaluate``, IALS's explicit RMSE finite, FunkSVD's within 1% of
    the global-mean floor. Prints a line a check; True when all pass."""
    ok = True

    def check(passed: bool, line: str):
        nonlocal ok
        ok = ok and passed
        log(f"CONSISTENCY {line} -> {'OK' if passed else 'FAIL'}")

    if "TopPop" in rows:
        floor = rows["TopPop"]["MAP@20"]
        for key in PERSONALIZED:
            if key in rows:
                check(rows[key]["MAP@20"] > floor, f"{key}: MAP@20 {rows[key]['MAP@20']:.6f} vs TopPop {floor:.6f}")
    for key, r in rows.items():
        if "n_eval_users" in r:
            check(r["n_eval_users"] == r["users_to_evaluate"],
                  f"{key}: {r['n_eval_users']} users scored of {r['users_to_evaluate']} to evaluate")
    if "IALS_explicit" in rows:
        check(bool(np.isfinite(rows["IALS_explicit"]["RMSE"])), f"IALS_explicit: RMSE {rows['IALS_explicit']['RMSE']}")
    if "FunkSVD_explicit" in rows:
        r = rows["FunkSVD_explicit"]
        check(bool(np.isfinite(r["RMSE"])) and r["RMSE"] < FUNKSVD_FLOOR_SHARE * r["global_mean_rmse"],
              f"FunkSVD_explicit: RMSE {r['RMSE']:.6f} vs {FUNKSVD_FLOOR_SHARE} x the global-mean "
              f"{r['global_mean_rmse']:.6f}")
    return ok


# -- the command ------------------------------------------------------------------

def main(argv=None, device=None) -> int:
    """Run the stages (all by default) on the card (``device``: a caller may
    ask for the CPU); returns the exit code, nonzero when the receipt
    fails."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", metavar="stage", help=f"any of {', '.join(STAGES)} (default: all)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "scale20m.json"))
    ap.add_argument("--data-dir", default=None, help="where ml-20m/ratings.csv is (default $GANMF_TPU_DATA)")
    ap.add_argument("--split-dir", default=os.path.join("experiments", "datasets"))
    args = ap.parse_args(argv)
    unknown = sorted(set(args.stages) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}; the stages are {', '.join(STAGES)}")
    stages = args.stages or list(STAGES)
    device = as_device(device)
    card = card_line() if device.type == "cuda" else str(device)
    print(card, flush=True)
    log = lambda line: print(line, flush=True)  # noqa: E731

    data_dir = args.data_dir or default_data_dir()
    t0 = time.perf_counter()
    synthetic.synthesize(synthetic.ratings_path(data_dir), verbose=True)
    synth_s = time.perf_counter() - t0
    explicit = any(STAGES[s][2] == "explicit" for s in stages)
    implicit, explicit_split, info = load_splits(data_dir, args.split_dir, explicit=explicit, log=log)
    info["synthesize_s"] = synth_s
    splits = {"implicit": implicit, "explicit": explicit_split}
    evaluators = {}
    rows: Dict[str, dict] = {}
    for stage in stages:
        key, fn, which = STAGES[stage]
        split = splits[which]
        if stage == "cfgan":
            r, m = fn(split, device)
        else:
            if which not in evaluators:
                evaluators[which] = EvaluatorHoldout(split.test, CUTOFFS if which == "implicit" else EXPLICIT_CUTOFFS,
                                                     device=device)
                log(f"{which} split: {split.train.shape[0]:,} x {split.train.shape[1]:,}, train nnz "
                    f"{split.train.nnz:,}, test nnz {split.test.nnz:,}; "
                    f"{len(evaluators[which].usersToEvaluate):,} users to evaluate")
            r, m = fn(split, evaluators[which], device)
        del m
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows[key] = r
        log("ROW " + json.dumps({key: r}))
    ok = receipt(rows, log)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "data": info, "rows": rows, "receipt_ok": ok}, fh, indent=1)
    log(f"rows written to {args.out}; receipt {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
