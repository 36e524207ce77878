"""Graft entry points: a compile check and a multi-rank dry run.

The port's counterpart of __graft_entry__.py:

- ``entry(device)`` returns ``(fn, example_args)``: fn computes GANMF's
  discriminator and generator losses on one minibatch of a 64 x 48 toy (the
  body every training step differentiates), as JAX's ``entry`` (:10-30).
- ``dryrun_multichip(n, device)`` runs, on n ranks joined by
  ``torch.distributed``, one distributed GANMF step, ``sharded_topk``, the
  distributed-Cholesky EASE-R, the mesh evaluator on TopPop and flat-CSR
  IALS on a (data, model) plan, and when n % 4 == 0 again on (slice 2,
  data n / 4, model 2) (JAX :33-153). With at least n cards each rank takes
  its own over NCCL; with fewer, n gloo ranks share card 0; with
  ``device="cpu"``, n gloo ranks on the CPU. The ranks are subprocesses of
  this module; a failed or timed-out rank raises ``RuntimeError`` with its
  log.

    python -m ganmf_tpu_torch.graft [--device cpu]

prints ``entry ok: [dloss, gloss]`` (fn under ``torch.compile``), runs
``dryrun_multichip(8)`` and prints ``dryrun ok``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.utils.device import as_device

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds the dry run's ranks may take in all (JAX :140)
DRYRUN_TIMEOUT = 900


def entry(device=None):
    """(fn, example_args): GANMF's (dloss, gloss) on one minibatch at JAX's
    shapes and constants (64 users x 48 items, K=8, E=16, B=16), the
    parameters from ``init_params`` with a seeded generator and ``real`` a
    seeded uniform below 0.2. ``device`` defaults to the card."""
    from ganmf_tpu_torch.models.ganmf import _losses, init_params

    device = as_device(device)
    n_users, n_items, K, E, B = 64, 48, 8, 16, 16
    params = init_params(n_users, n_items, K, E, torch.Generator().manual_seed(0), device)
    uids = torch.arange(B, device=device)
    real = (torch.rand((B, n_items), generator=torch.Generator().manual_seed(1)) < 0.2).float().to(device)
    w = torch.ones(B, device=device)

    def fn(params, uids, real, w):
        return _losses(params, uids, real, w, m=1.0, recon_coefficient=0.1, d_reg=1e-4, g_reg=1e-4)

    return fn, (params, uids, real, w)


def _dryrun_plan(n_devices: int, n_slices: int, device):
    """JAX's plan for n devices (:43-45): model 2 where n is even, the rest
    on data."""
    from ganmf_tpu_torch.parallel import make_mesh

    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return make_mesh(n_data=n_devices // (n_model * n_slices), n_model=n_model, n_slices=n_slices, device=device)


def _dryrun_impl(plan) -> None:
    """The dry run on this rank's ``plan`` (JAX :33-106), step by step with
    JAX's shapes and asserts."""
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import IALSRecommender, TopPop
    from ganmf_tpu_torch.models import ials as ials_mod
    from ganmf_tpu_torch.ops.distchol import ease_r_topk_sharded
    from ganmf_tpu_torch.ops.topk import sharded_topk
    from ganmf_tpu_torch.parallel import init_distributed, make_distributed_ganmf_step
    from ganmf_tpu_torch.parallel.distributed import gather_module

    dev = plan.device
    n_rows = plan.n_data * plan.n_slices
    n_users, n_items, K, E, B = 8 * n_rows, 8 * plan.n_model, 4, 8, 2 * n_rows
    params, d_opt, g_opt = init_distributed(0, n_users, n_items, K, E, plan)

    rng = np.random.RandomState(0)
    urm_full = torch.from_numpy((rng.rand(n_users, n_items) < 0.3).astype(np.float32)).to(dev)
    urm = plan.put(urm_full, plan.urm)
    uids = torch.arange(B, device=dev)
    w = torch.ones(B, device=dev)

    step = make_distributed_ganmf_step(plan, m=1.0, recon_coefficient=0.1, d_reg=1e-4, g_reg=1e-4)
    params, d_opt, g_opt, dloss, gloss = step(params, d_opt, g_opt, urm, uids, w, 1e-3, 1e-3)
    assert np.isfinite(float(dloss)) and np.isfinite(float(gloss))

    # sharded evaluation: this rank's item columns of the scores, then the
    # all-gather top-k merge
    user_emb = gather_module(params, plan).user_emb
    scores = user_emb.index_select(0, uids) @ params.item_emb.T
    vals, idx = sharded_topk(scores, k=4, plan=plan)
    assert vals.shape == (B, 4) and idx.shape == (B, 4)

    # the column-sharded blocked Cholesky EASE-R build
    if plan.n_model > 1:
        ev_vals, ev_idx = ease_r_topk_sharded(urm_full, 5.0, k=4, plan=plan, panel=8)
        assert ev_vals.shape == (n_items, 4) and ev_idx.shape == (n_items, 4)

    # end to end through the mesh evaluator
    U, I = 16 * n_rows, 16 * plan.n_model
    train = sps.csr_matrix((np.random.RandomState(1).rand(U, I) < 0.3).astype(np.float32))
    test = sps.csr_matrix((np.random.RandomState(2).rand(U, I) < 0.1).astype(np.float32))
    model = TopPop(train, device=dev)
    model.fit()
    ev = EvaluatorHoldout(test, cutoff_list=[4], mesh_plan=plan, device=dev)
    res, _ = ev.evaluateRecommender(model)
    assert np.isfinite(res[4]["MAP"])

    # sharded flat-CSR IALS, forced at these shapes
    old_limit = ials_mod._PAD_PLANE_BYTE_LIMIT
    ials_mod._PAD_PLANE_BYTE_LIMIT = 1
    try:
        ials = IALSRecommender(train, device=dev)
        ials.fit(epochs=1, num_factors=4, urm_storage="csr", mesh_plan=plan)
        assert ials._store_users[0] == "flat"
        assert bool(torch.isfinite(ials._U_dev).all())
    finally:
        ials_mod._PAD_PLANE_BYTE_LIMIT = old_limit


def _dryrun_rank(rank: int, n_devices: int, port: int, mode: str) -> None:
    """One rank of ``dryrun_multichip``: joins the world, runs the (data,
    model) plan and, when n % 4 == 0, the (slice 2, data n / 4, model 2)
    one."""
    from ganmf_tpu_torch.parallel import comm

    if mode == "nccl":
        kw = dict(local_rank=rank, backend="nccl")
    elif mode == "gloo-card":
        kw = dict(local_rank=0, backend="gloo")
    else:
        kw = dict(device="cpu")
    comm.initialize(f"tcp://127.0.0.1:{port}", n_devices, rank, **kw)
    device = "cpu" if mode == "cpu" else None
    try:
        _dryrun_impl(_dryrun_plan(n_devices, 1, device))
        if n_devices % 4 == 0:
            _dryrun_impl(_dryrun_plan(n_devices, 2, device))
    finally:
        comm.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the dry run on ``n_devices`` ranks, each a subprocess of this
    module (JAX :109-153): NCCL ranks on a card each where there are
    ``n_devices`` cards, else gloo ranks sharing card 0; with
    ``device="cpu"``, gloo ranks on the CPU. Without a card and without
    ``device="cpu"`` it raises."""
    if device is not None and torch.device(device).type == "cpu":
        mode = "cpu"
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the dry run on the CPU")
    else:
        mode = "nccl" if torch.cuda.device_count() >= n_devices else "gloo-card"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (_REPO, os.environ.get("PYTHONPATH")) if p))
    if mode == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    logs = [tempfile.TemporaryFile("w+") for _ in range(n_devices)]
    procs = [subprocess.Popen([sys.executable, "-m", "ganmf_tpu_torch.graft", "--dryrun-rank", str(r),
                               str(n_devices), str(port), mode], cwd=_REPO, env=env, stdout=log,
                              stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + DRYRUN_TIMEOUT
    try:
        for proc in procs:
            proc.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = []
    for r, (proc, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode != 0:
            failed.append(f"--- rank {r} (rc={proc.returncode}) ---\n{text[-4000:]}")
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed on {len(failed)} of {n_devices} ranks ({mode})\n"
                           + "\n".join(failed))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dryrun-rank"]:
        rank, n, port, mode = int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
        _dryrun_rank(rank, n, port, mode)
        return 0
    device = argv[1] if argv[:1] == ["--device"] else None
    fn, args = entry(device)
    out = torch.compile(fn)(*args)
    print("entry ok:", [float(x.detach()) for x in out])
    dryrun_multichip(8, device)
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
