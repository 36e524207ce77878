"""Training epochs back to back, through ``GANMF.fit``'s own loop.

One ``fit`` call builds the model, its optimizers and its state and runs
every epoch of the run: its first ``check_epochs`` are the steps the
reference follows, then ``warmup_epochs``, then the window, which ends at the
first epoch boundary past ``--seconds``, and with ``--trace 1`` a traced
window of ``trace_epochs``. A ``metrics_logger`` whose ``log_epoch`` runs at
each epoch's end takes the snapshots, reads the host clock (synchronizing
only where a window opens or closes) and calls ``stop_fit``.

The comparison covers the start of the fit and the window's last epoch.
Traffic parameters: ``check_epochs``, ``warmup_epochs``, ``trace_epochs``.
Compared numbers, from the seed over the checked epochs:
``loss_gap`` (each checked epoch's mean D and G loss), ``moment_gap`` (after
the first epoch, the norm of each leaf's first Adam moment, the gradient as
the optimizers hold it), ``change_gap`` (the norm of each leaf's change over
the checked epochs). The window's last epoch is copied at its start (the
program's tensors, Adam moments and step counts, one device copy an epoch)
and the reference runs that epoch from the copy, with its shuffle stream
advanced to it: ``window_loss_gap``, ``window_moment_gap`` (the first moments
after it) and ``window_change_gap`` (each leaf's change over it).
"""

from __future__ import annotations

import time

import torch

from benchmark import counters, judge
from benchmark.data import movielens_shaped
from benchmark.harness import Outcome, Run
from benchmark.reference import ganmf as ref_ganmf
from benchmark.reference import set_tf32

LEAVES = ref_ganmf.LEAVES


def training_state(model) -> dict:
    """The live tensors of the program's training state by name, as
    ``Trainer.resume`` takes them: each leaf (``p.``), its two Adam moments
    (``m.``, ``v.``) and its step count (``t.``), from the checkpoint layout
    of the program's state. A leaf that an optimizer holds no state for has
    not been stepped: zeros."""
    st = model._checkpoint_state()
    params = {k: p.detach() for k, p in model.params.named_parameters()}
    out = {f"p.{k}": params[k] for k in LEAVES}

    def adam(state, i, k):
        s = state.get(i)
        if s is None:
            return torch.zeros_like(params[k]), torch.zeros_like(params[k]), torch.zeros(())
        return s["exp_avg"], s["exp_avg_sq"], s["step"]

    slots = [(st["d_state"]["state"], i, k) for i, k in enumerate(ref_ganmf.D_LEAVES)]
    for state, i, k in slots + [(st["item_state"]["state"], 0, "item_emb")]:
        out[f"m.{k}"], out[f"v.{k}"], out[f"t.{k}"] = adam(state, i, k)
    user = st["user_state"]
    out["m.user_emb"], out["v.user_emb"], out["t.user_emb"] = user["m"], user["v"], user["t"]
    return out


def first_moments(model) -> dict:
    """Each leaf's first Adam moment, the gradient as the optimizers hold it."""
    live = training_state(model)
    return {k: live[f"m.{k}"].clone() for k in LEAVES}


class EpochClock:
    """The ``metrics_logger`` that drives the run's phases from inside
    ``fit``."""

    def __init__(self, run: Run, model, traffic: dict):
        self.run, self.model = run, model
        self.check = int(traffic["check_epochs"])
        self.setup_epochs = self.check + int(traffic["warmup_epochs"])
        self.trace_epochs = int(traffic["trace_epochs"])
        self.moments = None
        self.params = None
        self.start = self.end = None  # the state before and after the window's last epoch
        self.last_epoch = None
        self.phase = "setup"
        self.epochs = self.traced = 0
        self.t_start = self.wall = None
        self.stamps = []
        self._span = None
        self._phases = list(run.tracer.phases())

    def _open_span(self):
        self._span = self.run.tracer.span("fit_epoch")
        self._span.__enter__()

    def _close_span(self):
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None

    def _copy_state(self) -> None:
        """The state into ``start``: the start of the epoch that follows."""
        live = training_state(self.model)
        if self.start is None:
            self.start = {k: torch.empty_like(v) for k, v in live.items()}
        for k, v in live.items():
            self.start[k].copy_(v)

    def log_epoch(self, epoch: int) -> None:
        run = self.run
        if self.phase == "setup":
            run.mark(f"epoch {epoch} launched")
        if epoch == 1:
            self.moments = first_moments(self.model)
        if epoch == self.check:
            self.params = {k: p.detach().clone() for k, p in self.model.params.named_parameters()}
        if self.phase == "setup":
            if epoch == self.setup_epochs:
                self._copy_state()
                run.setup_done()
                self.t_start = time.perf_counter()
                self.stamps.append((self.t_start, time.thread_time()))
                self.phase = "window"
            return
        if self.phase == "window":
            self.epochs += 1
            self.stamps.append((time.perf_counter(), time.thread_time()))
            if time.perf_counter() - self.t_start >= run.seconds:
                run.sync()
                self.wall = time.perf_counter() - self.t_start
                self.end = {k: v.clone() for k, v in training_state(self.model).items()}
                self.last_epoch = epoch
                self._next_phase()
            else:
                self._copy_state()
            return
        self._close_span()
        self.traced += 1
        if self.traced % self.trace_epochs == 0:
            run.tracer.stop()
            self._next_phase()
        else:
            self._open_span()

    def _next_phase(self) -> None:
        """Starts the next traced phase, or ends the fit."""
        if not self._phases:
            self.model.stop_fit()
            return
        self.run.tracer.start(self._phases.pop(0))
        self.phase = "trace"
        self._open_span()

    def log_eval(self, epoch, results) -> None:
        pass


def run(run: Run) -> Outcome:
    from ganmf_tpu_torch.models.ganmf import GANMF

    cfg, traffic = run.cell.config, run.cell.traffic
    data = movielens_shaped.generate(cfg["data"], run.seed, run.device)
    run.mark("data made")
    run.reset_peak()
    fit = dict(cfg["fit"])
    model = GANMF(data.train, mode=cfg["mode"], seed=run.model_seed, device=run.device, is_experiment=True)
    clock = EpochClock(run, model, traffic)
    model.metrics_logger = clock
    set_tf32(run.precision == "tf32")  # the program's own products, in the control
    try:
        model.fit(**fit, epochs=1 << 30, urm_storage=cfg["urm_storage"])
    finally:
        set_tf32(False)
    run.window_closed()
    if clock.wall is None:
        raise RuntimeError("the fit ended before its window closed")
    check, epochs, wall = clock.check, clock.epochs, clock.wall
    traced = clock.trace_epochs if clock.traced else 0
    st = clock.stamps
    run.mark("window epochs, s on the host clock (unsynchronized) / s of the thread's CPU: " + " ".join(
        f"{b[0] - a[0]:.3f}/{b[1] - a[1]:.3f}" for a, b in zip(st, st[1:])))
    losses = [(float(d), float(g)) for d, g in zip(model.train_d_loss[:check], model.train_g_loss[:check])]
    last = clock.last_epoch
    window_loss = (float(model.train_d_loss[last - 1]), float(model.train_g_loss[last - 1]))
    moments, params, w_start, w_end = clock.moments, clock.params, clock.start, clock.end
    urm = data.train if cfg["mode"] == "user" else data.train.T.tocsr()  # training orientation
    del model, clock
    run.release()

    ref = ref_ganmf.Trainer(urm, fit, run.model_seed, run.device)
    start = {k: v.clone() for k, v in ref.params.items()}
    ref_losses, ref_moments = [], None
    for _ in range(check):
        ref_losses.append(ref.run_epoch())
        if ref_moments is None:
            ref_moments = {k: v.clone() for k, v in ref.m.items()}
    grad_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_moments.items()}
    moment_gap = judge.leaf_gap(moments, ref_moments, grad_norms)
    change_gap = judge.leaf_gap({k: params[k] - start[k] for k in LEAVES},
                                   {k: ref.params[k] - start[k] for k in LEAVES}, grad_norms)
    loss_gap = max(judge.rel_gap(p, r) for pe, re in zip(losses, ref_losses) for p, r in zip(pe, re))
    if len(losses) < check:
        loss_gap = float("inf")

    # the window's last epoch, from the program's state at its start
    ref.resume(w_start, last - 1)
    ref_window_loss = ref.run_epoch()
    w_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.m.items()}
    window = {
        "window_loss_gap": max(judge.rel_gap(p, r) for p, r in zip(window_loss, ref_window_loss)),
        "window_moment_gap": judge.leaf_gap({k: w_end[f"m.{k}"] for k in LEAVES}, ref.m, w_norms),
        "window_change_gap": judge.leaf_gap({k: w_end[f"p.{k}"] - w_start[f"p.{k}"] for k in LEAVES},
                                            {k: ref.params[k] - w_start[f"p.{k}"] for k in LEAVES}, w_norms),
    }
    return Outcome(
        e2e={"epoch_s": wall / epochs},
        attempted=epochs, failed=0,
        numbers={"loss_gap": loss_gap, "moment_gap": moment_gap, "change_gap": change_gap, **window},
        layer={"unit_wall_s": wall / epochs, "units_traced": traced,
               "flops_per_unit": counters.ganmf_epoch_flops(*urm.shape, fit)})
