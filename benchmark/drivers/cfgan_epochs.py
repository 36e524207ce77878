"""CFGAN's training epochs back to back, through ``CFGAN.fit``'s own loop.

One ``fit`` call in csr storage builds the model, its optimizers and its
padded-CSR planes and runs every epoch of the run, as drivers/epochs.py runs
GANMF's, with the same clock over CFGAN's training state: the first
``check_epochs``, which the reference follows from the seed, then
``warmup_epochs``, then the window, which ends at the first epoch boundary
past ``--seconds``, and with ``--trace 1`` ``trace_epochs`` in each traced
phase.

The program's losses and masks are read through three functions of its
CFGAN module, which the epoch looks up at every minibatch and which this
driver wraps for the run (models/cfgan.py ``d_loss``, ``g_loss``,
``negative_mask``): each minibatch's loss is kept, detached, with no device
work and nothing read back until the fit ends; in the first epoch, a part
of set-up, the ZR mask of one G minibatch in ``mask_stride`` is copied to
the host. Scheme ZR draws no mask in a D minibatch, so the draws count the
G minibatches.

Compared numbers, from the seed: ``loss_gap`` (each checked epoch's mean D
and G minibatch loss, relative), ``moment_gap`` (after the first epoch, the
norm of each leaf's first Adam moment), ``change_gap`` (the norm of each
leaf's change over the checked epochs), ``mask_gap`` (the share of the kept
masks' entries where the program's mask and the reference's differ). The
window's last epoch is copied at its start (the program's tensors, Adam
moments and step counts, one device copy an epoch, and the keyed draws'
epoch counter) and the reference runs that epoch from the copy:
``window_loss_gap``, ``window_moment_gap`` (the first moments after it) and
``window_change_gap`` (each leaf's change over it). Traffic parameters:
``check_epochs``, ``warmup_epochs``, ``trace_epochs``, ``mask_stride``.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import cfgan_counters, counters, judge
from benchmark.data import movielens_shaped
from benchmark.drivers.epochs import EpochClock
from benchmark.harness import Outcome, Run
from benchmark.reference import cfgan as ref_cfgan
from benchmark.reference import set_tf32


def training_state(model) -> dict:
    """The live tensors of the program's training state by name, as
    ``Trainer.resume`` takes them: each leaf (``p.``), its two Adam moments
    (``m.``, ``v.``) and its step count (``t.``). A leaf that its optimizer
    holds no state for has not been stepped: zeros."""
    state = dict(model._d_opt.state)
    state.update(model._g_opt.state)
    out = {}
    for k, p in model.params.named_parameters():
        s = state.get(p)
        out[f"p.{k}"] = p.detach()
        if s is None:
            out[f"m.{k}"], out[f"v.{k}"], out[f"t.{k}"] = torch.zeros_like(p), torch.zeros_like(p), torch.zeros(())
        else:
            out[f"m.{k}"], out[f"v.{k}"], out[f"t.{k}"] = s["exp_avg"], s["exp_avg_sq"], s["step"]
    return out


class Taps:
    """The wraps of the program's loss functions and mask draw for the
    run: ``losses`` holds the running epoch's D and G minibatch losses,
    ``checked`` each checked epoch's, ``last`` the last finished epoch's;
    ``masks`` the first epoch's kept ZR masks by G minibatch."""

    def __init__(self, mask_stride: int):
        self.stride = int(mask_stride)
        self.losses = ([], [])
        self.checked, self.last = [], None
        self.masks = {}
        self._draws = 0
        self._masks_on = True
        self._saved = []

    def __enter__(self):
        from ganmf_tpu_torch.models import cfgan

        d_loss, g_loss, negative_mask = cfgan.d_loss, cfgan.g_loss, cfgan.negative_mask

        def d_tap(*args, **kwargs):
            loss = d_loss(*args, **kwargs)
            self.losses[0].append(loss.detach())
            return loss

        def g_tap(*args, **kwargs):
            loss = g_loss(*args, **kwargs)
            self.losses[1].append(loss.detach())
            return loss

        def mask_tap(block, u, ratio):
            mask = negative_mask(block, u, ratio)
            if self._masks_on:
                if self._draws % self.stride == 0:
                    self.masks[self._draws] = (mask != 0).cpu()
                self._draws += 1
            return mask

        for name, fn in (("d_loss", d_tap), ("g_loss", g_tap), ("negative_mask", mask_tap)):
            self._saved.append((cfgan, name, getattr(cfgan, name)))
            setattr(cfgan, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        return False

    def epoch_ended(self, checked: bool) -> None:
        """At each epoch's end: its losses become ``last`` (and a checked
        epoch's are kept); the masks are taken in the first epoch alone."""
        self.last = self.losses
        if checked:
            self.checked.append(self.losses)
        self.losses = ([], [])
        self._masks_on = False


def mean_losses(losses) -> tuple:
    """The mean D and G minibatch loss, summed in float64; NaN where the
    epoch recorded none."""
    return tuple(float(torch.stack(ls).double().mean()) if ls else math.nan for ls in losses)


class Clock(EpochClock):
    """drivers/epochs.py's clock over CFGAN's training state: the snapshots
    of the first and the checked epochs, the window's start and end, and the
    keyed draws' epoch counter at the start of the window's epochs."""

    def __init__(self, run: Run, model, traffic: dict, taps: Taps):
        super().__init__(run, model, traffic)
        self.taps = taps
        self.start_epochs = self.window_losses = None

    def _copy_state(self) -> None:
        live = training_state(self.model)
        if self.start is None:
            self.start = {k: torch.empty_like(v) for k, v in live.items()}
        for k, v in live.items():
            self.start[k].copy_(v)
        self.start_epochs = self.model._mask_epoch

    def log_epoch(self, epoch: int) -> None:
        run = self.run
        self.taps.epoch_ended(checked=epoch <= self.check)
        if epoch == 1:
            live = training_state(self.model)
            self.moments = {k[2:]: v.clone() for k, v in live.items() if k.startswith("m.")}
        if epoch == self.check:
            self.params = {k: p.detach().clone() for k, p in self.model.params.named_parameters()}
        if self.phase == "setup":
            run.mark(f"epoch {epoch} launched")
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
                self.window_losses = self.taps.last
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


def run(run: Run) -> Outcome:
    from ganmf_tpu_torch.models.cfgan import CFGAN

    cfg, traffic = run.cell.config, run.cell.traffic
    fit = dict(cfg["fit"])
    if cfg["urm_storage"] != "csr" or fit["scheme"] != "ZR":
        raise ValueError("the CFGAN cell runs csr storage and scheme ZR")
    data = movielens_shaped.generate(cfg["data"], run.seed, run.device)
    run.mark("data made")
    run.reset_peak()
    model = CFGAN(data.train, mode=cfg["mode"], seed=run.model_seed, device=run.device, is_experiment=True)
    with Taps(traffic["mask_stride"]) as taps:
        clock = Clock(run, model, traffic, taps)
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
    losses = [mean_losses(ls) for ls in taps.checked]
    window_loss = mean_losses(clock.window_losses)
    moments, params, w_start, w_end = clock.moments, clock.params, clock.start, clock.end
    start_epochs, masks = clock.start_epochs, taps.masks
    urm = data.train if cfg["mode"] == "user" else data.train.T.tocsr()  # training orientation
    del model, clock, taps
    run.release()

    t_ref = time.perf_counter()
    ref = ref_cfgan.Trainer(urm, fit, run.model_seed, run.device)
    leaves = ref.names
    start = {k: v.clone() for k, v in ref.params.items()}
    ref_losses = []
    for e in range(check):
        d, g = ref.run_epoch(keep_masks=masks if e == 0 else ())
        ref_losses.append((sum(d) / len(d), sum(g) / len(g)))
        if e == 0:
            ref_moments = {k: v.clone() for k, v in ref.m.items()}
            kept = ref.kept_masks
    grad_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_moments.items()}
    moment_gap = judge.leaf_gap(moments, ref_moments, grad_norms)
    change_gap = judge.leaf_gap({k: params[k] - start[k] for k in leaves},
                                {k: ref.params[k] - start[k] for k in leaves}, grad_norms)
    loss_gap = max(judge.rel_gap(p, r) for pe, re in zip(losses, ref_losses) for p, r in zip(pe, re))
    if len(losses) < check:
        loss_gap = math.inf
    compared = sum(m.numel() for m in masks.values())
    differ = sum(int((m != kept[i]).sum()) if i in kept else m.numel() for i, m in masks.items())
    mask_gap = differ / compared if compared else math.inf

    # the window's last epoch, from the program's state at its start
    ref.resume(w_start, start_epochs)
    d, g = ref.run_epoch()
    ref_window_loss = (sum(d) / len(d), sum(g) / len(g))
    w_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.m.items()}
    window = {
        "window_loss_gap": max(judge.rel_gap(p, r) for p, r in zip(window_loss, ref_window_loss)),
        "window_moment_gap": judge.leaf_gap({k: w_end[f"m.{k}"] for k in leaves}, ref.m, w_norms),
        "window_change_gap": judge.leaf_gap({k: w_end[f"p.{k}"] - w_start[f"p.{k}"] for k in leaves},
                                            {k: ref.params[k] - w_start[f"p.{k}"] for k in leaves}, w_norms),
    }
    run.mark(f"the reference's two epochs took {time.perf_counter() - t_ref:.3f} s")
    n_rows, n_cols = urm.shape
    g_dims, d_dims = ref_cfgan.layer_dims(n_cols, fit)
    entries = cfgan_counters.mask_entries_per_epoch(n_rows, n_cols, int(fit["g_batch_size"]), int(fit["g_steps"]))
    return Outcome(
        e2e={"epoch_s": wall / epochs},
        attempted=epochs, failed=0,
        numbers={"loss_gap": loss_gap, "moment_gap": moment_gap, "change_gap": change_gap, "mask_gap": mask_gap,
                 **window},
        layer={"unit_wall_s": wall / epochs, "units_traced": traced,
               "flops_per_unit": cfgan_counters.cfgan_epoch_flops(n_rows, g_dims, d_dims, int(fit["d_steps"]),
                                                                  int(fit["g_steps"])),
               "k2_bound_s_per_unit": entries * cfgan_counters.K2_BYTES_PER_ENTRY / counters.HBM_BYTES_PER_S,
               "keyed_bound_s_per_unit": entries * cfgan_counters.KEYED_BYTES_PER_ENTRY / counters.HBM_BYTES_PER_S})
