"""Full holdout evaluations back to back: ``EvaluatorHoldout.evaluateRecommender``
over every test user of a loaded model, each call ending with the metrics
on the host.

Traffic parameters: ``cutoffs``, ``min_ratings_per_user``,
``warmup_evaluations``, ``trace_evaluations``, ``list_stride``. Compared
numbers, against the reference's own ranking of the same users with the
same tensors: ``metrics_gap``, the largest relative gap of any metric at any
cutoff of any evaluation the run made; ``list_gap``, over K1's lists of a
sample of each evaluation's users (one place in ``list_stride`` of the
evaluator's order, at a phase drawn from the seed that moves on with each
evaluation, so that every user is sampled within ``list_stride``
evaluations), the widest gap by which the reference score of a listed item
lies below the reference's best at its position, relative to the user's best
score. The control puts that reference in the program's place with its
products in TF32.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import counters, judge
from benchmark.data import derive_seed
from benchmark.drivers._model import loaded_model, tensors
from benchmark.harness import Outcome, Run
from benchmark.reference import ranking, round_tf32

#: the step of the sampled phase from one evaluation to the next (odd, so
#: that it meets every phase of a power-of-two stride)
PHASE_STEP = 13


class ListRecorder:
    """Keeps, on the card and with no read to the host, the lists that the
    evaluator's K1 blocks produce for a strided sample of each evaluation's
    users, and those users. It wraps the evaluator's block (an attribute of
    this evaluator alone); evaluations past ``capacity`` are not kept."""

    def __init__(self, ev, n_users: int, k: int, stride: int, capacity: int, phase0: int,
                 device: torch.device):
        self.n_users, self.stride, self.capacity, self.phase0 = n_users, stride, capacity, phase0
        per = -(-n_users // stride)
        self.ids = torch.full((capacity, per, k), -1, dtype=torch.int32, device=device)
        self.uids = torch.full((capacity, per), -1, dtype=torch.int32, device=device)
        self.kept = []  # rows kept by each recorded evaluation
        self.seen = []  # rows the evaluator's blocks covered in each
        self.active = False
        inner = ev._fused_block

        def fused_block(model, factors, uids, *args, **kwargs):
            out = inner(model, factors, uids, *args, **kwargs)
            if self.active:
                self._keep(uids, out[1])
            return out

        ev._fused_block = fused_block

    def phase(self, j: int) -> int:
        return (self.phase0 + PHASE_STEP * j) % self.stride

    def begin(self) -> None:
        self.active = len(self.kept) < self.capacity
        self._pos = self._rows = 0

    def end(self) -> None:
        if self.active:
            self.kept.append(self._rows)
            self.seen.append(self._pos)
        self.active = False

    def _keep(self, uids: torch.Tensor, idx: torch.Tensor) -> None:
        j, B = len(self.kept), uids.shape[0]
        first = (self.phase(j) - self._pos) % self.stride
        sel = idx[first::self.stride]
        n = sel.shape[0]
        self.ids[j, self._rows:self._rows + n].copy_(sel)
        self.uids[j, self._rows:self._rows + n].copy_(uids[first::self.stride])
        self._rows += n
        self._pos += B

    def lists(self):
        """(ids [N, k], users [N]) of every kept row, or None where an
        evaluation kept other rows than its phase gives (the evaluator's
        blocks did not cover its users once each, in order)."""
        ids, uids = self.ids.cpu().numpy(), self.uids.cpu().numpy()
        out_i, out_u = [], []
        for j, (n, pos) in enumerate(zip(self.kept, self.seen)):
            if pos != self.n_users or n != len(range(self.phase(j), self.n_users, self.stride)):
                return None
            out_i.append(ids[j, :n])
            out_u.append(uids[j, :n])
        if not out_i:
            return None
        return np.concatenate(out_i), np.concatenate(out_u).astype(np.int64)


def reference_lists(run: Run, data, users: np.ndarray, k: int, tf32: bool = False):
    """The reference's ([N, k] scores, [N, k] ids) of ``users`` with the
    seed's tensors, in full float32 or with the operands rounded to TF32."""
    U, V = tensors(run, data)[:2]
    if tf32:
        U, V = round_tf32(U), round_tf32(V)
    return ranking.top_lists(U, V, data.train, users, k)


def reference_metrics(run: Run, data, users: np.ndarray, cutoffs, vals, ids):
    U, V = tensors(run, data)[:2]
    test_u = data.test[users]
    scores = ranking.pair_scores(U, V, np.repeat(users, np.diff(test_u.indptr)), test_u.indices)
    return ranking.holdout_metrics(ids.cpu().numpy(), np.isfinite(vals.cpu().numpy()), users, data.train,
                                   data.test, scores, cutoffs)


def run(run: Run) -> Outcome:
    traffic = run.cell.traffic
    cutoffs = list(traffic["cutoffs"])
    k = max(cutoffs)
    data, model = loaded_model(run)
    users = np.flatnonzero(np.diff(data.test.indptr) >= int(traffic["min_ratings_per_user"]))
    if run.control:  # the reference in the program's place, in TF32
        run.setup_done()
        run.window_closed()
        del model
        run.release()
        c_vals, c_ids = reference_lists(run, data, users, k, tf32=True)
        results = [reference_metrics(run, data, users, cutoffs, c_vals, c_ids)]
        served = (c_ids.cpu().numpy(), users)
        n, wall, traced = 0, 0.0, 0
    else:
        from ganmf_tpu_torch.eval import EvaluatorHoldout

        ev = EvaluatorHoldout(data.test, cutoffs, minRatingsPerUser=int(traffic["min_ratings_per_user"]),
                              exclude_seen=True, device=run.device)
        t_warm = math.inf
        for _ in range(int(traffic["warmup_evaluations"])):
            t = time.perf_counter()
            ev.evaluateRecommender(model)
            t_warm = min(t_warm, time.perf_counter() - t)
        # room for twice the evaluations the fastest warm-up's pace gives the window
        capacity = int(math.ceil(2 * run.seconds / max(t_warm, 1e-3))) + 2 * int(traffic["trace_evaluations"]) + 8
        stride = int(traffic["list_stride"])
        phase0 = derive_seed(run.seed, 4) % stride
        rec = ListRecorder(ev, len(users), k, stride, capacity, phase0, run.device)

        def evaluate():
            rec.begin()
            out = ev.evaluateRecommender(model)[0]
            rec.end()
            return out

        results = []
        run.setup_done()
        t_start = time.perf_counter()
        while True:
            results.append(evaluate())
            if time.perf_counter() - t_start >= run.seconds:
                break
        run.sync()
        wall, n = time.perf_counter() - t_start, len(results)
        traced = 0
        for phase in run.tracer.phases():
            run.tracer.start(phase)
            for _ in range(int(traffic["trace_evaluations"])):
                with run.tracer.span("evaluate"):
                    results.append(evaluate())
            run.tracer.stop()
            traced = int(traffic["trace_evaluations"])
        run.window_closed()
        block_rows = ev.block_rows()
        served = rec.lists()
        run.mark(f"lists of {len(rec.kept)} of {len(results)} evaluations kept")
        del model, ev, rec
        run.release()

    vals, ids = reference_lists(run, data, users, k)
    ref = reference_metrics(run, data, users, cutoffs, vals, ids)
    if served is None:
        list_gap = math.inf
    else:
        U, V = tensors(run, data)[:2]
        rows = np.searchsorted(users, served[1])  # users is sorted
        ok = (rows < len(users)) & (users[np.minimum(rows, len(users) - 1)] == served[1])
        top = vals.double().cpu().numpy()[np.minimum(rows, len(users) - 1)]
        gaps = ranking.id_gaps(served[0], served[1], top, U, V, data.train)
        list_gap = float(gaps.max()) if ok.all() and len(gaps) else math.inf
    fp = run.cell.config["fit"]
    K, I = fp["num_factors"], data.train.shape[1]
    layer = {"unit_wall_s": wall / n if n else None, "units_traced": traced,
             "flops_per_unit": counters.scoring_flops(len(users), I, K)}
    if not run.control:
        layer["k1_bound_s_per_unit"] = sum(counters.k1_bound_s(b, I, K, k)
                                           for b in counters.k1_blocks(len(users), block_rows))
    return Outcome(
        e2e={"eval_users_per_s": n * len(users) / wall if wall else None},
        attempted=n, failed=0,
        numbers={"metrics_gap": judge.metrics_gap(results, ref), "list_gap": list_gap}, layer=layer)
