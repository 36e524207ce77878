"""``recommend`` in a closed loop: one caller, one user a call, the next
call sent when the list of the last is on the host.

Users are drawn uniformly from the seed. Each call is timed on the host
clock from the call to its returned list. Traffic parameters: ``cutoff``,
``remove_seen``, ``warmup_calls``, ``trace_calls``, ``check_calls`` (how
many of the window's calls, drawn from the seed, are compared). Compared
number: ``list_gap``, over the compared calls the widest gap by which the
reference score of a served item lies below the reference's best at its
position, relative to the user's best score (a list of another length, a
repeated or a seen item counts as infinite). The control puts the reference
in the program's place with its products in TF32.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import counters
from benchmark.data import derive_seed
from benchmark.drivers._model import loaded_model, tensors
from benchmark.harness import Outcome, Run
from benchmark.reference import ranking, round_tf32

#: users drawn ahead of the window; the loop cycles through them
DRAWS = 1 << 20


def run(run: Run) -> Outcome:
    traffic = run.cell.traffic
    k, remove_seen = int(traffic["cutoff"]), bool(traffic["remove_seen"])
    data, model = loaded_model(run)
    U_n = data.train.shape[0]
    rng = np.random.RandomState(derive_seed(run.seed, 2) % (1 << 32))
    draws = rng.randint(0, U_n, size=DRAWS)
    lat, served, failed = [], [], 0

    def call(u: int):
        nonlocal failed
        t = time.perf_counter_ns()
        try:
            lst = model.recommend(u, cutoff=k, remove_seen_flag=remove_seen)
        except Exception:  # a failed call is counted and judged, the loop goes on
            failed += 1
            lst = None
        lat.append(time.perf_counter_ns() - t)
        served.append(lst)

    traced = 0
    if run.control:  # the reference in the program's place, in TF32
        run.setup_done()
        run.window_closed()
        n = int(traffic["check_calls"])
        users = draws[:n]
        del model
        run.release()
        U, V = (round_tf32(t) for t in tensors(run, data)[:2])
        _, ids = ranking.top_lists(U, V, data.train, users, k)
        served = [row.tolist() for row in ids.cpu().numpy()]
        wall = 0.0
    else:
        for i in range(int(traffic["warmup_calls"])):
            call(int(draws[-1 - i]))
        lat, served, failed = [], [], 0
        run.setup_done()
        t_start = time.perf_counter_ns()
        n = 0
        while True:
            call(int(draws[n % DRAWS]))
            n += 1
            if time.perf_counter_ns() - t_start >= run.seconds * 1e9:
                break
        run.sync()
        wall = (time.perf_counter_ns() - t_start) / 1e9
        p99_ms = float(np.percentile(np.asarray(lat, dtype=np.float64), 99)) / 1e6
        tenths = np.array_split(np.asarray(lat, dtype=np.float64) / 1e6, 10)
        run.mark("p50/p99 ms by tenth of the window: " + " ".join(
            f"{np.percentile(t, 50):.3f}/{np.percentile(t, 99):.3f}" for t in tenths))
        for phase in run.tracer.phases():
            run.tracer.start(phase)
            for i in range(int(traffic["trace_calls"])):
                with run.tracer.span("recommend"):
                    model.recommend(int(draws[(n + i) % DRAWS]), cutoff=k, remove_seen_flag=remove_seen)
            run.tracer.stop()
            traced = int(traffic["trace_calls"])
        run.window_closed()
        del model
        run.release()
        users = draws[np.arange(n) % DRAWS]

    pick = np.random.RandomState(derive_seed(run.seed, 3) % (1 << 32))
    m = min(len(served), int(traffic["check_calls"]))
    idx = np.sort(pick.choice(len(served), size=m, replace=False))
    U, V = tensors(run, data)[:2]
    # a failed call's list is empty: another length than k, so its gap is infinite
    gaps = ranking.list_gaps([served[i] or [] for i in idx], users[idx], U, V, data.train, k)
    fp = run.cell.config["fit"]
    I = data.train.shape[1]
    return Outcome(
        e2e={"recommend_p99_ms": None if run.control else p99_ms},
        attempted=len(served), failed=failed,
        numbers={"list_gap": float(gaps.max()) if len(gaps) else float("inf")},
        layer={"unit_wall_s": wall / len(served) if wall else None, "units_traced": traced,
               "flops_per_unit": counters.scoring_flops(1, I, fp["num_factors"]),
               "k1_bound_s_per_unit": counters.k1_bound_s(1, I, fp["num_factors"], k)})
