"""The share of the run's evaluations that found their block plan kept from
an earlier evaluation of the same model, rather than building it."""

NAME = "eval.plan_hit_share"
UNIT = "%"
SOURCE = "program_counter"
LAYER = "evaluator (eval/evaluator.py, eval/metrics.py)"
MOVES = "eval_users_per_s"
WORKLOADS = ["ganmf-ml20m.eval"]


def read(ctx):
    from ganmf_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    counts = counters()
    hits, builds = counts.get("eval.plan.hits", 0), counts.get("eval.plan.builds", 0)
    if not hits + builds:
        return None
    return 100.0 * hits / (hits + builds)
