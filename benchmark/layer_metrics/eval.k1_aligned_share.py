"""The share of the run's launches of K1's fused kernel and wide pair that
took the fused kernel's aligned main loop."""

NAME = "eval.k1_aligned_share"
UNIT = "%"
SOURCE = "program_counter"
LAYER = "K1, the fused masked top-k scorer (ops/scorer.py, csrc/masked_topk.cu)"
MOVES = "eval_users_per_s"
WORKLOADS = ["ganmf-ml20m.eval"]


def read(ctx):
    from ganmf_tpu_torch.ops import scorer
    from ganmf_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None or not hasattr(scorer, "aligned_route"):  # a program without the route
        return None
    counts = counters()
    launches = counts.get("k1.launches", 0)
    if not launches:
        return None
    return 100.0 * counts.get("k1.aligned_launches", 0) / launches
