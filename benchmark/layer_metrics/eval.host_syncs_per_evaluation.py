"""The program's host syncs (blocking copies to the card, reads back) per full evaluation."""

from benchmark.layer_metrics._program import host_syncs_per_call

NAME = "eval.host_syncs_per_evaluation"
UNIT = "syncs/evaluation"
SOURCE = "program_counter"
LAYER = "evaluator (eval/evaluator.py, eval/metrics.py)"
MOVES = "eval_users_per_s"
WORKLOADS = ["ganmf-ml20m.eval"]


def read(ctx):
    return host_syncs_per_call("eval.evaluate")
