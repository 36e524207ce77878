from ganmf_tpu_torch.eval.evaluator import EvaluatorHoldout, get_result_string  # noqa: F401
