from ganmf_tpu_torch.eval.evaluator import EvaluatorHoldout, EvaluatorNegativeItemSample, get_result_string  # noqa: F401
