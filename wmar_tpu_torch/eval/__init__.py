"""Evaluation: the generate -> round trip -> detect pipeline."""

from wmar_tpu_torch.eval.pipeline import EvalParams, generate_and_evaluate

__all__ = ["EvalParams", "generate_and_evaluate"]
