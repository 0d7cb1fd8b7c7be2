"""Evaluation: the generate -> attack -> detect pipeline and the result analyzer."""

from wmar_tpu_torch.eval.pipeline import EvalParams, compute_and_save_batch, fill_batch_log, generate_and_evaluate

__all__ = ["EvalParams", "compute_and_save_batch", "fill_batch_log", "generate_and_evaluate"]
