"""Full-catalog and inductive evaluation."""

from inductive_recommendation_tpu_torch.eval.device_metrics import batch_metric_sums, combine_metric_sums
from inductive_recommendation_tpu_torch.eval.evaluator import Evaluator
from inductive_recommendation_tpu_torch.eval.metrics import calculate_metrics

__all__ = ["Evaluator", "batch_metric_sums", "calculate_metrics", "combine_metric_sums"]
