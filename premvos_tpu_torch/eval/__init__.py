"""Evaluation: in-repo DAVIS J&F and train-time measures."""

from premvos_tpu_torch.eval.davis_eval import (
    evaluate_dataset,
    evaluate_sequence,
    f_measure,
    j_measure,
)
from premvos_tpu_torch.eval.metrics import binary_iou, pixel_accuracy

__all__ = [
    "evaluate_dataset", "evaluate_sequence", "f_measure", "j_measure",
    "binary_iou", "pixel_accuracy",
]
