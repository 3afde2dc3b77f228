"""Evaluation layer: datasets, metrics and the harness CLI
(counterpart of ``llmspeculativesampling_tpu/evalx``)."""

from .datasets import EvalDataset, load_eval_dataset
from .metrics import (
    bleu,
    exact_match_references,
    execution_accuracy,
    execution_accuracy_references,
    get_score,
    normalize_answer,
    rouge,
)

__all__ = [
    "EvalDataset",
    "load_eval_dataset",
    "bleu",
    "exact_match_references",
    "execution_accuracy",
    "execution_accuracy_references",
    "get_score",
    "normalize_answer",
    "rouge",
]
