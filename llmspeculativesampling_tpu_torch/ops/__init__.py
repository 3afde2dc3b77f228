"""Sampling and the acceptance dynamic programme (counterpart of
``llmspeculativesampling_tpu/ops``)."""

from .dp import (
    acceptance_alphas,
    get_expect_cnt_by_thres,
    get_num_acc_prob,
    num_accept_distribution,
)
from .sampling import (
    SamplingConfig,
    acceptance_prob,
    apply_top_k,
    apply_top_p,
    filter_logits,
    max_fn,
    norm_logits,
    residual_update,
    sample,
    sample_k,
)

__all__ = [
    "SamplingConfig",
    "acceptance_prob",
    "apply_top_k",
    "apply_top_p",
    "filter_logits",
    "max_fn",
    "norm_logits",
    "residual_update",
    "sample",
    "sample_k",
    "acceptance_alphas",
    "get_expect_cnt_by_thres",
    "get_num_acc_prob",
    "num_accept_distribution",
]
