"""Tiny-pair training on the repository's own text
(counterpart of ``llmspeculativesampling_tpu/train``).

``train_tiny_pair`` trains a small byte-level Llama target and an
independent smaller draft on the same corpus, giving a pair whose
agreement comes from learning the same distribution, as real pairs such
as llama-68m / Llama-2-13b do, rather than from shared weights.
"""

from .tiny import (
    build_repo_corpus,
    pinned_corpus,
    sample_batches,
    train_lm,
    train_tiny_pair,
)

__all__ = [
    "build_repo_corpus",
    "pinned_corpus",
    "sample_batches",
    "train_lm",
    "train_tiny_pair",
]
