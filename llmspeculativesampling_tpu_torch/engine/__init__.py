"""The port's generate entry points (see the package docstring of
``llmspeculativesampling_tpu_torch``)."""

from .autoregressive import autoregressive_generate
from .beam_tree import beam_speculative_generate, beam_speculative_v2_generate
from .multi import multi_speculative_generate
from .speculative import speculative_generate
from .types import ModelBundle, first_eos_truncate, pad_prompt

__all__ = [
    "autoregressive_generate",
    "beam_speculative_generate",
    "beam_speculative_v2_generate",
    "multi_speculative_generate",
    "speculative_generate",
    "ModelBundle",
    "first_eos_truncate",
    "pad_prompt",
]
