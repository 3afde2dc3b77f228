"""The port's generate entry points (see the package docstring of
``llmspeculativesampling_tpu_torch``)."""

from .autoregressive import autoregressive_generate
from .beam_spec import mjsd_generate, multi_beam_generate
from .beam_tree import beam_speculative_generate, beam_speculative_v2_generate
from .bild import bild_generate
from .multi import multi_speculative_generate
from .random_beam import random_width_beam_generate
from .speculative import speculative_generate
from .speculative_v2 import speculative_generate_v2
from .types import ModelBundle, first_eos_truncate, pad_prompt

__all__ = [
    "autoregressive_generate",
    "beam_speculative_generate",
    "beam_speculative_v2_generate",
    "bild_generate",
    "mjsd_generate",
    "multi_beam_generate",
    "multi_speculative_generate",
    "random_width_beam_generate",
    "speculative_generate",
    "speculative_generate_v2",
    "ModelBundle",
    "first_eos_truncate",
    "pad_prompt",
]
