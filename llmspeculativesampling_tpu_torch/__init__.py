"""PyTorch + CUDA (Hopper) port of ``llmspeculativesampling_tpu``.

The JAX package stays the reference; this package mirrors its sub-package
and module names (``core``, ``quant``, ``kernels``, ``models``, ``cache``,
``ops``, ``engine``) so each counterpart is easy to find. It imports
``torch`` and never ``jax``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``. On a CUDA tensor every kernel wrapper launches its
hand-written kernel (``csrc/``) or raises; the plain PyTorch version beside
each kernel serves CPU tensors (the tests) only.

Two model families run on every engine: Llama (with Qwen2 and Mistral) and
OPT. Real checkpoints load from local directories (``load_pretrained``);
the synthetic pairs are born on the card from a seed.
"""

from .core.config import LlamaConfig, OPTConfig
from .core.loader import load_pretrained, load_params, save_params
from .core.synthetic import (
    synthetic_opt_pair_int8,
    synthetic_opt_pair_int8_small_draft,
    synthetic_pair,
    synthetic_pair_int8,
    synthetic_pair_int8_small_draft,
)
from .engine import (  # noqa: E402
    ModelBundle,
    autoregressive_generate,
    beam_speculative_generate,
    beam_speculative_v2_generate,
    bild_generate,
    mjsd_generate,
    multi_beam_generate,
    multi_speculative_generate,
    random_width_beam_generate,
    speculative_generate,
    speculative_generate_v2,
)

# the reference's names for the entry points
speculative_sampling = speculative_generate
speculative_sampling_v2 = speculative_generate_v2
autoregressive_sampling = autoregressive_generate
multi_speculative_sampling = multi_speculative_generate
mjsd_speculative_sampling = mjsd_generate
beam_speculative_sampling = beam_speculative_generate
beam_speculative_sampling_v2 = beam_speculative_v2_generate
BiLD_sampling = bild_generate
random_width_beam_sampling = random_width_beam_generate

__all__ = [
    "LlamaConfig",
    "OPTConfig",
    "load_pretrained",
    "load_params",
    "save_params",
    "synthetic_opt_pair_int8",
    "synthetic_opt_pair_int8_small_draft",
    "synthetic_pair",
    "synthetic_pair_int8",
    "synthetic_pair_int8_small_draft",
    "ModelBundle",
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
    "speculative_sampling",
    "speculative_sampling_v2",
    "autoregressive_sampling",
    "multi_speculative_sampling",
    "mjsd_speculative_sampling",
    "beam_speculative_sampling",
    "beam_speculative_sampling_v2",
    "BiLD_sampling",
    "random_width_beam_sampling",
]
