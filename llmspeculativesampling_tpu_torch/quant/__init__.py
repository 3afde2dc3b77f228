"""Weight-only int8 (and fp8) quantization (counterpart of
``llmspeculativesampling_tpu/quant``)."""

from .core import (
    QUANT_LEAF_Q,
    QUANT_LEAF_S,
    dequantize_tensor,
    is_quantized_leaf,
    quantize_params,
    quantize_tensor,
)

__all__ = [
    "QUANT_LEAF_Q",
    "QUANT_LEAF_S",
    "dequantize_tensor",
    "is_quantized_leaf",
    "quantize_params",
    "quantize_tensor",
]
