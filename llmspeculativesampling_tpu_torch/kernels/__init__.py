"""The hand-written Hopper kernels and their plain PyTorch versions
(counterpart of ``llmspeculativesampling_tpu/kernels``). As in the JAX
package, ``kernels.int8_matmul`` is the function; its module is
``kernels/int8_matmul.py`` (import names from it directly)."""

from .int8_matmul import int8_matmul, int8_matmul_ref

__all__ = ["int8_matmul", "int8_matmul_ref"]
