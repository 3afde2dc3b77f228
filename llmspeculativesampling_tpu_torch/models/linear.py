"""Linear-layer dispatch (counterpart of ``llmspeculativesampling_tpu/models/linear.py``).

A quantized ``{"q", "s"}`` leaf goes to the W8A16 kernel; a dense ``[K, N]``
weight stays a plain ``torch.matmul``, as the JAX package left it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.int8_matmul import int8_matmul
from ..quant.core import QUANT_LEAF_Q, QUANT_LEAF_S, is_quantized_leaf


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
           batch_invariant: bool = False) -> torch.Tensor:
    """``x @ w (+ bias)``; ``batch_invariant`` plans the W8A16 kernel so a
    row's output does not depend on the rows beside it
    (``kernels/int8_matmul.py::plan``)."""
    if is_quantized_leaf(w):
        y = int8_matmul(x, w[QUANT_LEAF_Q], w[QUANT_LEAF_S], batch_invariant)
    else:
        y = x @ w
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def lm_head_logits(h: torch.Tensor, head, batch_invariant: bool = False) -> torch.Tensor:
    """fp32 logits from the dense ``[V, H]`` head or the quantized
    ``{"q": [H, V], "s": [V]}`` re-layout."""
    if is_quantized_leaf(head):
        return int8_matmul(h, head[QUANT_LEAF_Q], head[QUANT_LEAF_S], batch_invariant).float()
    return h.float() @ head.float().t()
