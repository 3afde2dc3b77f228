"""Linear-layer dispatch (counterpart of ``llmspeculativesampling_tpu/models/linear.py``).

A quantized ``{"q", "s"}`` leaf dispatches on ``q``'s dtype, as the JAX
package does (``llmspeculativesampling_tpu/kernels/int8_matmul.py:141``):
int8 goes to the W8A16 kernel; fp8 e4m3 never reached a Pallas kernel there
(XLA's fused convert + dot), so here it is the plain product
:func:`fp8_matmul`. A dense ``[K, N]`` weight stays a plain ``torch.matmul``,
as the JAX package left it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.int8_matmul import INVARIANT_M, int8_matmul
from ..quant.core import QUANT_LEAF_Q, QUANT_LEAF_S, is_quantized_leaf


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` with fp32 sums and an fp32 result, as XLA's
    ``preferred_element_type=float32``. Two bf16 operands stay bf16 on the
    card (cuBLAS's fp32-output GEMM: no fp32 copy of ``b`` is made, which for
    OPT-13B's tied 50272 x 5120 head would be 1 GB written and read a
    forward); elsewhere both are widened, exactly, to fp32."""
    if a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def fp8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ dequant(w_q [K, N] fp8 e4m3, scale [N])`` in x's dtype:
    ``bf16(x) @ bf16(w_q)`` (e4m3 widens exactly) with fp32 sums, times the
    scale, as the JAX package's ``int8_matmul_ref``."""
    lead = x.shape[:-1]
    y = matmul_f32(x.reshape(-1, x.shape[-1]).to(torch.bfloat16), w_q.to(torch.bfloat16))
    return (y * scale.float()[None, :]).to(x.dtype).reshape(*lead, w_q.shape[-1])


def quant_matmul(x: torch.Tensor, w: dict, batch_invariant: bool = False) -> torch.Tensor:
    """A quantized leaf's product, dispatched on its dtype: int8 -> the
    W8A16 kernel (whose wrapper raises on any other dtype), fp8 e4m3 ->
    :func:`fp8_matmul`."""
    q, s = w[QUANT_LEAF_Q], w[QUANT_LEAF_S]
    if q.dtype == torch.float8_e4m3fn:
        return fp8_matmul(x, q, s)
    return int8_matmul(x, q, s, batch_invariant)


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
           batch_invariant: bool = False) -> torch.Tensor:
    """``x @ w (+ bias)``; ``batch_invariant`` plans the W8A16 kernel so a
    row's output does not depend on the rows beside it
    (``kernels/int8_matmul.py::plan``)."""
    if is_quantized_leaf(w):
        y = quant_matmul(x, w, batch_invariant)
    else:
        y = x @ w
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def lm_head_logits(h: torch.Tensor, head, batch_invariant: bool = False) -> torch.Tensor:
    """fp32 logits from the dense ``[V, H]`` head (``h @ head.T`` with fp32
    sums, :func:`matmul_f32`) or the quantized ``{"q": [H, V], "s": [V]}``
    re-layout. ``batch_invariant`` runs a dense head in blocks of
    ``INVARIANT_M`` rows (one prompt bucket), so a row's logits do not
    depend on how many rows share the call: the library picks its product
    from the shape."""
    if is_quantized_leaf(head):
        return quant_matmul(h, head, batch_invariant).float()
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if batch_invariant:
        out = torch.cat([matmul_f32(blk, head.t()) for blk in h2.split(INVARIANT_M)])
    else:
        out = matmul_f32(h2, head.t())
    return out.reshape(*lead, head.shape[0])
