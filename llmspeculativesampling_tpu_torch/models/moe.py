"""The routed expert layer: Mellum 2's sparse MLP (every layer of
Mellum2-12B-A2.5B), on B4 (``kernels/moe_matmul.py``).

For the ``[T, H]`` input ``x`` of a layer's MLP (after its RMSNorm):

    p = softmax(x @ router)                      # [T, E], float32
    w, ids = the top-k of p                      # k = num_experts_per_tok
    w = w / sum(w)                               # norm_topk_prob
    y = sum_j w_j * down_e(silu(gate_e(x)) * up_e(x)),  e = ids_j

as transformers' ``Qwen3MoeSparseMoeBlock`` computes it from the same
config keys. The router ``[H, E]`` stays bf16 with float32 sums; each
expert's gate and up are one int8 product ``w_gate_up`` ``{"q": [E, H,
2F], "s": [E, 2F]}`` (gate in the first F columns), its down
``w_experts_down`` ``{"q": [E, F, H], "s": [E, H]}``. Activations round
to bf16 where the dense SwiGLU's do (the gate and up outputs, silu(gate),
their product); the down products stay float32 and the weighted combine
sums the k of them in float32 before the one cast.

Nothing reads back to the host: the pairs are aligned on the device into
static worst-case buffers (``expert_align``), so a forward through this
layer is captured like any other. When the model's params hold
``routed_rows`` (int64 [layers, experts], made before any capture), the
align launch also adds each expert's pairs to its layer's row: the routed
load since the buffer was made, read whenever its owner likes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.int8_matmul import INVARIANT_M
from ..kernels.moe_matmul import expert_align, grouped_int8_matmul, row_tile
from .linear import matmul_f32


def route(logits: torch.Tensor, top_k: int, norm_topk_prob: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights float32 [T, k], expert ids int64 [T, k]) of router logits
    [T, E]: softmax in float32, the top k, renormalised to sum 1 when
    ``norm_topk_prob``."""
    p = torch.softmax(logits.float(), dim=-1)
    w, ids = torch.topk(p, top_k, dim=-1)
    if norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return w, ids


def router_logits(x: torch.Tensor, router: torch.Tensor, batch_invariant: bool) -> torch.Tensor:
    """float32 [T, E] logits, bf16 operands with float32 sums; planned in
    blocks of one prompt bucket when ``batch_invariant``, as the dense head."""
    if batch_invariant:
        return torch.cat([matmul_f32(blk, router) for blk in x.split(INVARIANT_M)])
    return matmul_f32(x, router)


def expert_mlp(x: torch.Tensor, lp: dict, cfg, totals=None, batch_invariant: bool = False) -> torch.Tensor:
    """The expert layer's output [..., H] in ``x``'s dtype for ``x`` [..., H]
    (the normed residual), ``lp`` one layer's weights (``router``,
    ``w_gate_up``, ``w_experts_down``); ``totals`` int64 [E] takes each
    expert's pairs."""
    lead, hdim = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, hdim)
    t, e, f = x2.shape[0], cfg.num_experts, cfg.moe_intermediate_size
    w, ids = route(router_logits(x2, lp["router"], batch_invariant), cfg.num_experts_per_tok,
                   cfg.norm_topk_prob)
    k = ids.shape[1]
    routing = expert_align(ids, e, row_tile(t * k, e), totals)
    gu = grouped_int8_matmul(x2.index_select(0, routing.rows), lp["w_gate_up"]["q"],
                             lp["w_gate_up"]["s"], routing)
    act = torch.nn.functional.silu(gu[:, :f].float()).to(x.dtype) * gu[:, f:]
    y = grouped_int8_matmul(act, lp["w_experts_down"]["q"], lp["w_experts_down"]["s"], routing,
                            out_dtype=torch.float32)
    out = (y.index_select(0, routing.inv.long()).view(t, k, hdim) * w[..., None]).sum(dim=1)
    return out.to(x.dtype).reshape(*lead, hdim)
