"""Mellum 2 decoder (JetBrains' Mellum2-12B-A2.5B, ``model_type`` "mellum";
the configuration is ``core/config.py::MellumConfig``).

Per layer ``l`` of ``layer_types``, with RMSNorms ``n1``/``n2`` (eps
``rms_norm_eps``), ``D = head_dim`` and query width ``num_heads * D``
(4,096 at the published size, apart from the hidden 2,304):

    a = n1(x)
    q, k, v = a @ Wq, a @ Wk, a @ Wv          # 32 query heads, 4 kv heads (GQA)
    q, k = rope_l(q), rope_l(k)
    h = x + attn_l(q, k, v) @ Wo              # softmax(q k^T / sqrt(D)), causal
    y = h + mlp_l(n2(h))

A ``sliding_attention`` layer attends to the positions ``(t - window, t]``
of a query at ``t`` (``sliding_window``, 1,024) with plain RoPE (theta
``rope_theta``); a ``full_attention`` layer to ``[0, t]`` with YaRN RoPE
(``full_rope``: the YaRN inverse frequencies, cos and sin times its
attention factor, so q and k each carry it). ``mlp_l`` is the routed expert
layer of ``models/moe.py`` (top ``num_experts_per_tok`` of ``num_experts``
SiLU-gated experts), or with ``num_experts`` 0 one dense SwiGLU; params
holding ``routed_rows`` (int64 [L, E]) have each layer's routed pairs added
to its row. The final
RMSNorm and an untied head give the logits. No query/key norm (the config
has no key for one).

The attention, norms, RoPE and embedding are ``models/llama.py``'s (the
same paths over contiguous and paged caches, the window passed to them per
layer); every projection is int8 W8A16 (B1; the experts B4), the router
bf16 with float32 sums, the head bf16 with float32 sums. Not sharded: a
tensor-parallel tree raises.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ..core.config import MellumConfig
from ..parallel.sharding import mesh_of
from . import moe
from .linear import linear, lm_head_logits
from .llama import (
    advance,
    apply_rope,
    attention_plan,
    embed_tokens,
    layer_attention,
    rms_norm,
    rope_tables,
    unstack_layers,
)


def _window(cfg: MellumConfig, li: int) -> Optional[int]:
    return cfg.layer_window(li)


def forward(
    params: dict,
    cfg: MellumConfig,
    tokens: torch.Tensor,
    cache,
    positions: Optional[torch.Tensor] = None,
    tree_mask: Optional[torch.Tensor] = None,
    paged_prefill: bool = False,
    batch_invariant: bool = False,
    tp_mesh=None,
) -> Tuple[torch.Tensor, object]:
    """Run the decoder over ``tokens`` [B, S] given ``cache``: writes the S
    new positions' k/v at the cache's length (in place) and returns (logits
    [B, S, V] float32, the cache with length += S), as
    ``models/llama.py::forward`` does over the same caches and with the same
    ``paged_prefill``/``batch_invariant`` meaning."""
    if tp_mesh is not None or mesh_of(params) is not None:
        raise NotImplementedError("the Mellum decoder is not sharded over tensor parallelism")
    b, s = tokens.shape
    dev = tokens.device
    dtype = cfg.torch_dtype
    d = cfg.head_dim
    layers = unstack_layers(params)["layers"]
    windows = [_window(cfg, li) for li in range(cfg.num_layers)]
    win = next((w for w in windows if w is not None), None)
    plan = attention_plan(cache, s, b, dev, cfg.flash, tree_mask, paged_prefill, batch_invariant,
                          window=win)
    if positions is None:
        positions = (plan.offset + torch.arange(s, device=dev)[None]).expand(b, s)
    full_rope = rope_tables(positions, d, cfg.rope_theta, cfg.full_rope)
    window_rope = rope_tables(positions, d, cfg.rope_theta) if win is not None else None
    totals = params.get("routed_rows")  # int64 [L, E], when the params keep the routed load

    h = embed_tokens(params["embed"], tokens, None, dtype)
    scale = 1.0 / math.sqrt(d)
    lin = functools.partial(linear, batch_invariant=plan.batch_invariant)
    for li, lp in enumerate(layers):
        window = windows[li]
        cos, sin = full_rope if window is None else window_rope
        r = rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps)
        q = apply_rope(lin(r, lp["wq"]).reshape(b, s, cfg.num_heads, d), cos, sin)
        k = apply_rope(lin(r, lp["wk"]).reshape(b, s, cfg.num_kv_heads, d), cos, sin)
        v = lin(r, lp["wv"]).reshape(b, s, cfg.num_kv_heads, d)
        ctx = layer_attention(plan, cache, li, q, k, v, scale, dtype, window)
        h = h + lin(ctx, lp["wo"])

        r = rms_norm(h, lp["ln_mlp"], cfg.rms_norm_eps)
        if cfg.num_experts:
            h = h + moe.expert_mlp(r, lp, cfg, None if totals is None else totals[li],
                                   plan.batch_invariant)
        else:
            gate = torch.nn.functional.silu(lin(r, lp["w_gate"]).float()).to(dtype)
            h = h + lin(gate * lin(r, lp["w_up"]), lp["w_down"])

    h = rms_norm(h, params["ln_final"], cfg.rms_norm_eps)
    logits = lm_head_logits(h, params["lm_head"], batch_invariant=plan.batch_invariant)
    return logits, advance(plan, cache, s)
