"""OPT decoder (counterpart of ``llmspeculativesampling_tpu/models/opt.py``).

The second model family (opt-125m ... opt-13b): learned positional
embeddings with OPT's +2 offset, taking explicit ``positions`` (tree nodes
at one depth share a position), pre- or post-LayerNorm
(``do_layer_norm_before``), a ReLU MLP, biases on all six projections, the
optional word-embed projections of opt-350m and a head tied to the token
embedding. Params are stacked ``[L, ...]`` like the Llama module's.

Attention is Llama's dispatch (``models/llama.py::attention_plan``): a new
block of at most 32 tokens goes to the flash-decode kernel (contiguous
cache) or the paged flash-decode kernel (paged cache), a longer one to the
einsum path, and ``paged_prefill=True`` runs block-only attention over
empty rows with the W8A16 calls planned batch-invariant. LayerNorm and
softmax run in fp32, activations stay in the config dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import OPTConfig, resolve_device
from .linear import linear, lm_head_logits
from .llama import advance, attention_plan, layer_attention, unstack_layers

POS_OFFSET = 2  # OPT's positional table reserves rows 0 and 1


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def forward(
    params: dict,
    cfg: OPTConfig,
    tokens: torch.Tensor,
    cache,
    positions: Optional[torch.Tensor] = None,
    tree_mask: Optional[torch.Tensor] = None,
    paged_prefill: bool = False,
) -> Tuple[torch.Tensor, object]:
    """Decode ``tokens`` [B, S] -> (logits [B, S, V] float32, cache + S),
    over a contiguous or a paged cache, as ``models/llama.py::forward``.

    Positions index ``embed_pos`` at ``positions + 2``; the table has
    ``max_position + 2`` rows. A position outside it raises and is never
    wrapped or clamped: before any work where the contiguous cache's host
    length shows it, else by the embedding lookup (``IndexError`` on the
    CPU, a device-side assert on the card)."""
    b, s = tokens.shape
    dev = tokens.device
    dtype = cfg.torch_dtype
    layers = unstack_layers(params)["layers"]
    plan = attention_plan(cache, s, b, dev, cfg.flash, tree_mask, paged_prefill)
    if not plan.paged and plan.length + s > cfg.max_position:
        raise ValueError(f"positions up to {plan.length + s - 1} exceed the learned table of "
                         f"{cfg.max_position} positions")
    if positions is None:
        positions = (plan.offset + torch.arange(s, device=dev)[None]).expand(b, s)

    lin = functools.partial(linear, batch_invariant=paged_prefill)
    h = params["embed"][tokens].to(dtype)
    if "project_in" in params:
        h = lin(h, params["project_in"])
    h = h + F.embedding(positions + POS_OFFSET, params["embed_pos"]).to(dtype)

    n_heads, head_dim = cfg.num_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(head_dim)
    eps, pre = cfg.layer_norm_eps, cfg.do_layer_norm_before
    for li, lp in enumerate(layers):
        r = layer_norm(h, lp["ln_attn_w"], lp["ln_attn_b"], eps) if pre else h
        q = lin(r, lp["wq"], lp["bq"]).reshape(b, s, n_heads, head_dim)
        k = lin(r, lp["wk"], lp["bk"]).reshape(b, s, n_heads, head_dim)
        v = lin(r, lp["wv"], lp["bv"]).reshape(b, s, n_heads, head_dim)
        ctx = layer_attention(plan, cache, li, q, k, v, scale, dtype)
        h = h + lin(ctx, lp["wo"], lp["bo"])
        if not pre:
            h = layer_norm(h, lp["ln_attn_w"], lp["ln_attn_b"], eps)

        r = layer_norm(h, lp["ln_mlp_w"], lp["ln_mlp_b"], eps) if pre else h
        r = torch.relu(lin(r, lp["fc1_w"], lp["fc1_b"]))
        h = h + lin(r, lp["fc2_w"], lp["fc2_b"])
        if not pre:
            h = layer_norm(h, lp["ln_mlp_w"], lp["ln_mlp_b"], eps)

    if "ln_final_w" in params and pre:
        h = layer_norm(h, params["ln_final_w"], params["ln_final_b"], eps)
    if "project_out" in params:
        h = lin(h, params["project_out"])
    head = params.get("lm_head", params["embed"])
    logits = lm_head_logits(h, head, batch_invariant=paged_prefill)
    return logits, advance(plan, cache, s)


def init_params(cfg: OPTConfig, generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Random init (tests and benchmarks without checkpoints): normal(0,
    0.02) matrices and embeddings, zero biases, unit LayerNorms."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    h, f, v, n, e = cfg.hidden_size, cfg.ffn_dim, cfg.vocab_size, cfg.num_layers, cfg.embed_dim

    def rnd(shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.02).to(dt)

    def const(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    layers = {
        "wq": rnd((n, h, h)), "bq": const((n, h), 0.0),
        "wk": rnd((n, h, h)), "bk": const((n, h), 0.0),
        "wv": rnd((n, h, h)), "bv": const((n, h), 0.0),
        "wo": rnd((n, h, h)), "bo": const((n, h), 0.0),
        "ln_attn_w": const((n, h), 1.0), "ln_attn_b": const((n, h), 0.0),
        "fc1_w": rnd((n, h, f)), "fc1_b": const((n, f), 0.0),
        "fc2_w": rnd((n, f, h)), "fc2_b": const((n, h), 0.0),
        "ln_mlp_w": const((n, h), 1.0), "ln_mlp_b": const((n, h), 0.0),
    }
    params = {
        "embed": rnd((v, e)),
        "embed_pos": rnd((cfg.max_position + POS_OFFSET, h)),
        "layers": layers,
        "ln_final_w": const((h,), 1.0),
        "ln_final_b": const((h,), 0.0),
    }
    if cfg.word_embed_proj_dim:
        params["project_in"] = rnd((e, h))
        params["project_out"] = rnd((h, e))
    return params
