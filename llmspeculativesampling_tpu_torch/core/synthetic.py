"""Synthetic draft/target pairs (counterpart of ``synthetic_pair`` and the
int8 builders of ``llmspeculativesampling_tpu/core/synthetic.py``).

Int8 weights are born int8 on the device from a seeded ``torch.Generator``:
they never exist in bf16, so the 13B pair is about 12.9 GB of int8 plus a
0.33 GB bf16 embedding. The construction is the JAX module's; the random
bits are the generator's own (the tests carry JAX weights across with
``core/convert.py`` instead).
"""

from __future__ import annotations

import math

import torch

from ..engine.types import ModelBundle
from ..models import llama
from .config import LlamaConfig, resolve_device


def synthetic_pair(
    family: str = "llama",
    *,
    hidden_size: int = 2048,
    num_layers: int = 16,
    draft_layers: int = 2,
    num_heads: int = 16,
    vocab_size: int = 32000,
    max_position: int = 2048,
    dtype: str = "bfloat16",
    damp: float = 0.02,
    seed: int = 1,
    device=None,
):
    """A random target and a draft sharing its first ``draft_layers``
    layers, deeper target layers damped so the draft approximates the
    target (the server's ``"synthetic"`` pair). Returns (bundle_d, params_d,
    bundle_t, params_t). The OPT family waits for ROADMAP A9."""
    if family != "llama":
        raise NotImplementedError(f"synthetic {family!r} pairs wait for the OPT port (ROADMAP A9)")
    dev = resolve_device(device)
    cfg_t = LlamaConfig(
        vocab_size=vocab_size, hidden_size=hidden_size, intermediate_size=4 * hidden_size,
        num_layers=num_layers, num_heads=num_heads, num_kv_heads=num_heads,
        max_position=max_position, dtype=dtype,
    )
    pt = llama.init_params(cfg_t, torch.Generator(device=dev).manual_seed(seed), device=dev)
    for key in ("wo", "w_down"):
        pt["layers"][key][draft_layers:] *= damp
    cfg_d = LlamaConfig(**{**cfg_t.__dict__, "num_layers": draft_layers})
    pd = {**{k: v for k, v in pt.items() if k != "layers"},
          "layers": {k: v[:draft_layers] for k, v in pt["layers"].items()}}
    return (ModelBundle("llama", cfg_d, llama.forward), pd,
            ModelBundle("llama", cfg_t, llama.forward), pt)


def _int8_weight(gen: torch.Generator, k: int, n: int, n_stack: int, device) -> dict:
    """Stacked [L, K, N] ``{"q": int8, "s": f32 [L, N]}``: codes uniform on
    [-127, 127], scales putting the effective weight std near 1/sqrt(K)."""
    q = torch.randint(-127, 128, (n_stack, k, n), generator=gen, dtype=torch.int8, device=device)
    base = 1.0 / (73.0 * math.sqrt(k))
    s = base * (0.8 + 0.4 * torch.rand((n_stack, n), generator=gen, device=device))
    return {"q": q, "s": s}


def synthetic_pair_int8(
    *,
    hidden_size: int = 5120,
    intermediate_size: int = 13824,
    num_layers: int = 40,
    num_heads: int = 40,
    vocab_size: int = 32000,
    draft_layers: int = 2,
    max_position: int = 2048,
    damp: float = 0.02,
    seed: int = 0,
    device=None,
):
    """Llama pair born int8 (Llama-2-13B geometry by default). The draft is
    the target's first ``draft_layers`` layers; deeper target layers are
    damped through their ``wo``/``w_down`` output scales so the draft
    approximates the target. Returns (bundle_d, params_d, bundle_t, params_t)."""
    dev = resolve_device(device)
    h, inter, n_l, v = hidden_size, intermediate_size, num_layers, vocab_size
    cfg_t = LlamaConfig(
        vocab_size=v, hidden_size=h, intermediate_size=inter, num_layers=n_l,
        num_heads=num_heads, num_kv_heads=num_heads, max_position=max_position,
        dtype="bfloat16",
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = {
        "wq": _int8_weight(gen, h, h, n_l, dev),
        "wk": _int8_weight(gen, h, h, n_l, dev),
        "wv": _int8_weight(gen, h, h, n_l, dev),
        "wo": _int8_weight(gen, h, h, n_l, dev),
        "w_gate": _int8_weight(gen, h, inter, n_l, dev),
        "w_up": _int8_weight(gen, h, inter, n_l, dev),
        "w_down": _int8_weight(gen, inter, h, n_l, dev),
        "ln_attn": torch.ones((n_l, h), dtype=torch.bfloat16, device=dev),
        "ln_mlp": torch.ones((n_l, h), dtype=torch.bfloat16, device=dev),
    }
    for key in ("wo", "w_down"):
        layers[key]["s"][draft_layers:] *= damp
    embed = torch.randn((v, h), generator=gen, dtype=torch.bfloat16, device=dev) * 0.02
    head = _int8_weight(gen, h, v, 1, dev)
    pt = {
        "embed": embed,
        "ln_final": torch.ones((h,), dtype=torch.bfloat16, device=dev),
        # quantized lm_head is unstacked {"q": [H, V], "s": [V]}
        "lm_head": {"q": head["q"][0], "s": head["s"][0]},
        "layers": layers,
    }
    cfg_d = LlamaConfig(**{**cfg_t.__dict__, "num_layers": draft_layers})
    pd = {
        **{k: x for k, x in pt.items() if k != "layers"},
        "layers": {k: ({kk: vv[:draft_layers] for kk, vv in x.items()} if isinstance(x, dict)
                       else x[:draft_layers]) for k, x in layers.items()},
    }
    return (ModelBundle("llama", cfg_d, llama.forward), pd,
            ModelBundle("llama", cfg_t, llama.forward), pt)


def synthetic_pair_int8_small_draft(
    *,
    hidden_size: int = 5120,
    intermediate_size: int = 13824,
    num_layers: int = 40,
    num_heads: int = 40,
    vocab_size: int = 32000,
    draft_hidden: int = 768,
    draft_intermediate: int = 3072,
    draft_layers: int = 2,
    max_position: int = 2048,
    damp: float = 0.008,
    embed_std: float = 0.5,
    seed: int = 0,
    device=None,
):
    """13B-geometry int8 target + an independent [768-hidden, 2-layer] int8
    draft (6 heads of 128).

    The target's first ``draft_layers`` layers embed the draft exactly:
    draft weights in the top-left block, zeros elsewhere, so the target's
    hidden dims >= 768 stay zero through those layers. RMSNorm is
    width-corrected with rho = sqrt(768/H) on the embedded layers' norm
    weights and the target's ln_final, so target logits equal draft logits
    up to the damped deeper layers, which open the acceptance gap. The
    block writes happen in place, so peak memory stays at one target."""
    dev = resolve_device(device)
    big_h, n_l, v = hidden_size, num_layers, vocab_size
    h, i_d, ld = draft_hidden, draft_intermediate, draft_layers
    head_dim = big_h // num_heads
    if h % head_dim:
        raise ValueError(f"draft width {h} is not a multiple of head_dim {head_dim}")
    cfg_d = LlamaConfig(
        vocab_size=v, hidden_size=h, intermediate_size=i_d, num_layers=ld,
        num_heads=h // head_dim, num_kv_heads=h // head_dim,
        max_position=max_position, dtype="bfloat16",
    )
    gd = torch.Generator(device=dev).manual_seed(seed + 1)
    dlay = {
        "wq": _int8_weight(gd, h, h, ld, dev),
        "wk": _int8_weight(gd, h, h, ld, dev),
        "wv": _int8_weight(gd, h, h, ld, dev),
        "wo": _int8_weight(gd, h, h, ld, dev),
        "w_gate": _int8_weight(gd, h, i_d, ld, dev),
        "w_up": _int8_weight(gd, h, i_d, ld, dev),
        "w_down": _int8_weight(gd, i_d, h, ld, dev),
        "ln_attn": torch.ones((ld, h), dtype=torch.bfloat16, device=dev),
        "ln_mlp": torch.ones((ld, h), dtype=torch.bfloat16, device=dev),
    }
    dembed = torch.randn((v, h), generator=gd, dtype=torch.bfloat16, device=dev) * embed_std
    dhead = _int8_weight(gd, h, v, 1, dev)
    pd = {
        "embed": dembed,
        "ln_final": torch.ones((h,), dtype=torch.bfloat16, device=dev),
        "lm_head": {"q": dhead["q"][0], "s": dhead["s"][0]},
        "layers": dlay,
    }

    _, _, bt, pt = synthetic_pair_int8(
        hidden_size=big_h, intermediate_size=intermediate_size, num_layers=n_l,
        num_heads=num_heads, vocab_size=v, draft_layers=ld,
        max_position=max_position, damp=damp, seed=seed, device=dev,
    )
    rho = math.sqrt(h / big_h)
    lt = pt["layers"]
    blocks = {"wq": (h, h), "wk": (h, h), "wv": (h, h), "wo": (h, h),
              "w_gate": (h, i_d), "w_up": (h, i_d), "w_down": (i_d, h)}
    for name, (k_blk, n_blk) in blocks.items():
        lt[name]["q"][:ld].zero_()
        lt[name]["q"][:ld, :k_blk, :n_blk] = dlay[name]["q"]
        lt[name]["s"][:ld, :n_blk] = dlay[name]["s"]
    # damp was applied to wo/w_down scales for layers >= ld and survives
    ln_emb = torch.zeros((ld, big_h), dtype=torch.bfloat16, device=dev)
    ln_emb[:, :h] = torch.tensor(rho, dtype=torch.bfloat16) * dlay["ln_attn"]
    lt["ln_attn"][:ld] = ln_emb
    lt["ln_mlp"][:ld] = ln_emb

    pt["embed"].zero_()
    pt["embed"][:, :h] = dembed
    pt["ln_final"] = torch.full((big_h,), rho, dtype=torch.bfloat16, device=dev)
    pt["lm_head"]["q"][:h] = dhead["q"][0]
    pt["lm_head"]["s"] = dhead["s"][0].clone()
    return ModelBundle("llama", cfg_d, llama.forward), pd, bt, pt
