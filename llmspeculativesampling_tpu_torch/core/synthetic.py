"""Synthetic draft/target pairs (counterpart of ``synthetic_pair`` and the
int8 builders of ``llmspeculativesampling_tpu/core/synthetic.py``), Llama
and OPT.

Int8 weights are born int8 on the device from a seeded ``torch.Generator``:
they never exist in bf16, so the 13B Llama pair is about 12.9 GB of int8
plus a 0.33 GB bf16 embedding, and the OPT-13B pair 12.6 GB of int8 plus a
0.51 GB bf16 tied embedding. The construction is the JAX module's; the random
bits are the generator's own (the tests carry JAX weights across with
``core/convert.py`` instead).
"""

from __future__ import annotations

import math

import torch

from ..engine.types import ModelBundle
from ..models import llama, opt
from .config import LlamaConfig, OPTConfig, resolve_device


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
    layers, deeper target layers damped (their output projections ``wo``
    and ``w_down`` / ``fc2_w``) so the draft approximates the target (the
    server's ``"synthetic"`` pair). ``family`` is "llama" or "opt". Returns
    (bundle_d, params_d, bundle_t, params_t)."""
    dev = resolve_device(device)
    if family == "llama":
        mod, out_keys = llama, ("wo", "w_down")
        cfg_t = LlamaConfig(
            vocab_size=vocab_size, hidden_size=hidden_size, intermediate_size=4 * hidden_size,
            num_layers=num_layers, num_heads=num_heads, num_kv_heads=num_heads,
            max_position=max_position, dtype=dtype,
        )
    elif family == "opt":
        mod, out_keys = opt, ("wo", "fc2_w")
        cfg_t = OPTConfig(
            vocab_size=vocab_size, hidden_size=hidden_size, ffn_dim=4 * hidden_size,
            num_layers=num_layers, num_heads=num_heads, max_position=max_position, dtype=dtype,
        )
    else:
        raise ValueError(f"unknown family {family!r}")
    pt = mod.init_params(cfg_t, torch.Generator(device=dev).manual_seed(seed), device=dev)
    for key in out_keys:
        pt["layers"][key][draft_layers:] *= damp
    cfg_d = type(cfg_t)(**{**cfg_t.__dict__, "num_layers": draft_layers})
    pd = {**{k: v for k, v in pt.items() if k != "layers"},
          "layers": {k: v[:draft_layers] for k, v in pt["layers"].items()}}
    return (ModelBundle(family, cfg_d, mod.forward), pd,
            ModelBundle(family, cfg_t, mod.forward), pt)


def _first_layers(layers: dict, n: int) -> dict:
    """Views of the first ``n`` layers of a stacked layer dict."""
    return {k: ({kk: vv[:n] for kk, vv in x.items()} if isinstance(x, dict) else x[:n])
            for k, x in layers.items()}


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
    pd = {**{k: x for k, x in pt.items() if k != "layers"},
          "layers": _first_layers(layers, draft_layers)}
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


def _opt_layers(gen: torch.Generator, h: int, f: int, n_l: int, device) -> dict:
    """Stacked int8 OPT layers: the six projections born int8, biases at
    zero and LayerNorms at one (OPT's init values)."""
    def const(shape, value):
        return torch.full(shape, value, dtype=torch.bfloat16, device=device)

    return {
        "wq": _int8_weight(gen, h, h, n_l, device), "bq": const((n_l, h), 0.0),
        "wk": _int8_weight(gen, h, h, n_l, device), "bk": const((n_l, h), 0.0),
        "wv": _int8_weight(gen, h, h, n_l, device), "bv": const((n_l, h), 0.0),
        "wo": _int8_weight(gen, h, h, n_l, device), "bo": const((n_l, h), 0.0),
        "fc1_w": _int8_weight(gen, h, f, n_l, device), "fc1_b": const((n_l, f), 0.0),
        "fc2_w": _int8_weight(gen, f, h, n_l, device), "fc2_b": const((n_l, h), 0.0),
        "ln_attn_w": const((n_l, h), 1.0), "ln_attn_b": const((n_l, h), 0.0),
        "ln_mlp_w": const((n_l, h), 1.0), "ln_mlp_b": const((n_l, h), 0.0),
    }


def synthetic_opt_pair_int8(
    *,
    hidden_size: int = 5120,
    ffn_dim: int = 20480,
    num_layers: int = 40,
    num_heads: int = 40,
    vocab_size: int = 50272,
    draft_layers: int = 2,
    max_position: int = 2048,
    damp: float = 0.02,
    seed: int = 3,
    device=None,
):
    """OPT pair born int8 at opt-13b geometry: the draft is the target's
    first ``draft_layers`` layers at full width; deeper target layers are
    damped through their ``wo``/``fc2_w`` output scales so the draft
    approximates the target. The head is tied to the bf16 embedding, as
    opt-13b's. Returns (bundle_d, params_d, bundle_t, params_t)."""
    dev = resolve_device(device)
    h, f, n_l, v = hidden_size, ffn_dim, num_layers, vocab_size
    cfg_t = OPTConfig(vocab_size=v, hidden_size=h, ffn_dim=f, num_layers=n_l,
                      num_heads=num_heads, max_position=max_position, dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = _opt_layers(gen, h, f, n_l, dev)
    for key in ("wo", "fc2_w"):
        layers[key]["s"][draft_layers:] *= damp
    pt = {
        "embed": torch.randn((v, h), generator=gen, dtype=torch.bfloat16, device=dev) * 0.02,
        "embed_pos": torch.randn((max_position + opt.POS_OFFSET, h), generator=gen,
                                 dtype=torch.bfloat16, device=dev) * 0.02,
        "layers": layers,
        "ln_final_w": torch.ones((h,), dtype=torch.bfloat16, device=dev),
        "ln_final_b": torch.zeros((h,), dtype=torch.bfloat16, device=dev),
    }
    cfg_d = OPTConfig(**{**cfg_t.__dict__, "num_layers": draft_layers})
    pd = {**{k: x for k, x in pt.items() if k != "layers"},
          "layers": _first_layers(layers, draft_layers)}
    return ModelBundle("opt", cfg_d, opt.forward), pd, ModelBundle("opt", cfg_t, opt.forward), pt


def synthetic_opt_pair_int8_small_draft(
    *,
    hidden_size: int = 5120,
    ffn_dim: int = 20480,
    num_layers: int = 40,
    num_heads: int = 40,
    vocab_size: int = 50272,
    draft_hidden: int = 640,
    draft_ffn: int = 2560,
    draft_layers: int = 2,
    max_position: int = 2048,
    damp: float = 0.65,
    embed_std: float = 0.5,
    seed: int = 3,
    device=None,
):
    """opt-13b-geometry int8 target + an independent 125m-scale int8 draft
    (640 hidden, 2 layers, 5 heads of 128) with tied heads: the
    reference's OPT pairing (opt-125m drafting for opt-13b).

    The target carries the draft's state replicated r = H/h times at 1/r
    scale (the JAX construction): LayerNorm of ``tile(x)/r`` is
    ``tile(LN(x))`` (mean and variance are the draft's; the 1/r cancels up
    to eps, which ``embed_std`` keeps small beside the variance), so the
    target's first ``draft_layers`` layers hold the draft's weights tiled
    over r x r blocks: the input-side projections (wq/wk/wv/fc1) divided by
    r, the residual-writing ones (wo/fc2) by r^2; ReLU and per-head
    softmax commute with the tiling (each group of the draft's heads
    repeats). embed and embed_pos are tiled and divided by r, and the tied
    head gives ``tile(h) . tile(e)/r = h . e``: at damp 0 the target's
    logits are the draft's up to bf16 rounding; damp on the deeper layers
    opens the acceptance gap. The tiling writes the target's tensors in
    place (no bf16 or second int8 copy of the stack). Returns (bundle_d,
    params_d, bundle_t, params_t)."""
    dev = resolve_device(device)
    big_h, big_f, v = hidden_size, ffn_dim, vocab_size
    h, f, ld = draft_hidden, draft_ffn, draft_layers
    r = big_h // h
    head_dim = big_h // num_heads
    if big_h != r * h or big_f != r * f:
        raise ValueError(f"replication needs equal integer ratios: {big_h}/{h}, {big_f}/{f}")
    if h % head_dim:
        raise ValueError(f"draft width {h} is not a multiple of head_dim {head_dim}")
    cfg_d = OPTConfig(vocab_size=v, hidden_size=h, ffn_dim=f, num_layers=ld,
                      num_heads=h // head_dim, max_position=max_position, dtype="bfloat16")
    gd = torch.Generator(device=dev).manual_seed(seed + 1)
    dlay = _opt_layers(gd, h, f, ld, dev)
    pd = {
        "embed": torch.randn((v, h), generator=gd, dtype=torch.bfloat16, device=dev) * embed_std,
        "embed_pos": torch.randn((max_position + opt.POS_OFFSET, h), generator=gd,
                                 dtype=torch.bfloat16, device=dev) * embed_std,
        "layers": dlay,
        "ln_final_w": torch.ones((h,), dtype=torch.bfloat16, device=dev),
        "ln_final_b": torch.zeros((h,), dtype=torch.bfloat16, device=dev),
    }  # the head is tied to embed, as the target's

    _, _, bt, pt = synthetic_opt_pair_int8(
        hidden_size=big_h, ffn_dim=big_f, num_layers=num_layers, num_heads=num_heads,
        vocab_size=v, draft_layers=ld, max_position=max_position, damp=damp, seed=seed,
        device=dev)
    lt = pt["layers"]
    for name, sdiv in (("wq", r), ("wk", r), ("wv", r), ("fc1_w", r),
                       ("wo", r * r), ("fc2_w", r * r)):
        q_d, s_d = dlay[name]["q"], dlay[name]["s"]
        k, n = q_d.shape[1:]
        lt[name]["q"][:ld].view(ld, r, k, r, n).copy_(q_d[:, None, :, None, :].expand(
            ld, r, k, r, n))
        lt[name]["s"][:ld].view(ld, r, n).copy_((s_d / sdiv)[:, None, :].expand(ld, r, n))
    inv_r = torch.tensor(1.0 / r, dtype=torch.bfloat16, device=dev)
    for key in ("embed", "embed_pos"):
        rows = pd[key].shape[0]
        pt[key].view(rows, r, h).copy_((pd[key] * inv_r)[:, None, :].expand(rows, r, h))
    # biases and LayerNorms: the draft's init values (zeros, ones) tile to
    # the target's own
    return ModelBundle("opt", cfg_d, opt.forward), pd, bt, pt
