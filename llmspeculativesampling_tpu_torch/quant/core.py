"""Symmetric per-output-channel weight quantization, int8 and fp8 e4m3
(counterpart of ``llmspeculativesampling_tpu/quant/core.py``).

A quantized weight is ``{"q": int8|float8_e4m3fn [..., K, N], "s": float32
[..., N]}``; stacked layer weights ``[L, K, N]`` quantize per ``(L, N)``.
The matmul applies the scale once after the K reduction ((x @ q) * s, see
``kernels/int8_matmul.py``).
"""

from __future__ import annotations

from typing import Iterable

import torch

QUANT_LEAF_Q = "q"
QUANT_LEAF_S = "s"

FP8_E4M3_MAX = 448.0

# the stacked matmul weights that quantize, per family
LLAMA_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
OPT_QUANT_KEYS = ("wq", "wk", "wv", "wo", "fc1_w", "fc2_w")
QUANT_KEYS = {"llama": LLAMA_QUANT_KEYS, "opt": OPT_QUANT_KEYS}


def is_quantized_leaf(w) -> bool:
    return isinstance(w, dict) and QUANT_LEAF_Q in w and QUANT_LEAF_S in w


def quantize_tensor(w: torch.Tensor, fmt: str = "int8") -> dict:
    """Quantize ``[..., K, N]`` over K -> per-N scales."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)  # [..., N]
    if fmt == "fp8_e4m3":
        scale = torch.clamp(amax / FP8_E4M3_MAX, min=1e-8)
        q = (wf / scale[..., None, :]).to(torch.float8_e4m3fn)
    elif fmt == "int8":
        scale = torch.clamp(amax / 127.0, min=1e-8)
        q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    else:
        raise ValueError(f"unknown weight-quant fmt {fmt!r}")
    return {QUANT_LEAF_Q: q, QUANT_LEAF_S: scale}


def dequantize_tensor(wq: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (wq[QUANT_LEAF_Q].float() * wq[QUANT_LEAF_S][..., None, :]).to(dtype)


def quantize_params(params: dict, family: str = "llama", quantize_lm_head: bool = False,
                    extra_keys: Iterable[str] = (), fmt: str = "int8") -> dict:
    """Quantize the matmul weights of a llama or opt param tree (the
    family's keys plus ``extra_keys``; another family raises). A quantized
    ``lm_head`` ``[V, H]`` is re-laid-out to ``{"q": [H, V], "s": [V]}``; a
    tied head (OPT) stays the dense embedding."""
    if family not in QUANT_KEYS:
        raise ValueError(f"no quantized keys for the {family!r} family")
    keys = set(QUANT_KEYS[family] + tuple(extra_keys))
    out = dict(params)
    out["layers"] = {k: (quantize_tensor(v, fmt) if k in keys else v)
                     for k, v in params["layers"].items()}
    if quantize_lm_head and "lm_head" in params:
        out["lm_head"] = quantize_tensor(params["lm_head"].transpose(-1, -2), fmt)
    return out


def quantized_bytes(params) -> int:
    """Device bytes of a param tree (every tensor leaf)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    return params.numel() * params.element_size()
