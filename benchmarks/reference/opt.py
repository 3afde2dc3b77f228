"""Plain reference of the OPT decoder's forward, in float32 PyTorch.

OPT (Zhang et al. 2022, arXiv:2205.01068; the Hugging Face ``OPTForCausalLM``
of facebook/opt-13b and opt-30b): learned positions at ``position + 2``,
pre-LayerNorm blocks (eps 1e-5) with biases on all six projections,
multi-head causal softmax attention scaled by ``1/sqrt(head_dim)``, a ReLU
MLP, a final LayerNorm and a head tied to the token embedding.

The weights are the benchmark's own tensors (``benchmarks/weights.py``):
each int8 projection ``{"q", "s"}`` is dequantized to ``q * s`` in float32,
one layer at a time, and applied to every sequence before the next layer is
dequantized, so the whole forward of several sequences fits beside a
served model's weights. Every sum is float32 with TF32 off; no cache, no
batching across sequences, no kernel of the program. Departures from the
published description: none in the equations; the weights are int8 codes
with per-column scales, as the deployment serves them.

``act_quant="fp8"`` is the benchmark's control: the forward computed in
float8 e4m3 where the configuration states bf16 activations. Every
activation the program holds in bf16 (the residual stream after each add,
each projection's input and output, the attention weights and context, the
head's input) is rounded to float8 with one scale per token (its absolute
maximum over 448); sums stay float32, as a float8 product's do.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

POS_OFFSET = 2
LN_EPS = 1e-5
FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * w.float() + b.float()


def _dequant(leaf: dict, i: int) -> torch.Tensor:
    return leaf["q"][i].float() * leaf["s"][i].float()[None, :]


class _Precision:
    """Where the forward rounds: nowhere (float32), or with ``act_quant="fp8"``
    every activation the program holds in bf16 (the residual stream, each
    projection's input and output, the attention weights and context) to
    float8 e4m3 with one scale a token."""

    def __init__(self, act_quant: Optional[str]):
        if act_quant not in (None, "fp8"):
            raise ValueError(f"act_quant={act_quant!r}")
        self.quant = act_quant

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.quant == "fp8" else x

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
               round_out: bool = True) -> torch.Tensor:
        y = self(x) @ w
        if b is not None:
            y = y + b.float()
        return self(y) if round_out else y


def final_hidden(params: dict, heads: int, seqs: List[torch.Tensor],
                 act_quant: Optional[str] = None) -> List[torch.Tensor]:
    """Float32 hidden states after the final LayerNorm, ``[S_i, H]`` for
    each token sequence ``seqs[i]`` (int64 ``[S_i]``), every position
    attending to itself and the positions before it."""
    rnd = _Precision(act_quant)
    lay = params["layers"]
    n_layers = lay["wq"]["q"].shape[0]
    hs = [rnd(params["embed"][t].float() + params["embed_pos"][
        torch.arange(t.shape[0], device=t.device) + POS_OFFSET].float()) for t in seqs]
    for i in range(n_layers):
        wq, wk, wv, wo = (_dequant(lay[k], i) for k in ("wq", "wk", "wv", "wo"))
        for j, h in enumerate(hs):
            s, width = h.shape
            d = width // heads
            r = _layer_norm(h, lay["ln_attn_w"][i], lay["ln_attn_b"][i])
            q, k, v = (rnd.linear(r, w, lay[b][i]).reshape(s, heads, d).transpose(0, 1)
                       for w, b in ((wq, "bq"), (wk, "bk"), (wv, "bv")))
            scores = (q @ k.transpose(1, 2)) / math.sqrt(d)
            causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
            probs = rnd(torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1))
            ctx = rnd((probs @ v).transpose(0, 1).reshape(s, width))
            hs[j] = rnd(h + rnd.linear(ctx, wo, lay["bo"][i]))
        del wq, wk, wv, wo
        fc1, fc2 = _dequant(lay["fc1_w"], i), _dequant(lay["fc2_w"], i)
        for j, h in enumerate(hs):
            r = _layer_norm(h, lay["ln_mlp_w"][i], lay["ln_mlp_b"][i])
            a = torch.relu(rnd.linear(r, fc1, lay["fc1_b"][i]))
            hs[j] = rnd(h + rnd.linear(a, fc2, lay["fc2_b"][i]))
        del fc1, fc2
    return [_layer_norm(h, params["ln_final_w"], params["ln_final_b"]) for h in hs]


def head_weight(params: dict) -> torch.Tensor:
    """The tied head ``[H, V]`` in float32 (the token embedding, transposed)."""
    return params["embed"].float().t()


def logits(head: torch.Tensor, hidden: torch.Tensor, act_quant: Optional[str] = None) -> torch.Tensor:
    """Float32 logits ``[S, V]`` of final hidden states through the head
    ``head_weight(params)`` (float32 sums, as the program's)."""
    return _Precision(act_quant).linear(hidden, head, round_out=False)


def setup_precision() -> None:
    """Float32 products in full float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
