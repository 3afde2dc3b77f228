"""Plain reference of the Mellum 2 decoder's forward, in float32 PyTorch.

Mellum2-12B-A2.5B (JetBrains; the Hugging Face ``config.json`` of
JetBrains/Mellum2-12B-A2.5B-Instruct, ``model_type`` "mellum"). For layer
``l`` of ``layer_types`` and the residual ``x`` [S, hidden]:

    a = rmsnorm(x) * g1                       eps rms_norm_eps
    q = a Wq, k = a Wk, v = a Wv              heads of head_dim; kv heads shared by
                                              heads / kv_heads query heads (GQA)
    q, k = rope_l(q), rope_l(k)               rotate-half pairs (i, i + D/2)
    s = q k^T / sqrt(head_dim)                query t sees key u iff u <= t, and
                                              for a sliding_attention layer also
                                              u > t - sliding_window
    h = x + (softmax(s) v) Wo
    b = rmsnorm(h) * g2
    p = softmax(b Wr)                         router over num_experts, float32
    (w, e) = top num_experts_per_tok of p;  w = w / sum(w)   (norm_topk_prob)
    x' = h + sum_j w_j ((silu(b Wg_e) * (b Wu_e)) Wd_e),  e = e_j

then ``rmsnorm * g_final`` and the untied head. ``rope_l`` of a
sliding_attention layer is plain RoPE at theta ``rope_theta``; of a
full_attention layer YaRN (Peng et al. 2023, arXiv:2309.00071; the
``yarn`` entry): each inverse frequency ``1/theta**(2i/D)`` blended with
itself over ``factor`` by a linear ramp over the dimensions between the
truncated correction dims of ``beta_fast`` and ``beta_slow`` rotations
within ``original_max_position_embeddings``, and cos and sin times
``attention_factor`` (so each of q and k carries it). A dense layer (the
benchmark's draft, no experts) has ``x' = h + (silu(b Wg) * (b Wu)) Wd``.

The weights are the benchmark's own tensors (``benchmarks/families/
mellum.py``): each int8 projection ``{"q", "s"}`` is dequantized to ``q *
s`` in float32 one layer at a time and applied to every sequence before
the next layer is dequantized, so the forward of several long sequences
fits beside a served model's weights. Every sum is float32 with TF32 off;
no cache, no batching across sequences, no kernel of the program.
Departures from the published description: the weights are int8 codes
with per-column scales (the router and the head bf16), as the deployment
serves them; no query/key norm and no MTP head (the config has no key for
either).

``act_quant="fp8"`` is the benchmark's control: the forward computed in
float8 e4m3 where the configuration states bf16 activations. Every
activation the program holds in bf16 (the residual stream after each add,
each projection's input and output, q and k after RoPE, the attention
weights and context, the experts' hidden activations, the head's input) is
rounded to float8 with one scale per token (its absolute maximum over
448); sums stay float32, as a float8 product's do.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Precision:
    """Where the forward rounds: nowhere (float32), or with ``act_quant="fp8"``
    every activation the program holds in bf16 to float8 e4m3 with one
    scale a token."""

    def __init__(self, act_quant: Optional[str]):
        if act_quant not in (None, "fp8"):
            raise ValueError(f"act_quant={act_quant!r}")
        self.quant = act_quant

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.quant == "fp8" else x

    def linear(self, x: torch.Tensor, w: torch.Tensor, round_out: bool = True) -> torch.Tensor:
        y = self(x) @ w
        return self(y) if round_out else y


def _rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g.float()


def _dequant(leaf: dict, *index) -> torch.Tensor:
    q, s = leaf["q"][index], leaf["s"][index]
    return q.float() * s.float().unsqueeze(-2)


def _inv_freq(w: dict, yarn: bool, device) -> torch.Tensor:
    d, theta = w["head_dim"], float(w["rope_theta"])
    pos_freqs = theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=device) / d)
    plain = 1.0 / pos_freqs
    if not yarn:
        return plain.float()
    y = w["yarn"]

    def dim_of(rotations):
        return d * math.log(y["original_max_position_embeddings"]
                            / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(dim_of(y["beta_fast"])), 0)
    high = min(math.ceil(dim_of(y["beta_slow"])), d - 1)
    high = high + 0.001 if high == low else high
    ramp = ((torch.arange(d // 2, dtype=torch.float64, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1 - ramp  # the share of the unscaled (extrapolated) frequency
    return (plain / y["factor"] * (1 - keep) + plain * keep).float()


def _rope(x: torch.Tensor, inv_freq: torch.Tensor, mscale: float) -> torch.Tensor:
    """x [S, heads, D] at positions 0..S-1."""
    pos = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)
    ang = pos[:, None] * inv_freq[None, :]
    cos = (torch.cat([ang, ang], dim=-1).cos() * mscale)[:, None, :]
    sin = (torch.cat([ang, ang], dim=-1).sin() * mscale)[:, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def _attention(h, lay, i, w, window, rnd, inv_freq, mscale):
    s = h.shape[0]
    nh, nkv, d = w["heads"], w["kv_heads"], w["head_dim"]
    r = _rms_norm(h, lay["ln_attn"][i], w["eps"])
    q = rnd(_rope(rnd.linear(r, _dequant(lay["wq"], i)).reshape(s, nh, d), inv_freq, mscale))
    k = rnd(_rope(rnd.linear(r, _dequant(lay["wk"], i)).reshape(s, nkv, d), inv_freq, mscale))
    v = rnd.linear(r, _dequant(lay["wv"], i)).reshape(s, nkv, d)
    g = nh // nkv
    q = q.transpose(0, 1).reshape(nkv, g * s, d)  # rows: query head h*g + j, position t
    scores = (q @ k.transpose(0, 1).transpose(1, 2)).reshape(nkv, g, s, s) / math.sqrt(d)
    t = torch.arange(s, device=h.device)
    vis = t[None, :] <= t[:, None]
    if window is not None:
        vis = vis & (t[None, :] > t[:, None] - window)
    probs = rnd(torch.softmax(scores.masked_fill(~vis, float("-inf")), dim=-1))
    ctx = rnd((probs @ v.transpose(0, 1)[:, None]).reshape(nh, s, d).transpose(0, 1).reshape(s, nh * d))
    return rnd(h + rnd.linear(ctx, _dequant(lay["wo"], i)))


def _experts(hs, lay, i, w, rnd):
    """Every sequence's tokens through layer i's routed experts at once (the
    layer is per token)."""
    sizes = [h.shape[0] for h in hs]
    h = torch.cat(hs)
    b = rnd(_rms_norm(h, lay["ln_mlp"][i], w["eps"]))
    p = torch.softmax(b @ lay["router"][i].float(), dim=-1)
    wt, ids = torch.topk(p, w["top_k"], dim=-1)
    if w["norm_topk_prob"]:
        wt = wt / wt.sum(dim=-1, keepdim=True)
    f = w["moe_ffn"]
    out = torch.zeros_like(h)
    for e in range(w["experts"]):
        tok, j = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = _dequant(lay["w_gate_up"], i, e)
        x = b[tok]
        a = rnd(rnd(torch.nn.functional.silu(rnd.linear(x, gu[:, :f])))
                * rnd.linear(x, gu[:, f:]))
        y = a @ _dequant(lay["w_experts_down"], i, e)
        out.index_add_(0, tok, y * wt[tok, j][:, None])
    return list((h + rnd(out)).split(sizes))


def _dense(h, lay, i, w, rnd):
    b = _rms_norm(h, lay["ln_mlp"][i], w["eps"])
    a = rnd(rnd(torch.nn.functional.silu(rnd.linear(b, _dequant(lay["w_gate"], i))))
            * rnd.linear(b, _dequant(lay["w_up"], i)))
    return rnd(h + rnd.linear(a, _dequant(lay["w_down"], i)))


def final_hidden(params: dict, w: dict, seqs: List[torch.Tensor],
                 act_quant: Optional[str] = None) -> List[torch.Tensor]:
    """Float32 hidden states after the final RMSNorm, ``[S_i, hidden]`` for
    each token sequence ``seqs[i]`` (int64 ``[S_i]``), each position
    attending as its layer's kind allows. ``w``: the role's widths
    (``families/mellum.py::widths``)."""
    rnd = _Precision(act_quant)
    lay = params["layers"]
    dev = seqs[0].device if seqs else "cpu"
    freqs = {False: _inv_freq(w, False, dev), True: _inv_freq(w, True, dev)}
    hs = [rnd(params["embed"][t].float()) for t in seqs]
    for i, kind in enumerate(w["layer_types"]):
        full = kind == "full_attention"
        window = None if full else w["window"]
        mscale = w["yarn"]["attention_factor"] if full else 1.0
        hs = [_attention(h, lay, i, w, window, rnd, freqs[full], mscale) for h in hs]
        hs = _experts(hs, lay, i, w, rnd) if w["experts"] else [_dense(h, lay, i, w, rnd)
                                                                for h in hs]
    return [_rms_norm(h, params["ln_final"], w["eps"]) for h in hs]


def head_weight(params: dict) -> torch.Tensor:
    """The untied head ``[hidden, V]`` in float32."""
    return params["lm_head"].float().t()


def logits(head: torch.Tensor, hidden: torch.Tensor, act_quant: Optional[str] = None) -> torch.Tensor:
    """Float32 logits ``[S, V]`` of final hidden states through the head
    ``head_weight(params)`` (float32 sums, as the program's)."""
    return _Precision(act_quant).linear(hidden, head, round_out=False)


def setup_precision() -> None:
    """Float32 products in full float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
