"""The Mellum 2 family: its benchmark pair, born on the device from a seed,
the port's Mellum model for it, the plain reference
(``benchmarks/reference/mellum.py``), its dense int8 products a layer and
the routed experts' work (B4).

The pair (``assumed`` in the configuration file). Every layer projection is
int8 with one float32 scale an output column (codes uniform on [-127,
127], scales putting the effective weight's std near ``1/sqrt(K)``), the
query and key projections times ``qk_gain`` (peaked attention, so that
which positions a layer reads shows in its output), the experts' down
projections times ``moe_gain`` (a weighted mean of k experts' outputs is
about 1/sqrt(k) of one's and SiLU-gating shrinks it again: the gain gives
the expert layer the attention's scale), the router bf16 with std
``router_std / sqrt(hidden)``, RMSNorm weights one; a bf16 embedding of
std ``embed_std`` whose first dimension is the constant ``embed_const``
(a direction every token's normed residual holds, which the routers read,
below), and an untied bf16 head of std ``head_std`` with that dimension 0.

The draft is a dense decoder of Mellum's own layer form (``assumed.draft``:
its layer types, its SwiGLU as wide as top-k experts) sharing the
target's embedding and head tensors. The target holds the draft in the
first of its layers whose kinds match the draft's (layers 2 and 3 at the
published size): the same attention weights, and an expert layer whose
router sends every token to experts 0..k-1 with equal weights (every
router column the same, the other experts' ``router_gap`` lower on the
constant dimension: they keep a share of the softmax's mass, which
``norm_topk_prob`` removes, but never enter the top k), those experts'
gate, up and down the draft's SwiGLU cut into k slices (down times k). So at ``damp`` 0 the target computes the
draft and both agree on every token, as the OPT pairs' targets hold their
drafts (``benchmarks/weights.py``). Every other target layer writes its
residual (``wo``, the experts' down) with its scales times ``damp``, which
sets how often it overturns the draft's choice; their routers do not read
the constant dimension. Each stacked leaf is one call of a generator on
the device.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from benchmarks.reference import mellum as _reference

FAMILY = "mellum"
BF16, F32, INT8 = 2, 4, 1


def widths(cfg: dict) -> dict:
    """The target's and the draft's sizes from a configuration file."""
    a = cfg["assumed"]["draft"]
    rope = cfg["rope_parameters"]
    common = dict(family=FAMILY, hidden=cfg["hidden_size"], heads=cfg["num_attention_heads"],
                  kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
                  vocab=cfg["vocab_size"], window=cfg["sliding_window"],
                  eps=cfg["rms_norm_eps"], positions=cfg["max_position_embeddings"],
                  rope_theta=rope["sliding_attention"]["rope_theta"],
                  yarn={k: rope["full_attention"][k] for k in
                        ("factor", "original_max_position_embeddings", "beta_fast",
                         "beta_slow", "attention_factor")},
                  norm_topk_prob=cfg["norm_topk_prob"])
    if rope["full_attention"]["rope_theta"] != common["rope_theta"]:
        raise ValueError("the port takes one rope_theta for both kinds of layer")
    return {
        "target": dict(common, layers=cfg["num_hidden_layers"],
                       layer_types=list(cfg["layer_types"]), experts=cfg["num_experts"],
                       top_k=cfg["num_experts_per_tok"], moe_ffn=cfg["moe_intermediate_size"],
                       ffn=0, pinned=len(a["layer_types"])),
        "draft": dict(common, layers=len(a["layer_types"]), layer_types=list(a["layer_types"]),
                      experts=0, top_k=0, moe_ffn=0, ffn=a["intermediate_size"]),
    }


def _int8(gen, shape, device, gain: float = 1.0) -> dict:
    k = shape[-2]
    q = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device=device)
    base = gain / (73.0 * math.sqrt(k))
    s = base * (0.8 + 0.4 * torch.rand(shape[:-2] + shape[-1:], generator=gen, device=device))
    return {"q": q, "s": s}


def _layers(gen, w: dict, a: dict, device, damp: float) -> dict:
    n, h, d = w["layers"], w["hidden"], w["head_dim"]
    qw, kvw = w["heads"] * d, w["kv_heads"] * d
    gain = a["qk_gain"]
    out = {
        "wq": _int8(gen, (n, h, qw), device, gain), "wk": _int8(gen, (n, h, kvw), device, gain),
        "wv": _int8(gen, (n, h, kvw), device), "wo": _int8(gen, (n, qw, h), device, damp),
        "ln_attn": torch.ones((n, h), dtype=torch.bfloat16, device=device),
        "ln_mlp": torch.ones((n, h), dtype=torch.bfloat16, device=device),
    }
    if w["experts"]:
        e, f = w["experts"], w["moe_ffn"]
        router = torch.randn((n, h, e), generator=gen, device=device) * (a["router_std"]
                                                                        / math.sqrt(h))
        router[:, 0] = 0.0  # the constant dimension routes nothing
        out["router"] = router.to(torch.bfloat16)
        out["w_gate_up"] = _int8(gen, (n, e, h, 2 * f), device)
        out["w_experts_down"] = _int8(gen, (n, e, f, h), device, damp * a["moe_gain"])
    else:
        f = w["ffn"]
        out["w_gate"] = _int8(gen, (n, h, f), device)
        out["w_up"] = _int8(gen, (n, h, f), device)
        out["w_down"] = _int8(gen, (n, f, h), device, damp)
    return out


def build(cfg: dict, seed: int, device) -> dict:
    """{"draft": params, "target": params, "widths": widths(cfg)}: the pair
    of ``cfg`` for ``seed``, on ``device``, in the port's layout (stacked
    ``[L, ...]`` layers; experts ``[L, E, ...]``). The draft's ``embed`` and
    ``lm_head`` are the target's tensors. The target's params hold
    ``routed_rows``, zeros the program adds each layer's routed pairs to;
    the widths hold the same tensor under that key, the one way a metric
    reader (which sees the widths) reaches it."""
    w = widths(cfg)
    a = cfg["assumed"]
    seed = int(seed)
    wt, wd = w["target"], w["draft"]
    if wd["ffn"] != wt["top_k"] * wt["moe_ffn"]:
        raise ValueError("the draft's SwiGLU must be as wide as top-k experts")
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = torch.randn((wt["vocab"], wt["hidden"]), generator=gen, device=device) * a["embed_std"]
    embed[:, 0] = a["embed_const"]
    head = torch.randn((wt["vocab"], wt["hidden"]), generator=gen, device=device) * a["head_std"]
    head[:, 0] = 0.0
    shared = {"embed": embed.to(torch.bfloat16), "lm_head": head.to(torch.bfloat16),
              "ln_final": torch.ones((wt["hidden"],), dtype=torch.bfloat16, device=device)}
    out = {"widths": w}
    for role, offset, damp in (("target", 0, a["damp"]), ("draft", 1, 1.0)):
        g = torch.Generator(device=device).manual_seed(seed + 1 + offset)
        out[role] = dict(shared, layers=_layers(g, w[role], a, device, damp))
    _hold_draft(out["target"]["layers"], out["draft"]["layers"], wt, wd, a)
    routed = torch.zeros((wt["layers"], wt["experts"]), dtype=torch.int64, device=device)
    out["target"]["routed_rows"] = w["routed_rows"] = routed
    return out


def pinned_at(wt: dict, wd: dict) -> int:
    """The first target layer of the run whose kinds match the draft's."""
    k = wd["layers"]
    for i in range(wt["layers"] - k + 1):
        if wt["layer_types"][i:i + k] == wd["layer_types"]:
            return i
    raise ValueError("no run of target layers has the draft's layer kinds")


def _hold_draft(lt: dict, ld: dict, wt: dict, wd: dict, a: dict) -> None:
    """Copy the draft's layers into the target's run that matches them: the
    attention as it is, the dense SwiGLU as experts 0..k-1 of an expert
    layer that routes every token to them with weights 1/k."""
    i0, k, f = pinned_at(wt, wd), wt["top_k"], wt["moe_ffn"]
    for j in range(wd["layers"]):
        t = i0 + j
        for key in ("wq", "wk", "wv", "wo"):
            lt[key]["q"][t].copy_(ld[key]["q"][j])
            lt[key]["s"][t].copy_(ld[key]["s"][j])
        for e in range(k):
            cols = slice(e * f, (e + 1) * f)
            gu = lt["w_gate_up"]
            gu["q"][t, e, :, :f].copy_(ld["w_gate"]["q"][j][:, cols])
            gu["q"][t, e, :, f:].copy_(ld["w_up"]["q"][j][:, cols])
            gu["s"][t, e, :f].copy_(ld["w_gate"]["s"][j][cols])
            gu["s"][t, e, f:].copy_(ld["w_up"]["s"][j][cols])
            lt["w_experts_down"]["q"][t, e].copy_(ld["w_down"]["q"][j][cols])
            lt["w_experts_down"]["s"][t, e].copy_(ld["w_down"]["s"][j] * k)
        router = lt["router"][t]
        router[:, 1:] = router[:, :1]
        router[0, k:] = -a["router_gap"]


def bundles(pair: dict, kv_quant: bool) -> dict:
    """{role: ModelBundle} of the port for the benchmark's pair."""
    from llmspeculativesampling_tpu_torch import MellumConfig, ModelBundle
    from llmspeculativesampling_tpu_torch.models import mellum

    out = {}
    for role in ("draft", "target"):
        w = pair["widths"][role]
        y = w["yarn"]
        cfg = MellumConfig(
            vocab_size=w["vocab"], hidden_size=w["hidden"], intermediate_size=w["ffn"],
            moe_intermediate_size=w["moe_ffn"], num_layers=w["layers"], num_heads=w["heads"],
            num_kv_heads=w["kv_heads"], head_dim=w["head_dim"], num_experts=w["experts"],
            num_experts_per_tok=w["top_k"], norm_topk_prob=w["norm_topk_prob"],
            layer_types=tuple(w["layer_types"]), sliding_window=w["window"],
            rope_theta=float(w["rope_theta"]),
            full_rope=("yarn", float(y["factor"]), int(y["original_max_position_embeddings"]),
                       float(y["beta_fast"]), float(y["beta_slow"]),
                       float(y["attention_factor"])),
            rms_norm_eps=w["eps"], max_position=w["positions"], dtype="bfloat16")
        out[role] = ModelBundle(FAMILY, cfg, mellum.forward, kv_quant=kv_quant)
    return out


reference = SimpleNamespace(setup_precision=_reference.setup_precision,
                            head_weight=_reference.head_weight,
                            final_hidden=_reference.final_hidden,
                            logits=_reference.logits)


def projections(w: dict, m: float) -> list:
    """(rows, K, N) of the dense int8 products (B1) of one layer in a forward
    of ``m`` token rows: q, k, v, o, and a dense layer's gate, up and down.
    The routed experts run on B4 and are counted by :func:`expert_work`."""
    h, qw, kvw = w["hidden"], w["heads"] * w["head_dim"], w["kv_heads"] * w["head_dim"]
    out = [(m, h, qw), (m, h, kvw), (m, h, kvw), (m, qw, h)]
    if not w["experts"]:
        out += [(m, h, w["ffn"]), (m, h, w["ffn"]), (m, w["ffn"], h)]
    return out


def experts_touched(w: dict, m: float) -> float:
    """Experts a forward of ``m`` token rows touches, expected under uniform
    routing: ``E (1 - (1 - k/E)^m)``."""
    e, k = w["experts"], w["top_k"]
    return e * (1.0 - (1.0 - k / e) ** m) if e else 0.0


def expert_work(w: dict, m: float) -> tuple:
    """(bytes, flops) the B4 products of one layer, averaged over the
    layers, need in a forward of ``m`` token rows: the touched experts'
    int8 codes and float32 scales read once (a layer holding the draft
    touches its k experts only), the routed rows (``m * top_k``) read once
    in bf16 and written once (gate and up in bf16, down in float32), and
    ``2 * rows * K * N`` for each product."""
    if not w["experts"]:
        return 0.0, 0.0
    h, f, n, p = w["hidden"], w["moe_ffn"], w["layers"], w.get("pinned", 0)
    rows = m * w["top_k"]
    touched = ((n - p) * experts_touched(w, m) + p * min(w["top_k"], m * w["top_k"])) / n
    weights = touched * (h * 2 * f * INT8 + 2 * f * F32 + f * h * INT8 + h * F32)
    gate_up = rows * h * BF16 + rows * 2 * f * BF16
    down = rows * f * BF16 + rows * h * F32
    return weights + gate_up + down, 2.0 * rows * (h * 2 * f + f * h)


def router_flops(w: dict, m: float) -> float:
    """FLOPs of one layer's router product in a forward of ``m`` rows."""
    return 2.0 * m * w["hidden"] * w["experts"]
