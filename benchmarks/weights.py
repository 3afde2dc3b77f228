"""The benchmark's own OPT pair: an int8 target at a published OPT width
and an independent small int8 draft, born on the device from a seed.

A frozen copy of the construction of the port's
``core/synthetic.py::synthetic_opt_pair_int8_small_draft``, so that a later
change to the program cannot change what the benchmark measures. It imports
only ``torch``: the same tensors go to the port and to the plain reference
(``benchmarks/reference/opt.py``).

The draft (``assumed`` in the configuration file: its width, depth, FFN,
``damp`` and ``embed_std``) is random. The target holds the draft's state
replicated ``r = H / h`` times at ``1 / r`` scale in its first draft-depth
layers (input-side projections divided by ``r``, residual-writing ones by
``r**2``; LayerNorm, ReLU and per-head softmax commute with the tiling), so
that at ``damp`` 0 its logits are the draft's; the deeper target layers are
random with their output projections' scales times ``damp``, which opens
the acceptance gap. Projections are ``{"q": int8 [L, K, N], "s": f32 [L,
N]}`` with codes uniform on [-127, 127] and scales putting the effective
weight's std near ``1/sqrt(K)``; biases are zero and LayerNorms one, OPT's
initial values; the head is tied to the bf16 token embedding. Each stacked
leaf is one call of a generator on the device.
"""

from __future__ import annotations

import math

import torch

POS_OFFSET = 2  # OPT's learned positions start at row 2


def widths(cfg: dict) -> dict:
    """The target's and the draft's sizes from a configuration file."""
    a = cfg["assumed"]["draft"]
    common = dict(vocab=cfg["vocab_size"], positions=cfg["max_position_embeddings"],
                  head_dim=cfg["hidden_size"] // cfg["num_attention_heads"])
    return {
        "target": dict(common, hidden=cfg["hidden_size"], ffn=cfg["ffn_dim"],
                       layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"]),
        "draft": dict(common, hidden=a["hidden_size"], ffn=a["ffn_dim"],
                      layers=a["num_hidden_layers"], heads=a["num_attention_heads"]),
    }


def _int8(gen: torch.Generator, k: int, n: int, layers: int, device) -> dict:
    q = torch.randint(-127, 128, (layers, k, n), generator=gen, dtype=torch.int8, device=device)
    base = 1.0 / (73.0 * math.sqrt(k))
    s = base * (0.8 + 0.4 * torch.rand((layers, n), generator=gen, device=device))
    return {"q": q, "s": s}


def _layers(gen: torch.Generator, h: int, f: int, n_l: int, device) -> dict:
    def const(shape, value):
        return torch.full(shape, value, dtype=torch.bfloat16, device=device)

    return {
        "wq": _int8(gen, h, h, n_l, device), "bq": const((n_l, h), 0.0),
        "wk": _int8(gen, h, h, n_l, device), "bk": const((n_l, h), 0.0),
        "wv": _int8(gen, h, h, n_l, device), "bv": const((n_l, h), 0.0),
        "wo": _int8(gen, h, h, n_l, device), "bo": const((n_l, h), 0.0),
        "fc1_w": _int8(gen, h, f, n_l, device), "fc1_b": const((n_l, f), 0.0),
        "fc2_w": _int8(gen, f, h, n_l, device), "fc2_b": const((n_l, h), 0.0),
        "ln_attn_w": const((n_l, h), 1.0), "ln_attn_b": const((n_l, h), 0.0),
        "ln_mlp_w": const((n_l, h), 1.0), "ln_mlp_b": const((n_l, h), 0.0),
    }


def _model(gen: torch.Generator, w: dict, embed_std: float, device) -> dict:
    h = w["hidden"]
    rows = w["positions"] + POS_OFFSET
    return {
        "layers": _layers(gen, h, w["ffn"], w["layers"], device),
        "embed": torch.randn((w["vocab"], h), generator=gen, dtype=torch.bfloat16,
                             device=device) * embed_std,
        "embed_pos": torch.randn((rows, h), generator=gen, dtype=torch.bfloat16,
                                 device=device) * embed_std,
        "ln_final_w": torch.ones((h,), dtype=torch.bfloat16, device=device),
        "ln_final_b": torch.zeros((h,), dtype=torch.bfloat16, device=device),
    }


def build(cfg: dict, seed: int, device) -> dict:
    """{"draft": params, "target": params, "widths": widths(cfg)}: the pair
    of ``cfg`` for ``seed``, on ``device``, in the port's layout (stacked
    ``[L, ...]`` layers, OPT's key names)."""
    w = widths(cfg)
    a = cfg["assumed"]
    wt, wd = w["target"], w["draft"]
    r = wt["hidden"] // wd["hidden"]
    if wt["hidden"] != r * wd["hidden"] or wt["ffn"] != r * wd["ffn"]:
        raise ValueError("the replication needs equal integer ratios of the widths")
    if wd["hidden"] % wt["head_dim"]:
        raise ValueError("the draft's width is not a multiple of the head size")
    ld = wd["layers"]
    seed = int(seed)
    draft = _model(torch.Generator(device=device).manual_seed(seed + 1), wd,
                   a["embed_std"], device)
    target = _model(torch.Generator(device=device).manual_seed(seed), wt, 0.02, device)
    lt = target["layers"]
    for key in ("wo", "fc2_w"):
        lt[key]["s"][ld:] *= a["damp"]
    for name, sdiv in (("wq", r), ("wk", r), ("wv", r), ("fc1_w", r),
                       ("wo", r * r), ("fc2_w", r * r)):
        q_d, s_d = draft["layers"][name]["q"], draft["layers"][name]["s"]
        k, n = q_d.shape[1:]
        lt[name]["q"][:ld].view(ld, r, k, r, n).copy_(
            q_d[:, None, :, None, :].expand(ld, r, k, r, n))
        lt[name]["s"][:ld].view(ld, r, n).copy_((s_d / sdiv)[:, None, :].expand(ld, r, n))
    inv_r = torch.tensor(1.0 / r, dtype=torch.bfloat16, device=device)
    for key in ("embed", "embed_pos"):
        rows = draft[key].shape[0]
        target[key].view(rows, r, wd["hidden"]).copy_(
            (draft[key] * inv_r)[:, None, :].expand(rows, r, wd["hidden"]))
    return {"draft": draft, "target": target, "widths": w}
