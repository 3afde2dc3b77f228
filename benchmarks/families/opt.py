"""The OPT family: the benchmark's OPT pair (``benchmarks/weights.py``), the
port's OPT model for it, the plain reference (``benchmarks/reference/opt.py``)
and OPT's six int8 projections a layer."""

from __future__ import annotations

from types import SimpleNamespace

from benchmarks import weights
from benchmarks.reference import opt as _reference

FAMILY = "opt"


def widths(cfg: dict) -> dict:
    """``weights.widths`` with the family's name and ``kv_heads`` (OPT's
    attention has a K and a V head for each query head)."""
    return {role: dict(w, kv_heads=w["heads"], family=FAMILY)
            for role, w in weights.widths(cfg).items()}


def build(cfg: dict, seed: int, device) -> dict:
    """``weights.build``: its tensors as they are, with this family's widths."""
    pair = weights.build(cfg, seed, device)
    pair["widths"] = widths(cfg)
    return pair


def bundles(pair: dict, kv_quant: bool) -> dict:
    """{role: ModelBundle} of the port for the benchmark's pair."""
    from llmspeculativesampling_tpu_torch import ModelBundle, OPTConfig
    from llmspeculativesampling_tpu_torch.models import opt

    out = {}
    for role in ("draft", "target"):
        w = pair["widths"][role]
        cfg = OPTConfig(vocab_size=w["vocab"], hidden_size=w["hidden"], ffn_dim=w["ffn"],
                        num_layers=w["layers"], num_heads=w["heads"],
                        max_position=w["positions"], dtype="bfloat16")
        out[role] = ModelBundle("opt", cfg, opt.forward, kv_quant=kv_quant)
    return out


def _final_hidden(params: dict, w: dict, seqs, act_quant=None):
    return _reference.final_hidden(params, w["heads"], seqs, act_quant=act_quant)


reference = SimpleNamespace(setup_precision=_reference.setup_precision,
                            head_weight=_reference.head_weight,
                            final_hidden=_final_hidden,
                            logits=_reference.logits)


def projections(w: dict, m: float) -> list:
    """(rows, K, N) of the six int8 projections of one OPT layer in a forward
    of ``m`` token rows: q, k, v, out, fc1, fc2, each over every row."""
    h, f = w["hidden"], w["ffn"]
    return [(m, h, h)] * 4 + [(m, h, f), (m, f, h)]
