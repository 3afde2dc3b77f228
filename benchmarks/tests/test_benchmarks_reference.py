"""The plain reference against a hand-checked tiny OPT forward, and the
benchmark's weights: the target at damp 0 gives the draft's logits."""

import math

import numpy as np
import torch

from benchmarks import weights
from benchmarks.reference import opt as reference

TINY = {"hidden_size": 64, "ffn_dim": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
        "vocab_size": 96, "max_position_embeddings": 32,
        "assumed": {"draft": {"hidden_size": 32, "ffn_dim": 64, "num_hidden_layers": 1,
                              "num_attention_heads": 1}, "damp": 0.5, "embed_std": 0.5}}


def _by_hand(p: dict, heads: int, tokens) -> np.ndarray:
    """OPT's equations one position at a time, in float64 numpy."""
    f = {k: (v.double().numpy() if torch.is_tensor(v) else v) for k, v in p.items()}
    lay = {k: ({kk: vv.double().numpy() for kk, vv in v.items()} if isinstance(v, dict)
               else v.double().numpy()) for k, v in p["layers"].items()}

    def ln(x, w, b):
        mu = x.mean()
        return (x - mu) / math.sqrt(((x - mu) ** 2).mean() + 1e-5) * w + b

    def proj(x, name, i):
        return x @ (lay[name]["q"][i] * lay[name]["s"][i][None, :])

    n_layers = lay["wq"]["q"].shape[0]
    hs = [f["embed"][t] + f["embed_pos"][j + 2] for j, t in enumerate(tokens)]
    for i in range(n_layers):
        ks, vs, out = [], [], []
        for j, h in enumerate(hs):
            r = ln(h, lay["ln_attn_w"][i], lay["ln_attn_b"][i])
            q = proj(r, "wq", i) + lay["bq"][i]
            ks.append(proj(r, "wk", i) + lay["bk"][i])
            vs.append(proj(r, "wv", i) + lay["bv"][i])
            d = len(q) // heads
            ctx = np.zeros_like(q)
            for hd in range(heads):
                sl = slice(hd * d, (hd + 1) * d)
                sc = np.array([q[sl] @ k[sl] for k in ks]) / math.sqrt(d)
                pr = np.exp(sc - sc.max())
                pr /= pr.sum()
                ctx[sl] = sum(pj * v[sl] for pj, v in zip(pr, vs))
            h = h + proj(ctx, "wo", i) + lay["bo"][i]
            r = ln(h, lay["ln_mlp_w"][i], lay["ln_mlp_b"][i])
            h = h + proj(np.maximum(proj(r, "fc1_w", i) + lay["fc1_b"][i], 0), "fc2_w", i) + \
                lay["fc2_b"][i]
            out.append(h)
        hs = out
    return np.stack([ln(h, f["ln_final_w"], f["ln_final_b"]) @ f["embed"].T for h in hs])


def _perturb(params: dict, gen: torch.Generator) -> None:
    """Non-trivial biases and LayerNorms, so the check sees them."""
    for k, v in params["layers"].items():
        if not isinstance(v, dict):
            v.copy_((torch.randn(v.shape, generator=gen) * 0.1
                     + (1.0 if k.startswith("ln_") and k.endswith("_w") else 0.0)).to(v.dtype))


def test_reference_matches_hand_forward():
    pair = weights.build(TINY, 5, torch.device("cpu"))
    p = pair["target"]
    _perturb(p, torch.Generator().manual_seed(0))
    tokens = [3, 17, 40, 2, 95, 11, 60]
    got = reference.logits(reference.head_weight(p), reference.final_hidden(
        p, 2, [torch.tensor(tokens)])[0])
    want = _by_hand(p, 2, tokens)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-4, atol=1e-4)


def test_target_at_damp_zero_is_the_draft():
    cfg = dict(TINY, assumed=dict(TINY["assumed"], damp=0.0))
    pair = weights.build(cfg, 9, torch.device("cpu"))
    seq = [torch.tensor([4, 9, 33, 70, 1, 88])]
    t = reference.logits(reference.head_weight(pair["target"]),
                         reference.final_hidden(pair["target"], 2, seq)[0])
    d = reference.logits(reference.head_weight(pair["draft"]),
                         reference.final_hidden(pair["draft"], 1, seq)[0])
    assert torch.allclose(t, d, atol=0.05 * float(d.abs().max()))
    assert torch.equal(t.argmax(-1), d.argmax(-1))


def test_control_rounds_to_float8():
    x = torch.tensor([[1.0, 0.3, -0.77, 448.0 / 3]])
    y = reference._fp8(x)
    assert not torch.equal(x, y)
    assert torch.allclose(x, y, rtol=0.07)
