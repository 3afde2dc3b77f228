"""The Mellum 2 decoder of the port (``models/mellum.py``, ``models/moe.py``,
B4's plain version, the window in B2/B3's plain versions, YaRN) against the
plain float32 reference ``benchmarks/reference/mellum.py``, on a tiny pair
of the benchmark's construction (``benchmarks/families/mellum.py``): 4
layers (3 window + 1 full), hidden 64, 4 query heads and 2 kv heads of 32
(a query width of 128, apart from the hidden size), 8 experts of 32, top
2, window 16, prompts of 40 tokens, so every window layer drops positions.

Logits are compared, never sampled tokens. Tolerances: the program holds
activations in bf16 (2**-8 relative a rounding) where the reference holds
float32, through 4 layers and a head whose logits have a std near 0.4;
``TOL`` = 0.05 is about 13 % of that std, above the bf16 program (under
0.03 on these draws) and below the reference computed in float8
activations, which each comparison also checks it misses; ``TOL_INT8`` =
0.1 where the KV cache is int8 (each position's K and V rounded to 1/127
of its largest magnitude, about 2**-8 relative again, on values the
attention weighs at full strength in the layers that hold the draft),
below the float8 control too. The router's
weights are drawn at 8 / sqrt(hidden), so the program's bf16 rounding
sends a token to another expert than the reference's only at near-ties,
rarely (``test_routing_flips_are_ties``), and the comparisons hold with
those flips in them. The expert layer's top-k combine, with
weights of one order, is held against transformers' block on its own.
"""

import copy
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmarks.check import least_raise
from benchmarks.families import mellum as family
from benchmarks.reference import mellum as reference
from llmspeculativesampling_tpu_torch import LlamaConfig, ModelBundle, speculative_generate
from llmspeculativesampling_tpu_torch.cache.paged import init_paged_cache
from llmspeculativesampling_tpu_torch.kernels import moe_matmul
from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul_ref
from llmspeculativesampling_tpu_torch.models import llama, moe
from llmspeculativesampling_tpu_torch.parallel.sharding import param_specs
from llmspeculativesampling_tpu_torch.quant.core import quantize_params
from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

CPU = torch.device("cpu")
TOL = 0.05
TOL_INT8 = 0.1
LAYER_TYPES = ["sliding_attention"] * 3 + ["full_attention"]
CFG = {
    "name": "tiny_mellum", "model_type": "mellum", "hidden_size": 64, "intermediate_size": 128,
    "moe_intermediate_size": 32, "num_hidden_layers": 4, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 32, "num_experts": 8, "num_experts_per_tok": 2,
    "norm_topk_prob": True, "sliding_window": 16, "vocab_size": 512, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 4096, "layer_types": LAYER_TYPES,
    "rope_parameters": {
        "full_attention": {"rope_type": "yarn", "rope_theta": 10000, "factor": 4,
                           "original_max_position_embeddings": 32, "beta_fast": 32,
                           "beta_slow": 1, "attention_factor": 1.2},
        "sliding_attention": {"rope_type": "default", "rope_theta": 10000}},
    "assumed": {"draft": {"layer_types": ["sliding_attention", "full_attention"],
                          "intermediate_size": 64},
                "damp": 0.3, "qk_gain": 2.0, "router_std": 8.0, "moe_gain": 1.0, "embed_std": 1.0,
                "embed_const": 8.0, "router_gap": 4.0, "head_std": 0.05},
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    p = family.build(CFG, 5, CPU)
    return p, family.bundles(p, kv_quant=False), family.bundles(p, kv_quant=True)


def _prompts(n=2, length=40, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(3, 500, (n, length)))


def _reference_logits(params, w, seqs, act_quant=None):
    hidden = reference.final_hidden(params, w, list(seqs), act_quant=act_quant)
    head = reference.head_weight(params)
    return torch.stack([reference.logits(head, h, act_quant) for h in hidden])


def _check(got, params, w, seqs, tol=TOL):
    """``got`` within ``tol`` of the reference, which the float8 control
    misses."""
    want = _reference_logits(params, w, seqs)
    err = (got - want).abs().max().item()
    low = (_reference_logits(params, w, seqs, "fp8") - want).abs().max().item()
    assert err <= tol < low, (err, low)


def _steps(bundle, params, toks, cache, **kw):
    """Prefill 30 tokens, verify 5, decode 1 and 4 more through ``cache``."""
    out = []
    for a, b in ((0, 30), (30, 35), (35, 36), (36, 40)):
        lg, cache = bundle.forward(params, bundle.cfg, toks[:, a:b], cache, **kw)
        kw.pop("paged_prefill", None)
        out.append(lg)
    return torch.cat(out, 1)


@pytest.mark.parametrize("role", ["target", "draft"])
@pytest.mark.parametrize("quant", [False, True])
def test_contiguous_cache_against_reference(pair, role, quant):
    p, b16, b8 = pair
    b = (b8 if quant else b16)[role]
    toks = _prompts()
    got = _steps(b, p[role], toks, b.make_cache(2, 64, device=CPU))
    _check(got, p[role], p["widths"][role], toks, TOL_INT8 if quant else TOL)


def test_routed_rows_take_every_pair(pair):
    """A forward adds each layer's (token, expert) pairs to the params'
    ``routed_rows``, k a token, to the experts its router chose; params
    without the buffer route the same and count nothing."""
    p, b16, _ = pair
    b = b16["target"]
    toks = _prompts()
    routed = p["target"]["routed_rows"]
    before = routed.clone()
    lg, _ = b.forward(p["target"], b.cfg, toks, b.make_cache(2, 64, device=CPU))
    grown = routed - before
    assert grown.shape == (b.cfg.num_layers, b.cfg.num_experts)
    assert torch.equal(grown.sum(dim=1), torch.full((b.cfg.num_layers,),
                                                    toks.numel() * b.cfg.num_experts_per_tok))
    bare = {k: v for k, v in p["target"].items() if k != "routed_rows"}
    lg_bare, _ = b.forward(bare, b.cfg, toks, b.make_cache(2, 64, device=CPU))
    assert torch.equal(lg, lg_bare) and torch.equal(routed - before, grown)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_pool_against_reference(pair, quant):
    """The admission's block-only prefill, then verify and decode through
    B3's plain version over shuffled pages of 8 positions."""
    p, b16, b8 = pair
    b = (b8 if quant else b16)["target"]
    cfg = b.cfg
    cache = init_paged_cache(cfg.num_layers, 16, cfg.num_kv_heads, 8, cfg.head_dim, 2, 6,
                             quant=quant, device=CPU)
    cache.block_tables[:] = torch.tensor([[9, 3, 14, 0, 7, 11], [2, 12, 5, 15, 1, 8]])
    toks = _prompts(seed=1)
    got = _steps(b, p["target"], toks, cache, paged_prefill=True)
    _check(got, p["target"], p["widths"]["target"], toks, TOL_INT8 if quant else TOL)


def test_window_layers_drop_what_full_layers_keep(pair):
    """The window is live in the test: the same logits with every layer
    full differ from the reference beyond TOL."""
    p, b16, _ = pair
    b = b16["target"]
    full = ModelBundle("mellum", __import__("dataclasses").replace(
        b.cfg, layer_types=("full_attention",) * 4), b.forward)
    toks = _prompts()
    got = _steps(full, p["target"], toks, full.make_cache(2, 64, device=CPU))
    want = _reference_logits(p["target"], p["widths"]["target"], toks)
    assert (got - want).abs().max() > TOL


def _gaps(params, w, prompt, served):
    """The least raise of each served token into the reference's greedy
    support (its gap below the reference's best)."""
    seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
    lg = _reference_logits(params, w, [seq])[0][len(prompt) - 1:]
    return least_raise(lg, torch.as_tensor(served), None)


def test_paged_engine_greedy_serving(pair):
    p, _, b8 = pair
    eng = PagedEngine(b8["draft"], p["draft"], b8["target"], p["target"], device="cpu",
                      batch_rows=3, num_blocks=40, page=8, max_pages_per_req=10, gamma=4,
                      steps_per_sync=2, eos_token_id=2, top_k=1, max_new_cap=24)
    prompts = [np.asarray(t) for t in _prompts(n=5, length=40, seed=2)]
    prompts[1] = prompts[1][:21]
    rids = [eng.submit(pr, 24) for pr in prompts]
    eng.run_until_idle()
    for rid, pr in zip(rids, prompts):
        c = eng.result(rid)
        served = np.asarray(c.output_ids[c.prompt_len:])
        assert c.prompt_len == len(pr) and len(served) >= 24, (c.prompt_len, len(served))
        gaps = _gaps(p["target"], p["widths"]["target"], pr, served)
        assert float(gaps.max()) <= TOL_INT8, gaps.max()


def test_speculative_generate(pair):
    p, b16, _ = pair
    prompt = np.asarray(_prompts(n=1, seed=3)[0])
    out = speculative_generate(b16["draft"], p["draft"], b16["target"], p["target"], prompt, 30,
                               gamma=4, eos_token_id=2, top_k=1, device="cpu")
    served = np.asarray(out[len(prompt):])
    assert len(served) >= 30
    gaps = _gaps(p["target"], p["widths"]["target"], prompt, served)
    assert float(gaps.max()) <= TOL, gaps.max()


@pytest.mark.parametrize("tokens,mt", [(7, 64), (40, 64), (300, 128)])
def test_b4_plain_against_a_per_expert_loop(tokens, mt):
    gen = torch.Generator().manual_seed(tokens)
    e, k, n, top = 8, 64, 48, 3
    ids = torch.argsort(torch.rand((tokens, e), generator=gen), dim=-1)[:, :top]
    x = torch.randn((tokens, k), generator=gen).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (e, k, n), generator=gen, dtype=torch.int8)
    s = torch.rand((e, n), generator=gen) / 50
    totals = torch.zeros(e, dtype=torch.int64)
    r = moe_matmul.expert_align(ids, e, mt, totals)
    assert r.rows.numel() == moe_matmul.slot_count(tokens * top, e, mt)
    assert torch.equal(totals, torch.bincount(ids.reshape(-1), minlength=e))
    out = moe_matmul.grouped_int8_matmul(x.index_select(0, r.rows), wq, s, r)
    got = out[r.inv.long()].view(tokens, top, n)
    for t in range(tokens):
        for j in range(top):
            want = int8_matmul_ref(x[t:t + 1], wq[ids[t, j]], s[ids[t, j]])[0]
            assert torch.equal(got[t, j], want)
    live = int(r.live[0])
    assert live == int(((torch.bincount(ids.reshape(-1), minlength=e) + mt - 1) // mt).sum())
    assert set(r.tile_expert[:live].tolist()) == set(ids.reshape(-1).tolist())


def test_yarn_tables_against_transformers():
    from transformers.modeling_rope_utils import _compute_yarn_parameters

    y = CFG["rope_parameters"]["full_attention"]
    for d, theta, yarn in ((32, 10000.0, y),
                           (128, 500000.0, {"factor": 16, "original_max_position_embeddings": 8192,
                                            "beta_fast": 32, "beta_slow": 1,
                                            "attention_factor": 1.2772588722239782})):
        hf = SimpleNamespace(rope_theta=theta, head_dim=d, hidden_size=d, num_attention_heads=1,
                             max_position_embeddings=131072, rope_scaling=dict(yarn, rope_type="yarn"))
        inv_freq, factor = _compute_yarn_parameters(hf, "cpu")
        pos = torch.tensor([[0, 1, 17, 1023, 9000, 131071]])
        cos, sin = llama.rope_tables(pos, d, theta, (
            "yarn", float(yarn["factor"]), yarn["original_max_position_embeddings"],
            float(yarn["beta_fast"]), float(yarn["beta_slow"]), float(yarn["attention_factor"])))
        # float32 angles, as transformers' rotary embedding takes them
        ang = pos[0].float()[:, None] * inv_freq.float()[None]
        ang = torch.cat([ang, ang], -1)
        assert factor == yarn["attention_factor"]
        assert torch.allclose(cos[0], ang.cos() * factor, atol=1e-5)
        assert torch.allclose(sin[0], ang.sin() * factor, atol=1e-5)
        assert torch.allclose(llama.yarn_inv_freq(d, theta, yarn["factor"],
                                                  yarn["original_max_position_embeddings"],
                                                  yarn["beta_fast"], yarn["beta_slow"]),
                              inv_freq.float(), rtol=1e-6)


def test_routing_and_expert_layer_against_qwen3_moe_block(pair):
    """``models/moe.py`` against transformers' ``Qwen3MoeSparseMoeBlock``
    (the same config keys: num_experts, num_experts_per_tok, norm_topk_prob,
    moe_intermediate_size), given the layer's dequantized weights: the same
    experts, and outputs within bf16 rounding (the block in float32, the
    program's activations in bf16)."""
    from transformers.models.qwen3_moe.configuration_qwen3_moe import Qwen3MoeConfig
    from transformers.models.qwen3_moe.modeling_qwen3_moe import Qwen3MoeSparseMoeBlock

    p, b16, _ = pair
    cfg = b16["target"].cfg
    lp = llama.unstack_layers(p["target"])["layers"][1]
    f = cfg.moe_intermediate_size
    hf = Qwen3MoeConfig(hidden_size=cfg.hidden_size, num_experts=cfg.num_experts,
                        num_experts_per_tok=cfg.num_experts_per_tok, norm_topk_prob=True,
                        moe_intermediate_size=f, hidden_act="silu")
    block = Qwen3MoeSparseMoeBlock(hf).float()
    with torch.no_grad():
        router = (lp["router"].float() / 4).to(torch.bfloat16)  # top-2 weights of one order
        lp = dict(lp, router=router)
        block.gate.weight.copy_(router.float().t())
        for e, mlp in enumerate(block.experts):
            gu = lp["w_gate_up"]["q"][e].float() * lp["w_gate_up"]["s"][e][None]
            dn = lp["w_experts_down"]["q"][e].float() * lp["w_experts_down"]["s"][e][None]
            mlp.gate_proj.weight.copy_(gu[:, :f].t())
            mlp.up_proj.weight.copy_(gu[:, f:].t())
            mlp.down_proj.weight.copy_(dn.t())
        x = torch.randn((1, 50, cfg.hidden_size), generator=torch.Generator().manual_seed(4))
        x = x.to(torch.bfloat16)
        want, logits = block(x.float())
        w, ids = moe.route(moe.router_logits(x[0], lp["router"], False), 2, True)
        p_hf = torch.softmax(logits, -1)
        w_hf, ids_hf = torch.topk(p_hf, 2, -1)
        assert torch.equal(ids, ids_hf)
        assert torch.allclose(w, w_hf / w_hf.sum(-1, keepdim=True), atol=1e-5)
        assert w[:, 1].mean() > 0.1  # the second expert matters
        got = moe.expert_mlp(x, lp, cfg)
    err = (got.float() - want).abs().max()
    assert err <= 2 ** -6 * want.abs().max(), err


def test_routing_flips_are_ties(pair, monkeypatch):
    """On the prompts of the comparisons above, the program (bf16
    activations) sends each token of each layer to the experts the
    reference's float32 forward picks, but at near-ties: over 98 % of the
    token-layers agree, and at a sequence's first flip the reference's
    logits of the experts left out and of those taken instead lie within
    2 % of the logits' spread (later flips in the sequence may follow from
    it, through the residual or the attention). Those flips are rounding,
    and the comparisons above hold with them."""
    p, b16, _ = pair
    w = p["widths"]["target"]
    lay = p["target"]["layers"]
    picked = []
    route = moe.route
    monkeypatch.setattr(moe, "route", lambda *a: (picked.append(route(*a)[1]), route(*a))[1])
    rnd = reference._Precision(None)
    flips = total = 0
    for seed, n in ((0, 2), (1, 2), (2, 5), (3, 2)):
        toks = _prompts(n=n, seed=seed)
        picked.clear()
        flipped = set()
        b16["target"].forward(p["target"], b16["target"].cfg, toks,
                              b16["target"].make_cache(n, 64, device=CPU))
        assert len(picked) == w["layers"]
        hs = [p["target"]["embed"][t].float() for t in toks]
        for i, kind in enumerate(LAYER_TYPES):
            full = kind == "full_attention"
            hs = [reference._attention(h, lay, i, w, None if full else w["window"], rnd,
                                       reference._inv_freq(w, full, "cpu"),
                                       w["yarn"]["attention_factor"] if full else 1.0)
                  for h in hs]
            x = torch.cat([reference._rms_norm(h, lay["ln_mlp"][i], w["eps"]) for h in hs])
            logits = x @ lay["router"][i].float()
            want = torch.topk(logits, w["top_k"], dim=-1).indices.sort(-1).values
            got = picked[i].sort(-1).values
            for t in (want != got).any(-1).nonzero().flatten().tolist():
                gap = logits[t, want[t]].sum() - logits[t, got[t]].sum()
                if t // 40 not in flipped:  # a sequence's first flip: a tie
                    assert 0 <= gap <= 0.02 * logits.std(), (seed, i, t, float(gap))
                    flipped.add(t // 40)
                flips += 1
            total += want.shape[0]
            hs = reference._experts(hs, lay, i, w, rnd)
    assert flips <= 0.02 * total, (flips, total)


def test_make_cache_refuses_only_decoders_that_ignore_their_window(pair):
    _, b16, _ = pair
    assert b16["target"].make_cache(1, 64, device=CPU) is not None  # 64 > window 16
    llama_cfg = LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32, num_layers=1,
                            num_heads=2, num_kv_heads=2, sliding_window=16, dtype="float32")
    with pytest.raises(ValueError, match="sliding window"):
        ModelBundle("llama", llama_cfg, llama.forward).make_cache(1, 64, device=CPU)


def test_family_dispatch_raises_on_an_unknown_family(pair):
    _, b16, _ = pair
    with pytest.raises(ValueError, match="mellum"):
        param_specs("mellum", b16["target"].cfg)
    with pytest.raises(ValueError, match="mellum"):
        quantize_params({"layers": {}}, "mellum")
    assert quantize_params({"layers": {"fc1_w": torch.ones((1, 8, 4))}}, "opt")["layers"][
        "fc1_w"]["s"].shape == (1, 4)
