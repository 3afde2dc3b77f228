"""The port's OPT family (``models/opt.py``, ``core/synthetic.py``'s OPT
pairs, OPT through the engines) against the JAX package on converted
weights, and against HF logits through the port's loader, on the CPU.
Tiny models: 3 layers, width 64, 4 heads, vocab 128.

Tolerances on logits, relative to the largest logit (as
tests/test_torch_llama.py states them):
* fp32 dense: 1e-4 (the same fp32 math summed in other orders);
* int8 weights: 5e-3 (a bf16 rounding of a W8A16 input can flip where the
  fp32 values upstream differ in the last bit, and carries through);
* bf16 dense: 3e-2 (bf16 activations rounded at the same places, but a
  flipped rounding propagates through the layers);
* paged, fp32 pools 2e-4; int8 pools 3e-2 (the JAX CPU forward reads the
  new block back through the int8 pool where the port attends to it
  unquantized, ROADMAP §C);
* against HF (fp32): 2e-4 absolute, as tests/test_opt_model.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.cache import paged as jpaged
from llmspeculativesampling_tpu.core.config import OPTConfig as JCfg
from llmspeculativesampling_tpu.core.loader import opt_params_from_state_dict as j_from_sd
from llmspeculativesampling_tpu.core.synthetic import synthetic_pair as j_synthetic_pair
from llmspeculativesampling_tpu.engine import beam_tree as jbt
from llmspeculativesampling_tpu.engine import speculative as jspec
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import opt as jo
from llmspeculativesampling_tpu.quant.core import quantize_params as jquant
from llmspeculativesampling_tpu.quant.core import quantized_bytes as jquant_bytes
from llmspeculativesampling_tpu_torch.cache import paged as tpaged
from llmspeculativesampling_tpu_torch.core.config import OPTConfig as TCfg
from llmspeculativesampling_tpu_torch.core.loader import opt_params_from_state_dict as t_from_sd
from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_opt_pair_int8_small_draft
from llmspeculativesampling_tpu_torch.engine import beam_tree as tbt
from llmspeculativesampling_tpu_torch.engine import speculative as tspec
from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate as t_ar
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import opt as to
from llmspeculativesampling_tpu_torch.quant.core import quantize_params as tquant
from llmspeculativesampling_tpu_torch.quant.core import quantized_bytes as tquant_bytes

from _torch_port import one_thread, patch_noise, rel_err, to_port  # noqa: F401 (fixture)
from test_torch_paged import _caches, _pools

VOCAB, S_MAX = 128, 64
PROMPT = [5, 17, 3, 22, 9, 41]
EOS = 127


def _kw(**over):
    kw = dict(vocab_size=VOCAB, hidden_size=64, ffn_dim=128, num_layers=3, num_heads=4,
              max_position=128, dtype="float32")
    return {**kw, **over}


def _models(kind="dense", seed=0, **over):
    """JAX and port bundles and params of one tiny OPT (random init, with
    random biases and LayerNorms so every parameter matters)."""
    kw = _kw(**over)
    if kind == "bf16":
        kw["dtype"] = "bfloat16"
    jcfg = JCfg(**kw)
    params = jo.init_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for name, x in params["layers"].items():
        if x.ndim == 2:  # biases and LayerNorms [L, N]
            base = 1.0 if name.endswith("_w") and name.startswith("ln") else 0.0
            params["layers"][name] = jnp.asarray(base + 0.1 * rng.standard_normal(x.shape), x.dtype)
    if kind == "int8":
        params = jquant(params, "opt")
    return (JBundle("opt", jcfg, jo.forward), params,
            TBundle("opt", TCfg(**kw), to.forward), to_port(params))


def _run_steps(jb, jp, tb, tp, tol):
    """Prefill (einsum path), decode and verify (the flash path on the
    port's side, its plain version on the CPU) and a tree block whose
    siblings share a position."""
    rng = np.random.default_rng(1)
    jc, tc = jb.make_cache(1, S_MAX), tb.make_cache(1, S_MAX, device="cpu")
    vis = np.tril(np.ones((4, 4), bool))
    vis[2, 1] = vis[3, 1] = vis[3, 2] = False  # two siblings under node 0
    steps = [(rng.integers(0, VOCAB, (1, 40)), None, None),
             (rng.integers(0, VOCAB, (1, 1)), None, None),
             (rng.integers(0, VOCAB, (1, 5)), None, None),
             (rng.integers(0, VOCAB, (1, 4)), vis[None], np.array([[46, 47, 47, 48]]))]
    for toks, tree, positions in steps:
        jkw, tkw = {}, {}
        if tree is not None:
            jkw = dict(tree_mask=jnp.asarray(tree), positions=jnp.asarray(positions, jnp.int32))
            tkw = dict(tree_mask=torch.from_numpy(tree), positions=torch.from_numpy(positions))
        jlog, jc = jb.forward(jp, jb.cfg, jnp.asarray(toks, jnp.int32), jc, **jkw)
        tlog, tc = tb.forward(tp, tb.cfg, torch.from_numpy(toks).long(), tc, **tkw)
        assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
        assert tc.length == int(jc.length)
        err = rel_err(tlog, jlog)
        assert err < tol, (toks.shape, err)


@pytest.mark.parametrize("kind,tol", [("dense", 1e-4), ("int8", 5e-3), ("bf16", 3e-2)])
def test_forward_matches_jax(kind, tol):
    _run_steps(*_models(kind), tol=tol)


@pytest.mark.parametrize("variant", ["project_in_out", "post_ln"])
def test_350m_projections_and_post_ln_match_jax(variant):
    """opt-350m's shape: word embeddings of 32 projected in and out of the
    64-wide stream; and the post-LayerNorm layers (do_layer_norm_before
    False, no final LayerNorm), as HF builds them."""
    over = ({"word_embed_proj_dim": 32} if variant == "project_in_out"
            else {"do_layer_norm_before": False})
    jb, jp, tb, tp = _models(seed=2, **over)
    if variant == "post_ln":
        jp = {k: v for k, v in jp.items() if not k.startswith("ln_final")}
        tp = {k: v for k, v in tp.items() if not k.startswith("ln_final")}
    else:
        assert "project_in" in tp and tp["embed"].shape == (VOCAB, 32)
    _run_steps(jb, jp, tb, tp, tol=1e-4)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(5)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 3, 16), (16,), (16,)))
    got = to.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jo.layer_norm(x, w, b, 1e-5)),
                               rtol=1e-6, atol=1e-6)


def test_positions_past_the_table_raise():
    """embed_pos has max_position + 2 rows: a position past it raises (on
    the host length of a contiguous cache before any work, else in the
    lookup), and never wraps, also below the table."""
    _, _, tb, tp = _models(max_position=16)
    cache = tb.make_cache(1, 32, device="cpu")
    _, cache = tb.forward(tp, tb.cfg, torch.zeros((1, 16), dtype=torch.long), cache)
    with pytest.raises(ValueError, match="exceed"):
        tb.forward(tp, tb.cfg, torch.zeros((1, 1), dtype=torch.long), cache)
    fresh = tb.make_cache(1, 32, device="cpu")
    for bad in (16, -3):  # explicit positions: one row past the table, one before it
        with pytest.raises(IndexError):
            tb.forward(tp, tb.cfg, torch.zeros((1, 1), dtype=torch.long), fresh,
                       positions=torch.tensor([[bad]]))


# ------------------------------------------------------------------ HF golden

def _hf_model(word_embed_proj_dim=None, do_layer_norm_before=True, seed=0):
    from transformers import OPTConfig as HFOPTConfig, OPTForCausalLM

    torch.manual_seed(seed)
    return OPTForCausalLM(HFOPTConfig(
        vocab_size=VOCAB, hidden_size=64, ffn_dim=128, num_hidden_layers=3, num_attention_heads=4,
        max_position_embeddings=128, do_layer_norm_before=do_layer_norm_before,
        word_embed_proj_dim=word_embed_proj_dim or 64, dropout=0.0,
        activation_function="relu")).eval()


def _hf_logits(hf, tokens):
    with torch.no_grad():
        return hf(torch.as_tensor(tokens)).logits.float().numpy()


@pytest.fixture(scope="module")
def hf_pair():
    hf = _hf_model()
    cfg = TCfg(**_kw())
    return hf, cfg, t_from_sd(hf.state_dict(), cfg, device="cpu")


@pytest.mark.parametrize("variant", ["pre_ln", "project_in_out", "post_ln"])
def test_loader_params_give_hf_logits(variant):
    """A locally built ``OPTForCausalLM`` through the port's loader: the
    full forward gives HF's logits, and the loaded tree equals JAX's
    loader's bit for bit."""
    over = {"project_in_out": {"word_embed_proj_dim": 32},
            "post_ln": {"do_layer_norm_before": False}}.get(variant, {})
    hf = _hf_model(seed=3, **over)
    cfg = TCfg(**_kw(**over))
    tp = t_from_sd(hf.state_dict(), cfg, device="cpu")
    jp = j_from_sd(hf.state_dict(), JCfg(**_kw(**over)), jnp.float32)
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), tp))
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tp)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tokens = np.random.default_rng(1).integers(0, VOCAB, (2, 11))
    logits, _ = to.forward(tp, cfg, torch.from_numpy(tokens), TBundle("opt", cfg, to.forward)
                           .make_cache(2, 32, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), _hf_logits(hf, tokens), atol=2e-4)


def test_incremental_decode_matches_hf(hf_pair):
    hf, cfg, tp = hf_pair
    tokens = np.random.default_rng(2).integers(0, VOCAB, (1, 10))
    full = _hf_logits(hf, tokens)
    cache = TBundle("opt", cfg, to.forward).make_cache(1, 32, device="cpu")
    logits, cache = to.forward(tp, cfg, torch.from_numpy(tokens[:, :5]), cache)
    np.testing.assert_allclose(logits.numpy(), full[:, :5], atol=2e-4)
    for t in range(5, 10):
        logits, cache = to.forward(tp, cfg, torch.from_numpy(tokens[:, t:t + 1]), cache)
        np.testing.assert_allclose(logits.numpy()[:, 0], full[:, t], atol=2e-4)


def test_tree_block_with_shared_positions_matches_hf(hf_pair):
    """Two siblings at one depth share a position id (the reason the
    reference patched OPT's positional embedding): each branch's logits
    equal HF's on that branch's sequence."""
    hf, cfg, tp = hf_pair
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, VOCAB, (1, 5))
    nodes = rng.integers(0, VOCAB, 3)
    tree = torch.tensor([[[1, 0, 0], [1, 1, 0], [1, 0, 1]]], dtype=torch.bool)
    cache = TBundle("opt", cfg, to.forward).make_cache(1, 32, device="cpu")
    _, cache = to.forward(tp, cfg, torch.from_numpy(prefix), cache)
    logits, _ = to.forward(tp, cfg, torch.from_numpy(nodes[None]), cache,
                           positions=torch.tensor([[5, 6, 6]]), tree_mask=tree)
    for col in (1, 2):
        ref = _hf_logits(hf, np.concatenate([prefix, [[nodes[0], nodes[col]]]], axis=1))
        np.testing.assert_allclose(logits.numpy()[:, 0], ref[:, 5], atol=2e-4)
        np.testing.assert_allclose(logits.numpy()[:, col], ref[:, 6], atol=2e-4)


# ------------------------------------------------------------------ paged

@pytest.mark.parametrize("quant", [False, True])
def test_paged_forward_matches_jax(quant):
    """OPT through the port's paged cache against JAX's paged forward:
    the admission prefill (``paged_prefill``), decode and verify blocks
    (the paged kernel's plain version), a per-row rollback and a 36-token
    block (the gather path) over three rows with interleaved tables; row 2
    holds the sentinel table and writes only the trash block."""
    jb, jp, tb, tp = _models(seed=4)
    jfwd = jax.jit(lambda p, t, c, pre: jb.forward(p, jb.cfg, t, c, paged_prefill=pre),
                   static_argnums=3)
    tables = [[3, 0, 7, 12], [1, 9, 4, 15], []]
    jc, tc = _caches(jb.cfg, quant, tables, batch=3)
    tol = 3e-2 if quant else 2e-4
    rng = np.random.default_rng(0)
    steps = [("prefill", rng.integers(1, VOCAB, (3, 8))), ("decode", rng.integers(1, VOCAB, (3, 1))),
             ("verify", rng.integers(1, VOCAB, (3, 5))), ("rollback", None),
             ("re-feed", rng.integers(1, VOCAB, (3, 2))), ("long", rng.integers(1, VOCAB, (3, 36)))]
    for name, toks in steps:
        if toks is None:
            new = np.asarray([11, 9, 0], np.int32)
            jc = jpaged.rollback_rows(jc, jnp.asarray(new))
            tc = tpaged.rollback_rows(tc, torch.from_numpy(new))
            continue
        pre = name == "prefill"
        jl_, jc = jfwd(jp, jnp.asarray(toks, jnp.int32), jc, pre)
        tl_, tc = tb.forward(tp, tb.cfg, torch.from_numpy(toks).long(), tc, paged_prefill=pre)
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        err = rel_err(tl_[:2], np.asarray(jl_)[:2])
        assert err < tol, (name, err)
    owned = sorted(b for row in tables for b in row)
    untouched = [blk for blk in range(16) if blk not in owned]
    for tpool, jpool in zip(_pools(tc), _pools(jc)):
        assert not tpool[:, untouched].any(), "a sentinel row wrote outside the trash block"
        if tpool.dtype != np.int8:
            np.testing.assert_allclose(tpool[:, owned], jpool[:, owned], rtol=1e-5,
                                       atol=2e-3 if quant else 1e-5)


def test_paged_forward_matches_contiguous_forward():
    """Per row, a batched paged forward (admission prefill, then a block
    through the paged kernel's plain version) gives what a contiguous
    forward of that row alone gives: positions come from each row's device
    length."""
    _, _, tb, tp = _models(seed=6)
    _, tc = _caches(tb.cfg, False, [[4, 1, 8], [0, 14, 3]], batch=2)
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(1, VOCAB, (2, 8))).long()
    step = torch.from_numpy(rng.integers(1, VOCAB, (2, 4))).long()
    _, tc = tb.forward(tp, tb.cfg, prompts, tc, paged_prefill=True)
    tc = dataclasses.replace(tc, lengths=torch.tensor([8, 6], dtype=torch.int32))
    got, _ = tb.forward(tp, tb.cfg, step, tc)
    for r, n in ((0, 8), (1, 6)):
        cache = tb.make_cache(1, 32, device="cpu")
        _, cache = tb.forward(tp, tb.cfg, prompts[r:r + 1, :n], cache)
        ref, _ = tb.forward(tp, tb.cfg, step[r:r + 1], cache)
        assert rel_err(got[r:r + 1], ref) < 2e-4


# ------------------------------------------------------------------ synthetic

def test_small_draft_pair_replicates_its_draft():
    """``synthetic_opt_pair_int8_small_draft`` at tests/test_quant.py's
    sizes (r = 4). With LayerNorm's eps at 0 the replication is exact, so
    the target's probabilities equal the draft's to fp32 rounding (1e-6);
    at OPT's eps 1e-5 the target's normalisation differs by ~eps(r^2-1)/var
    relative and flips a few bf16 roundings, which the JAX construction
    shows too (its own pair reaches 6.6e-3 at seed 4): 1e-2. Damping the
    deeper layers must move the target."""
    kw = dict(hidden_size=64, ffn_dim=128, num_layers=4, num_heads=8, vocab_size=97,
              draft_hidden=16, draft_ffn=32, draft_layers=2, max_position=128, device="cpu")
    bd, pd, bt, pt = synthetic_opt_pair_int8_small_draft(damp=0.0, **kw)
    assert bd.cfg.hidden_size == 16 and bt.cfg.hidden_size == 64
    assert bd.cfg.head_dim == bt.cfg.head_dim
    toks = torch.arange(3, 13)[None]

    def probs(b, p, **cfg_over):
        cfg = dataclasses.replace(b.cfg, **cfg_over)
        logits, _ = b.forward(p, cfg, toks, b.make_cache(1, 64, device="cpu"))
        return logits.softmax(-1)

    assert float((probs(bd, pd, layer_norm_eps=0.0) - probs(bt, pt, layer_norm_eps=0.0))
                 .abs().max()) < 1e-6
    p_t = probs(bt, pt)
    assert float((probs(bd, pd) - p_t).abs().max()) < 1e-2
    _, _, bt2, pt2 = synthetic_opt_pair_int8_small_draft(damp=0.05, **kw)
    assert float((probs(bt2, pt2) - p_t).abs().max()) > 1e-3


def test_quantize_params_opt_keys():
    """The OPT family quantizes its six projections (and ``extra_keys``),
    not its biases, LayerNorms or tied embedding, as JAX's; the tree's
    bytes are JAX's."""
    jb, jp, tb, tp = _models(seed=8)
    jq = jax.tree.map(np.asarray, jquant(jp, "opt", extra_keys=("bq",)))
    tq = tquant(tp, "opt", extra_keys=("bq",))
    assert sorted(k for k, v in tq["layers"].items() if isinstance(v, dict)) == [
        "bq", "fc1_w", "fc2_w", "wk", "wo", "wq", "wv"]
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tq)), jax.tree.leaves(jq)):
        np.testing.assert_array_equal(a, b)
    assert tquant_bytes(tq) == jquant_bytes(jquant(jp, "opt", extra_keys=("bq",)))


# ------------------------------------------------------------------ engines

@pytest.fixture(scope="module")
def opt_pair():
    """A JAX OPT pair (``synthetic_pair(family="opt")``: the draft is the
    target's first layer, the deeper two damped) and the port's copies."""
    jbd, jpd, jbt_, jpt = j_synthetic_pair("opt", hidden_size=64, num_layers=3, draft_layers=1,
                                           num_heads=4, vocab_size=VOCAB, max_position=128,
                                           dtype="float32", damp=0.5, seed=3)

    def port(jb, jp):
        cfg = TCfg(**{f: getattr(jb.cfg, f) for f in TCfg.__dataclass_fields__})
        return TBundle("opt", cfg, to.forward), to_port(jp)

    return (jbd, jpd, jbt_, jpt), (*port(jbd, jpd), *port(jbt_, jpt))


def test_speculative_greedy_ids_equal_jax(opt_pair, monkeypatch):
    """OPT as draft and target: identical models accept every draft; the
    greedy ids equal JAX's (under the same fixed noise in both packages)
    and the port's autoregressive ids."""
    patch_noise(monkeypatch)
    (jbd, jpd, jbt_, jpt), (tbd, tpd, tbt_, tpt) = opt_pair
    kw = dict(gamma=3, eos_token_id=EOS, top_k=1)
    out, d = tspec.speculative_generate(tbt_, tpt, tbt_, tpt, PROMPT, 10, details=True,
                                        device="cpu", **kw)
    assert d["resample_count"] == 0 and len(out) >= len(PROMPT) + 10
    jout = jspec.speculative_generate(jbd, jpd, jbt_, jpt, PROMPT, 12, key=jax.random.key(0), **kw)
    tout = tspec.speculative_generate(tbd, tpd, tbt_, tpt, PROMPT, 12, device="cpu", **kw)
    ar = t_ar(tbt_, tpt, PROMPT, 12, eos_token_id=EOS, top_k=1, device="cpu")
    np.testing.assert_array_equal(tout, np.asarray(jout))
    np.testing.assert_array_equal(tout[:len(ar)], ar)


def test_beam_v2_greedy_ids_equal_jax(opt_pair):
    (jbd, jpd, jbt_, jpt), (tbd, tpd, tbt_, tpt) = opt_pair
    kw = dict(gamma=3, num_beams=4, extra_sample_cnt=1, expect_thres=0.7, min_num_beams=1,
              eos_token_id=EOS, top_k=1, details=True)
    jout, jd = jbt.beam_speculative_v2_generate(jbd, jpd, jbt_, jpt, PROMPT, 12,
                                                key=jax.random.key(1), **kw)
    tout, td = tbt.beam_speculative_v2_generate(tbd, tpd, tbt_, tpt, PROMPT, 12, device="cpu",
                                                **kw)
    np.testing.assert_array_equal(tout, np.asarray(jout))
    for k in ("acc_len", "accepted_count"):
        assert td[k] == jd[k], k
