"""The port's Llama forward (``models/llama.py``) against the JAX forward on
converted weights: prefill (einsum path), 1-token decode, the gamma+1
verify block and a tree-masked block (flash path on the port side), for a
dense fp32 model, an int8-weight model and the int8 KV cache; plus the
building blocks (RMSNorm, RoPE with its scalings, masks).

Tolerances on logits, relative to the largest logit:
* fp32 dense: 1e-4 (the same fp32 math summed in other orders);
* int8 weights: 5e-3. The W8A16 product rounds its input to bf16 on both
  sides; where the fp32 values upstream differ in the last bit (sums in
  other orders) a rounding can flip, moving that activation by 2**-8
  relative, and the flips that do occur carry through the later layers;
* int8 KV cache: 2e-2, because JAX's flash path is forced there
  (LLMSS_FLASH=1, interpret mode) and its int8 branch runs bf16 MXU math;
* bf16 dense: 3e-2 (bf16 activations rounded at the same places, but a
  flipped rounding propagates through the layers)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.quant.core import quantize_params as jquant
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import llama as tl

from _torch_port import rel_err, to_np, to_port

S_MAX = 128


def _cfgs(dtype="float32", **kw):
    base = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=2, num_kv_heads=1, max_position=512, dtype=dtype, **kw)
    return JCfg(**base), TCfg(**base)


def _models(kind, dtype="float32", **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    params = jl.init_params(jcfg, jax.random.key(0))
    if kind == "int8":
        params = jquant(params, "llama", quantize_lm_head=True)
    kvq = kind == "int8kv"
    return (JBundle("llama", jcfg, jl.forward, kv_quant=kvq), params,
            TBundle("llama", tcfg, tl.forward, kv_quant=kvq), to_port(params))


def _run_steps(jb, jp, tb, tp, tol):
    rng = np.random.default_rng(1)
    jc, tc = jb.make_cache(1, S_MAX), tb.make_cache(1, S_MAX, device="cpu")
    steps = [("prefill", rng.integers(0, 256, (1, 40)), None, None),
             ("decode", rng.integers(0, 256, (1, 1)), None, None),
             ("verify", rng.integers(0, 256, (1, 5)), None, None)]
    vis = np.tril(np.ones((4, 4), bool))
    vis[2, 1] = vis[3, 1] = vis[3, 2] = False  # two siblings under node 0
    pos = np.array([[46, 47, 47, 48]])
    steps.append(("tree", rng.integers(0, 256, (1, 4)), vis[None], pos))
    for name, toks, tree, positions in steps:
        jkw, tkw = {}, {}
        if tree is not None:
            jkw = dict(tree_mask=jnp.asarray(tree), positions=jnp.asarray(positions, jnp.int32))
            tkw = dict(tree_mask=torch.from_numpy(tree), positions=torch.from_numpy(positions))
        jlog, jc = jb.forward(jp, jb.cfg, jnp.asarray(toks, jnp.int32), jc, **jkw)
        tlog, tc = tb.forward(tp, tb.cfg, torch.from_numpy(toks).long(), tc, **tkw)
        assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
        assert tc.length == int(jc.length)
        err = rel_err(tlog, jlog)
        assert err < tol, (name, err)


@pytest.mark.parametrize("kind,tol", [("dense", 1e-4), ("int8", 5e-3)])
def test_forward_matches_jax(kind, tol):
    _run_steps(*_models(kind), tol=tol)


def test_forward_int8_kv_matches_jax_flash_path(monkeypatch):
    monkeypatch.setenv("LLMSS_FLASH", "1")
    monkeypatch.setenv("LLMSS_FLASH_INTERPRET", "1")
    _run_steps(*_models("int8kv"), tol=2e-2)


def test_forward_bf16_matches_jax():
    _run_steps(*_models("dense", dtype="bfloat16"), tol=3e-2)


def test_qkv_bias_and_mha_match_jax():
    jcfg, tcfg = _cfgs(qkv_bias=True)
    jcfg = JCfg(**{**jcfg.__dict__, "num_kv_heads": 2})
    tcfg = TCfg(**{**tcfg.__dict__, "num_kv_heads": 2})
    params = jl.init_params(jcfg, jax.random.key(3))
    rng = np.random.default_rng(4)
    for k in ("bq", "bk", "bv"):
        params["layers"][k] = jnp.asarray(rng.standard_normal(params["layers"][k].shape) * 0.1,
                                          jnp.float32)
    _run_steps(JBundle("llama", jcfg, jl.forward), params,
               TBundle("llama", tcfg, tl.forward), to_port(params), tol=1e-4)


@pytest.mark.parametrize("scaling", [None, ("linear", 2.0), ("dynamic", 4.0)])
def test_rope_tables_match_jax(scaling):
    pos = np.array([[0, 5, 300, 1023]], np.int32)
    jc, js = jl.rope_tables(jnp.asarray(pos), 64, 10000.0, scaling, 512)
    tc, ts = tl.rope_tables(torch.from_numpy(pos).long(), 64, 10000.0, scaling, 512)
    # angles reach ~1e3 rad, where one float32 ulp of the angle is ~6e-5
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), atol=2e-4)
    np.testing.assert_allclose(to_np(ts), np.asarray(js), atol=2e-4)


def test_rms_norm_and_rope_apply_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(to_np(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)),
                               np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
                               rtol=1e-6, atol=1e-6)
    pos = np.arange(6, dtype=np.int32).reshape(2, 3)
    jc, js = jl.rope_tables(jnp.asarray(pos), 16, 10000.0)
    tc, ts = tl.rope_tables(torch.from_numpy(pos).long(), 16, 10000.0)
    np.testing.assert_allclose(to_np(tl.apply_rope(torch.from_numpy(x), tc, ts)),
                               np.asarray(jl.apply_rope(jnp.asarray(x), jc, js)), atol=1e-5)


@pytest.mark.parametrize("tree", [False, True])
def test_masks_match_jax(tree):
    s_new, s_max, b = 4, 16, 2
    tm = None
    if tree:
        tm = np.random.default_rng(6).random((b, s_new, s_new)) > 0.4
        tm |= np.eye(s_new, dtype=bool)[None]
    jm = jl.attention_mask(jnp.asarray(5), s_new, s_max, None if tm is None else jnp.asarray(tm), b)
    tmk = tl.attention_mask(5, s_new, s_max, None if tm is None else torch.from_numpy(tm), b, "cpu")
    np.testing.assert_array_equal(tmk.numpy(), np.asarray(jm))
    jb = jl.block_bias(s_new, None if tm is None else jnp.asarray(tm), b)
    tb = tl.block_bias(s_new, None if tm is None else torch.from_numpy(tm), b, "cpu")
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_unstacked_params_give_the_same_forward():
    jb, jp, tb, tp = _models("int8")
    toks = torch.arange(7).reshape(1, 7)
    a, _ = tb.forward(tp, tb.cfg, toks, tb.make_cache(1, S_MAX, device="cpu"))
    b, _ = tb.forward(tl.unstack_layers(tp), tb.cfg, toks, tb.make_cache(1, S_MAX, device="cpu"))
    assert torch.equal(a, b)
