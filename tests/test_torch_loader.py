"""The port's checkpoint loading (``core/loader.py``) against the JAX
package's loader and HF, and the fp8 e4m3 weight route of
``models/linear.py``, on the CPU.

* ``parse_rope_scaling`` and ``*_config_from_hf`` give JAX's results.
* Llama, Qwen2, Mistral and OPT state dicts of locally built tiny HF models
  map, through the port's loader and through JAX's, to bit-equal trees
  (fp32 and bf16), and the port's Llama forward gives HF's logits (2e-4).
* ``load_pretrained`` reads directories written by ``save_pretrained``
  (nothing is downloaded); the port's own safetensors reader gives the
  tensors the ``safetensors`` package gives. Qwen2/Mistral windows clamp
  ``max_position`` and ``make_cache`` rejects a cache past the window.
* ``save_params``/``load_params`` round-trip int8 and fp8 leaves; a
  ``cache_dir`` converts once and restores after.
* fp8 weights: the forward against JAX's (both compute bf16 x bf16 with
  fp32 sums: 5e-3, the int8 tolerance of tests/test_torch_llama.py), and
  the speculative engine's greedy ids equal JAX's.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.core import loader as jload
from llmspeculativesampling_tpu.core.config import LlamaConfig as JLCfg
from llmspeculativesampling_tpu.engine import speculative as jspec
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.quant.core import quantize_params as jquant
from llmspeculativesampling_tpu_torch.core import loader as tload
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TLCfg
from llmspeculativesampling_tpu_torch.engine import speculative as tspec
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import linear as tlin
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.quant.core import quantize_params as tquant

from _torch_port import one_thread, rel_err, to_port  # noqa: F401 (fixture)

VOCAB = 128


@pytest.mark.parametrize("rs", [None, {"type": "default"}, {"type": "linear", "factor": 2.0},
                                {"rope_type": "dynamic", "factor": 4}])
def test_parse_rope_scaling_matches_jax(rs):
    assert tload.parse_rope_scaling(rs) == jload.parse_rope_scaling(rs)


def test_parse_rope_scaling_rejects_other_types():
    for rs in ({"type": "yarn", "factor": 4.0}, {"rope_type": "llama3", "factor": 8.0}):
        with pytest.raises(ValueError, match="unsupported rope_scaling"):
            tload.parse_rope_scaling(rs)


def test_configs_from_hf_match_jax():
    llama_hf = {"vocab_size": 64, "hidden_size": 64, "intermediate_size": 128,
                "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                "max_position_embeddings": 256, "rms_norm_eps": 1e-6, "rope_theta": 5e5,
                "rope_scaling": {"type": "linear", "factor": 2.0}, "tie_word_embeddings": True}
    assert tload.llama_config_from_hf(llama_hf).__dict__ == jload.llama_config_from_hf(
        llama_hf).__dict__
    for proj, pre in ((None, True), (64, True), (32, False)):
        opt_hf = {"vocab_size": 64, "hidden_size": 64, "ffn_dim": 128, "num_hidden_layers": 2,
                  "num_attention_heads": 4, "word_embed_proj_dim": proj,
                  "do_layer_norm_before": pre}
        t, j = tload.opt_config_from_hf(opt_hf), jload.opt_config_from_hf(opt_hf)
        assert t.__dict__ == j.__dict__
        assert t.word_embed_proj_dim == (32 if proj == 32 else None)


# ------------------------------------------------------------------ HF models

def _hf(kind, seed=0, **over):
    """A tiny HF model of ``kind`` built locally from its config."""
    import transformers as tf

    torch.manual_seed(seed)
    common = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2, num_attention_heads=4)
    if kind == "opt":
        cfg = tf.OPTConfig(**common, ffn_dim=128, max_position_embeddings=128,
                           word_embed_proj_dim=64, dropout=0.0)
        return tf.OPTForCausalLM(cfg).eval()
    cls = {"llama": (tf.LlamaConfig, tf.LlamaForCausalLM),
           "qwen2": (tf.Qwen2Config, tf.Qwen2ForCausalLM),
           "mistral": (tf.MistralConfig, tf.MistralForCausalLM)}[kind]
    cfg = cls[0](**common, intermediate_size=128, num_key_value_heads=2,
                 max_position_embeddings=256, tie_word_embeddings=False, **over)
    return cls[1](cfg).eval()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _assert_trees_equal(port, jax_tree):
    """The port's tree equals JAX's converted by ``core/convert.py``, bit for bit."""
    ref = to_port(jax_tree)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, port)) == jax.tree.structure(
        jax.tree.map(lambda t: 0, ref))
    for a, b in zip(_leaves(port), _leaves(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["llama", "qwen2", "mistral", "opt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_maps_like_jax(kind, dtype):
    hf = _hf(kind, seed=1)
    sd = hf.state_dict()
    if kind == "opt":
        jcfg = jload.opt_config_from_hf(hf.config.to_dict())
        tcfg = tload.opt_config_from_hf(hf.config.to_dict())
        jp = jload.opt_params_from_state_dict(sd, jcfg, getattr(jnp, dtype))
        tp = tload.opt_params_from_state_dict(sd, tcfg, getattr(torch, dtype), device="cpu")
    else:
        jcfg = JLCfg(**{**jload.llama_config_from_hf(hf.config.to_dict()).__dict__,
                        "qkv_bias": kind == "qwen2"})
        tcfg = TLCfg(**jcfg.__dict__)
        jp = jload.llama_params_from_state_dict(sd, jcfg, getattr(jnp, dtype))
        tp = tload.llama_params_from_state_dict(sd, tcfg, getattr(torch, dtype), device="cpu")
        assert ("bq" in tp["layers"]) == (kind == "qwen2")
    _assert_trees_equal(tp, jp)
    assert all(x.dtype == getattr(torch, dtype) for x in _leaves(tp))


@pytest.mark.parametrize("kind", ["llama", "qwen2"])
def test_llama_family_gives_hf_logits(kind):
    """The HF golden-logit check of the Llama decoder through the port's
    loader (Qwen2: the qkv biases)."""
    hf = _hf(kind, seed=2)
    cfg = TLCfg(**{**tload.llama_config_from_hf(hf.config.to_dict()).__dict__,
                   "dtype": "float32", "qkv_bias": kind == "qwen2",
                   "rms_norm_eps": hf.config.rms_norm_eps})
    tp = tload.llama_params_from_state_dict(hf.state_dict(), cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, VOCAB, (2, 9))
    logits, _ = tl.forward(tp, cfg, torch.from_numpy(tokens),
                           TBundle("llama", cfg, tl.forward).make_cache(2, 32, device="cpu"))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.float().numpy()
    np.testing.assert_allclose(logits.numpy(), ref, atol=2e-4)


# ------------------------------------------------------------------ directories

def test_safetensors_reader_matches_the_package(tmp_path):
    """Every dtype the reader maps, including bf16, fp8, bool and an empty
    tensor, against the ``safetensors`` package's own reader."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn((3, 5), generator=g), "f16": torch.randn((4,), generator=g).half(),
        "bf16": torch.randn((2, 3, 4), generator=g).bfloat16(),
        "f64": torch.randn((2,), generator=g).double(),
        "i8": torch.randint(-128, 128, (7, 3), generator=g, dtype=torch.int8),
        "i32": torch.randint(-9, 9, (5,), generator=g, dtype=torch.int32),
        "i64": torch.randint(-9, 9, (2, 2), generator=g),
        "u8": torch.randint(0, 256, (9,), generator=g, dtype=torch.uint8),
        "bool": torch.rand((6,), generator=g) > 0.5,
        "fp8": torch.randn((4, 4), generator=g).to(torch.float8_e4m3fn),
        "empty": torch.zeros((0, 3)), "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, ref = tload.read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert torch.equal(got[k].view(torch.uint8) if k == "fp8" else got[k],
                           ref[k].view(torch.uint8) if k == "fp8" else ref[k]), k


def test_reader_rejects_bad_offsets(tmp_path):
    header = json.dumps({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 12]}}).encode()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(len(header).to_bytes(8, "little") + header + bytes(16))
    with pytest.raises(ValueError, match="inconsistent"):
        tload.read_safetensors(str(path))
    with pytest.raises(FileNotFoundError):
        tload.read_safetensors_dir(str(tmp_path / "missing_dir_has_none"))


@pytest.mark.parametrize("kind", ["llama", "opt", "qwen2", "mistral"])
def test_load_pretrained_matches_jax(kind, tmp_path):
    """A directory written by ``save_pretrained`` (bf16 weights for OPT,
    fp32 for the others) loads into the config and tree JAX's loader gives,
    on the CPU; a Qwen2 with ``use_sliding_window`` and a Mistral get
    ``max_position`` clamped to the window and the window recorded."""
    over = {"qwen2": dict(use_sliding_window=True, sliding_window=32),
            "mistral": dict(sliding_window=48)}.get(kind, {})
    hf = _hf(kind, seed=4, **over)
    if kind == "opt":
        hf = hf.to(torch.bfloat16)
    path = str(tmp_path / kind)
    hf.save_pretrained(path)
    fam, cfg, params = tload.load_pretrained(path, device="cpu")
    jfam, jcfg, jparams = jload.load_pretrained(path)
    assert fam == jfam == ("opt" if kind == "opt" else "llama")
    assert cfg.__dict__ == jcfg.__dict__
    _assert_trees_equal(params, jparams)
    if over:
        assert cfg.sliding_window == over["sliding_window"] == cfg.max_position


def test_windowed_cache_rejected_beyond_window(tmp_path):
    hf = _hf("mistral", seed=5, sliding_window=16)
    hf.save_pretrained(str(tmp_path))
    fam, cfg, params = tload.load_pretrained(str(tmp_path), dtype="float32", device="cpu")
    bundle = TBundle(fam, cfg, tl.forward)
    with pytest.raises(ValueError, match="sliding"):
        bundle.make_cache(1, 32, device="cpu")
    cache = bundle.make_cache(1, 16, device="cpu")  # at the window: fine, and HF's logits
    tokens = np.random.default_rng(6).integers(0, VOCAB, (1, 12))
    logits, _ = tl.forward(params, cfg, torch.from_numpy(tokens), cache)
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.float().numpy()
    np.testing.assert_allclose(logits.numpy(), ref, atol=2e-4)


def test_unknown_model_type_and_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        tload.load_pretrained(str(tmp_path / "absent"), device="cpu")
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    hf = _hf("llama")
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in hf.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="unsupported model_type"):
        tload.load_pretrained(str(tmp_path), device="cpu")


# ------------------------------------------------------------------ save / load

def _small_llama():
    cfg = JLCfg(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
                num_kv_heads=4, max_position=64, dtype="float32",
                rope_scaling=("linear", 2.0))
    return cfg, jl.init_params(cfg, jax.random.key(0))


@pytest.mark.parametrize("fmt", [None, "int8", "fp8_e4m3"])
def test_save_load_roundtrip(fmt, tmp_path):
    jcfg, jp = _small_llama()
    if fmt is not None:
        jp = jquant(jp, "llama", quantize_lm_head=True, fmt=fmt)
    cfg, params = TLCfg(**jcfg.__dict__), to_port(jp)
    tload.save_params(str(tmp_path), "llama", cfg, params)
    fam, cfg2, p2 = tload.load_params(str(tmp_path), device="cpu")
    assert fam == "llama" and cfg2 == cfg and cfg2.rope_scaling == ("linear", 2.0)
    if fmt is not None:
        want = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}[fmt]
        assert p2["layers"]["wq"]["q"].dtype == p2["lm_head"]["q"].dtype == want
    for a, b in zip(_leaves(params), _leaves(p2)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8) if a.element_size() == 1
                                                  else a, b.view(torch.uint8)
                                                  if b.element_size() == 1 else b)


def test_load_pretrained_cache_dir(tmp_path, monkeypatch):
    """The first load converts and saves into ``cache_dir``; the next one
    restores from it without reading the checkpoint."""
    hf = _hf("opt", seed=7)
    src, cache = str(tmp_path / "src"), str(tmp_path / "conv")
    hf.save_pretrained(src)
    first = tload.load_pretrained(src, cache_dir=cache, device="cpu")
    assert os.path.exists(os.path.join(cache, "meta.json"))
    monkeypatch.setattr(tload, "read_safetensors_dir", lambda p: pytest.fail("read again"))
    fam, cfg, params = tload.load_pretrained("/nonexistent", cache_dir=cache, device="cpu")
    assert fam == first[0] == "opt" and cfg == first[1]
    for a, b in zip(_leaves(first[2]), _leaves(params)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ fp8 route

def _fp8_models():
    cfg = JLCfg(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=4, num_kv_heads=4, max_position=128, dtype="float32")
    params = jl.init_params(cfg, jax.random.key(0))
    qparams = jquant(params, "llama", quantize_lm_head=True, fmt="fp8_e4m3")
    return cfg, params, qparams


def test_fp8_forward_matches_jax():
    cfg, params, qparams = _fp8_models()
    tcfg = TLCfg(**cfg.__dict__)
    tq = to_port(qparams)
    assert tq["layers"]["wq"]["q"].dtype == torch.float8_e4m3fn
    tokens = np.random.default_rng(1).integers(0, 256, (1, 16))
    jc = JBundle("llama", cfg, jl.forward).make_cache(1, 64)
    tb = TBundle("llama", tcfg, tl.forward)
    tc = tb.make_cache(1, 64, device="cpu")
    for sl in (slice(0, 12), slice(12, 13), slice(13, 16)):  # prefill, decode, verify
        jlog, jc = jl.forward(qparams, cfg, jnp.asarray(tokens[:, sl], jnp.int32), jc)
        tlog, tc = tl.forward(tq, tcfg, torch.from_numpy(tokens[:, sl]), tc)
        assert rel_err(tlog, jlog) < 5e-3
    # the fp8 product is the plain bf16 x bf16 one, held to JAX's XLA route
    from llmspeculativesampling_tpu.kernels.int8_matmul import int8_matmul_ref as j_ref

    x = np.random.default_rng(2).standard_normal((5, 128)).astype(np.float32)
    w = qparams["layers"]["w_up"]
    got = tlin.fp8_matmul(torch.from_numpy(x), to_port(w["q"][0]), to_port(w["s"][0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_ref(jnp.asarray(x), w["q"][0], w["s"][0])),
                               rtol=1e-5, atol=1e-6)


def test_fp8_engine_greedy_ids_equal_jax():
    """An fp8 target under a dense 1-layer draft: the speculative engine's
    greedy ids equal JAX's, and a sampled run gives a well-formed output."""
    cfg, params, qparams = _fp8_models()
    cfg_d = JLCfg(**{**cfg.__dict__, "num_layers": 1})
    pd = {**{k: v for k, v in params.items() if k != "layers"},
          "layers": jax.tree.map(lambda x: x[:1], params["layers"])}
    jbd, jbt = JBundle("llama", cfg_d, jl.forward), JBundle("llama", cfg, jl.forward)
    tbd = TBundle("llama", TLCfg(**cfg_d.__dict__), tl.forward)
    tbt = TBundle("llama", TLCfg(**cfg.__dict__), tl.forward)
    prompt = list(range(5, 20))
    kw = dict(gamma=3, eos_token_id=-1, top_k=1)
    jout = jspec.speculative_generate(jbd, pd, jbt, qparams, prompt, 12, key=jax.random.key(7),
                                      **kw)
    tout = tspec.speculative_generate(tbd, to_port(pd), tbt, to_port(qparams), prompt, 12,
                                      device="cpu", **kw)
    np.testing.assert_array_equal(tout, np.asarray(jout))
    out = tspec.speculative_generate(tbd, to_port(pd), tbt, to_port(qparams), prompt, 12,
                                     gamma=3, eos_token_id=-1, top_k=10, top_p=0.9, device="cpu",
                                     generator=torch.Generator().manual_seed(7))
    assert 15 + 12 <= len(out) <= 15 + 12 + 3 and (out >= 0).all() and (out < 256).all()


def test_quantized_fp8_lm_head_takes_the_fp8_route():
    """A quantized fp8 head ``{"q": [H, V], "s": [V]}`` goes to the plain
    fp8 product, not to the int8 kernel's wrapper."""
    cfg, _, qparams = _fp8_models()
    head = to_port(qparams["lm_head"])
    h = torch.randn((1, 3, 128), generator=torch.Generator().manual_seed(0))
    got = tlin.lm_head_logits(h, head)
    ref = tlin.fp8_matmul(h, head["q"], head["s"]).float()
    assert got.dtype == torch.float32 and torch.equal(got, ref)
    tq = tquant(tl.init_params(TLCfg(**cfg.__dict__), torch.Generator().manual_seed(1),
                               device="cpu"), "llama", quantize_lm_head=True, fmt="fp8_e4m3")
    assert tq["lm_head"]["q"].shape == (128, 256)
