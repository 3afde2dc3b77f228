"""The port's quantization (``quant/core.py``), KV cache
(``cache/kvcache.py``) and weight bridge (``core/convert.py``) against the
JAX package: identical int8 codes and scales, identical fp8 bits, identical
cache contents after the same writes. Every comparison here is exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.cache import kvcache as jkv
from llmspeculativesampling_tpu.quant import core as jq
from llmspeculativesampling_tpu_torch.cache import kvcache as tkv
from llmspeculativesampling_tpu_torch.core.convert import params_from_numpy, tensor_from_numpy
from llmspeculativesampling_tpu_torch.quant import core as tq

from _torch_port import to_port


def _w(shape, seed=0, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 32)])
def test_quantize_tensor_int8_identical(shape):
    w = _w(shape)
    jw = jq.quantize_tensor(jnp.asarray(w))
    tw = tq.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
    np.testing.assert_array_equal(tw["s"].numpy(), np.asarray(jw["s"]))
    np.testing.assert_array_equal(
        tq.dequantize_tensor(tw, torch.float32).numpy(),
        np.asarray(jq.dequantize_tensor(jw, jnp.float32)))


def test_quantize_tensor_fp8_identical_bits():
    w = _w((2, 64, 40), seed=1)
    jw = jq.quantize_tensor(jnp.asarray(w), "fp8_e4m3")
    tw = tq.quantize_tensor(torch.from_numpy(w), "fp8_e4m3")
    np.testing.assert_array_equal(tw["q"].view(torch.uint8).numpy(), np.asarray(jw["q"]).view(np.uint8))
    np.testing.assert_array_equal(tw["s"].numpy(), np.asarray(jw["s"]))


def test_quantize_params_and_lm_head_relayout():
    rng = np.random.default_rng(2)
    p = {"embed": _w((32, 16), 3), "lm_head": _w((32, 16), 4), "ln_final": np.ones(16, np.float32),
         "layers": {k: _w((2, 16, 16), i) for i, k in enumerate(jq.LLAMA_QUANT_KEYS)}}
    p["layers"]["ln_attn"] = rng.standard_normal((2, 16)).astype(np.float32)
    jp = jax.tree.map(np.asarray, jq.quantize_params(jax.tree.map(jnp.asarray, p), quantize_lm_head=True))
    tp = tq.quantize_params(params_from_numpy(p, "cpu"), quantize_lm_head=True)
    assert tp["lm_head"]["q"].shape == (16, 32)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_convert_is_bit_exact_for_bf16_and_fp8():
    x = jnp.asarray(_w((5, 7), 5, scale=3.0), jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(x).view(np.int16))
    f8 = jnp.asarray(_w((4, 4), 6), jnp.float8_e4m3fn)
    t8 = tensor_from_numpy(np.asarray(f8), "cpu")
    assert t8.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t8.view(torch.uint8).numpy(), np.asarray(f8).view(np.uint8))
    tree = to_port({"a": {"q": jnp.zeros((2, 3), jnp.int8), "s": jnp.ones(3)}, "b": [x]})
    assert tree["a"]["q"].dtype == torch.int8 and tree["b"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(1, 4, 5, 64), (2, 2, 3, 128)])
def test_quantize_kv_identical(shape):
    x = _w(shape, 7, scale=1.0)
    x[0, 0, 0] = 0.0  # an all-zero row hits the 1e-8 scale floor
    jq_, js = jkv._quantize_kv(jnp.asarray(x))
    tq_, ts = tkv._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("quant", [False, True])
def test_writes_match_jax_and_rollback_moves_only_the_pointer(quant):
    L, B, H, S, D = 2, 2, 3, 16, 8
    knew = _w((B, H, 5, D), 8, 1.0)
    vnew = _w((B, H, 5, D), 9, 1.0)
    if quant:
        jc = jkv.init_quant_cache(L, B, H, S, D)
        tc = tkv.init_quant_cache(L, B, H, S, D, device="cpu")
        j1 = jkv.write_layer_quant(jc.k_q[1], jc.k_s[1], jc.v_q[1], jc.v_s[1], 4,
                                   jnp.asarray(knew), jnp.asarray(vnew))
        t1 = tkv.write_layer_quant(*tkv.layer_slices(tc, 1), 4, torch.from_numpy(knew), torch.from_numpy(vnew))
        for a, b in zip(t1, j1):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert t1[0].data_ptr() == tc.k_q[1].data_ptr()  # in place
        assert int(tc.k_s[1, :, :, 4:9].ne(0).sum()) == B * H * 5
    else:
        jc = jkv.init_cache(L, B, H, S, D, jnp.float32)
        tc = tkv.init_cache(L, B, H, S, D, torch.float32, device="cpu")
        jk, jv = jkv.write_layer(jc.k[0], jc.v[0], 14, jnp.asarray(knew), jnp.asarray(vnew))
        tk, tv = tkv.write_layer(tc.k[0], tc.v[0], 14, torch.from_numpy(knew), torch.from_numpy(vnew))
        # the window is clamped to fit, as dynamic_update_slice clamps it
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tc.v[0].numpy(), np.asarray(jv))
    back = tkv.rollback(tkv.rollback(tc, 9), 4)
    assert back.length == 4 and back.max_len == S and back.batch == B
    first = lambda c: c.k_q if quant else c.k  # noqa: E731
    assert first(back).data_ptr() == first(tc).data_ptr()  # no data moved


@pytest.mark.parametrize("quant", [False, True])
def test_select_and_repeat_rows_match_jax(quant):
    L, B, H, S, D = 1, 3, 2, 8, 4
    x = _w((L, B, H, S, D), 10, 1.0)
    if quant:
        kq, ks = jkv._quantize_kv(jnp.asarray(x))
        jc = jkv.QuantKVCache(kq, kq, ks, ks, jnp.asarray(5, jnp.int32))
        tc = tkv.QuantKVCache(*(torch.from_numpy(np.array(a)) for a in (kq, kq, ks, ks)), 5)
        fields = ("k_q", "v_q", "k_s", "v_s")
    else:
        jc = jkv.KVCache(jnp.asarray(x), jnp.asarray(x), jnp.asarray(5, jnp.int32))
        tc = tkv.KVCache(torch.from_numpy(x.copy()), torch.from_numpy(x.copy()), 5)
        fields = ("k", "v")
    idx = np.array([2, 0, 2], np.int32)
    for jout, tout in ((jkv.select_rows(jc, jnp.asarray(idx)), tkv.select_rows(tc, torch.from_numpy(idx))),
                       (jkv.repeat_rows(jc, 2), tkv.repeat_rows(tc, 2))):
        for f in fields:
            np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)))
        assert tout.length == int(jout.length)


def test_update_and_read_layer_dequantizes_like_jax():
    B, H, S, D = 1, 2, 8, 16
    jc = jkv.init_quant_cache(1, B, H, S, D)
    tc = tkv.init_quant_cache(1, B, H, S, D, device="cpu")
    kn, vn = _w((B, H, 3, D), 11, 1.0), _w((B, H, 3, D), 12, 1.0)
    _, jk, jv = jkv.update_and_read_layer((jc.k_q[0], jc.k_s[0], jc.v_q[0], jc.v_s[0]), 2,
                                          jnp.asarray(kn), jnp.asarray(vn), jnp.float32)
    _, tk, tv = tkv.update_and_read_layer(tkv.layer_slices(tc, 0), 2, torch.from_numpy(kn),
                                          torch.from_numpy(vn), torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
