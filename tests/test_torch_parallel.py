"""The port's tensor parallelism (``parallel/``, the sharded forwards,
``norm_logits_topk_tp``, ``tp_mesh`` in every engine, ``mesh=`` in both
serving engines) against the JAX package on the 8-device CPU mesh at
dp=1 x tp=2. The port runs on two gloo ranks on loopback
(``parallel/launch.py``, the cases in ``tests/_torch_tp_cases.py``).

* Spec tables equal JAX's leaf for leaf; each rank's shard equals the data
  of JAX's addressable shard on that tp index, bit for bit.
* The tp=2 forward, gathered, matches JAX's sharded forward within 2e-4
  in fp32 (JAX's own bound for sharded vs unsharded,
  tests/test_parallel.py:64-111); with int8 weights, a quantized head and
  an int8 KV cache within 2e-2 of the largest logit, the port's int8-KV
  tolerance against JAX (tests/test_torch_llama.py; measured 5.0e-3, all of
  it already between the unsharded forwards: bf16 activation roundings
  flip where the fp32 sums differ in order). Against the port's own
  unsharded forward: 1e-5 in fp32 and 5e-3 in int8 (the int8-weight
  tolerance of tests/test_torch_llama.py).
* ``norm_logits_topk_tp`` gives ``norm_logits_topk``'s ids and probs bit
  for bit, ties included, and moves 2·tp·N·k numbers (a value and an id
  per candidate), never the vocab.
* Every entry point gives the same ids on the whole tree, on the shards
  with ``tp_mesh=None`` and with ``tp_mesh``; greedy spec and AR ids equal
  JAX's; both serving engines with ``mesh=`` give the one-process ids.
  (The data-parallel axis: tests/test_torch_dp.py.)
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from llmspeculativesampling_tpu import parallel as jpar
from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.core.config import OPTConfig as JOCfg
from llmspeculativesampling_tpu.engine.autoregressive import autoregressive_generate as j_ar
from llmspeculativesampling_tpu.engine.speculative import speculative_generate as j_spec
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.models import opt as jo
from llmspeculativesampling_tpu.ops.sampling import SamplingConfig as JSampling
from llmspeculativesampling_tpu.ops.sampling import norm_logits_topk as j_topk
from llmspeculativesampling_tpu.quant import quantize_params as j_quantize
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.core.config import OPTConfig as TOCfg
from llmspeculativesampling_tpu_torch.parallel import distributed as tdist
from llmspeculativesampling_tpu_torch.parallel import sharding as ts
from llmspeculativesampling_tpu_torch.parallel.launch import launch

import _torch_tp_cases as C
from _torch_port import one_thread, rel_err, to_port  # noqa: F401 (fixture)

TP = 2
RANK_LIMIT_S = 120.0
QWEN2 = {**C.LLAMA, "qkv_bias": True}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mesh():
    return jpar.make_mesh(dp=1, tp=TP, devices=jax.devices()[:TP])


def _port_mesh(rank: int, dp: int = 1, tp: int = TP) -> ts.Mesh:
    """A mesh seen from ``rank`` without a process group: enough to slice."""
    return ts.Mesh(np.arange(dp * tp).reshape(dp, tp), rank)


def _jax_params(family: str, kw: dict, seed: int = 0):
    if family == "opt":
        return jo.init_params(JOCfg(**kw), jax.random.key(seed))
    p = jl.init_params(JCfg(**kw), jax.random.key(seed))
    if kw.get("qkv_bias"):  # nonzero biases, so the column split of bq/bk/bv shows
        for i, name in enumerate(("bq", "bk", "bv")):
            p["layers"][name] = 0.1 * jax.random.normal(jax.random.key(seed + 10 + i),
                                                        p["layers"][name].shape, jnp.float32)
    return p


# ---------------------------------------------------------------- spec tables

def _spec_tree(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("family,kw", [("llama", C.LLAMA), ("llama", QWEN2), ("opt", C.OPT)],
                         ids=["llama", "qwen2", "opt"])
def test_param_specs_equal_jax(family, kw):
    jcfg = (JOCfg if family == "opt" else JCfg)(**kw)
    tcfg = (TOCfg if family == "opt" else TCfg)(**kw)
    assert ts.param_specs(family, tcfg) == _spec_tree(jpar.param_specs(family, jcfg))


@pytest.mark.parametrize("spec", [P(None, None, "tp"), P(None, "tp", None), P("tp", None),
                                  P(None, "tp"), P(None)])
def test_quant_leaf_and_cache_specs_equal_jax(spec):
    assert ts.quant_leaf_spec(tuple(spec)) == _spec_tree(jpar.quant_leaf_spec(spec))
    assert ts.cache_spec() == tuple(jpar.cache_spec())
    assert ts.cache_scale_spec() == tuple(jpar.cache_scale_spec())
    assert (ts.DP_AXIS, ts.TP_AXIS) == (jpar.DP_AXIS, jpar.TP_AXIS)


# ------------------------------------------------------------- shard contents

def _shard_cases():
    llama_q = j_quantize(_jax_params("llama", C.LLAMA), "llama", quantize_lm_head=True)
    return {"qwen2": ("llama", QWEN2, _jax_params("llama", QWEN2)),
            "llama_int8_head": ("llama", C.LLAMA, llama_q),
            "opt": ("opt", C.OPT, _jax_params("opt", C.OPT))}


@pytest.mark.parametrize("case", ["qwen2", "llama_int8_head", "opt"])
def test_shards_equal_jax_addressable_shards(case):
    family, kw, params = _shard_cases()[case]
    jcfg = (JOCfg if family == "opt" else JCfg)(**kw)
    mesh = _jax_mesh()
    j_sh = jpar.shard_params(params, jpar.param_specs(family, jcfg), mesh)
    devices = list(mesh.devices.flat)
    port = [ts.shard_params(to_port(params), ts.param_specs(family, jcfg), _port_mesh(r))
            for r in range(TP)]
    j_leaves = jax.tree_util.tree_leaves_with_path(j_sh)
    assert len(j_leaves) == len(jax.tree.leaves(port[0]))
    for path, leaf in j_leaves:
        for shard in leaf.addressable_shards:
            r = devices.index(shard.device)
            got = port[r]
            for k in path:
                got = got[k.key]
            assert tuple(got.shape) == shard.data.shape, path
            assert got.is_contiguous() and got.sharding.mesh.tp_rank == r
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data), err_msg=str(path))


def test_indivisible_dimension_raises_naming_the_leaf():
    specs = ts.param_specs("llama", TCfg(**C.LLAMA))
    with pytest.raises(ValueError, match=r"embed: dimension 0 \(256\)"):  # the vocab
        ts.shard_params(to_port(_jax_params("llama", C.LLAMA)), specs, _port_mesh(0, tp=3))
    kw = {**C.LLAMA, "vocab_size": 258}
    with pytest.raises(ValueError, match=r"layers\.w\w+: dimension [12] \((64|128)\)"):  # a width
        ts.shard_params(to_port(_jax_params("llama", kw)), specs, _port_mesh(0, tp=3))
    with pytest.raises(ValueError, match="tp=3"):
        ts.local_heads(TCfg(**C.LLAMA), _port_mesh(0, tp=3))


def test_single_process_mesh_and_cluster():
    """JAX's test_make_mesh_shapes: one process is a 1 x 1 mesh and an
    absent cluster a no-op."""
    assert tdist.initialize_cluster() == 0
    m = tdist.global_mesh(dp=1)
    assert m.shape == {"dp": 1, "tp": 1} and m.axis_names == ("dp", "tp") and m.coords == (0, 0)
    with pytest.raises(ValueError):
        ts.make_mesh(dp=2, tp=4)


# ------------------------------------------------------------ forward parity

FWD_TOKENS = np.asarray(np.random.default_rng(1).integers(0, 120, (2, 12)))
PREFILL_TOKENS = np.asarray(np.random.default_rng(2).integers(0, 120, (1, 40)))
DECODE_STEPS = 2


def _fwd_cases():
    llama_q = j_quantize(_jax_params("llama", C.LLAMA), "llama", quantize_lm_head=True)
    return {
        "llama": ("llama", C.LLAMA, _jax_params("llama", C.LLAMA), FWD_TOKENS, False),
        "qwen2_prefill": ("llama", QWEN2, _jax_params("llama", QWEN2), PREFILL_TOKENS, False),
        "opt": ("opt", C.OPT, _jax_params("opt", C.OPT), FWD_TOKENS, False),
        "llama_int8": ("llama", C.LLAMA, llama_q, FWD_TOKENS, True),
    }


def _jax_sharded_forward(family, kw, params, tokens, kv_quant):
    jcfg = (JOCfg if family == "opt" else JCfg)(**kw)
    bundle = JBundle(family, jcfg, (jo if family == "opt" else jl).forward, kv_quant=kv_quant)
    mesh = _jax_mesh()
    step = jax.jit(lambda p, t, c: bundle.forward(p, bundle.cfg, t, c))
    with mesh:
        p = jpar.shard_params(params, jpar.param_specs(family, jcfg), mesh)
        cache = jpar.shard_cache(bundle.make_cache(tokens.shape[0], 64), mesh)
        logits, cache = step(p, jnp.asarray(tokens, jnp.int32), cache)
        seq = [np.asarray(logits)]
        for _ in range(DECODE_STEPS):
            logits, cache = step(p, jnp.argmax(logits[:, -1:], -1).astype(jnp.int32), cache)
            seq.append(np.asarray(logits))
    return seq


@pytest.fixture(scope="module")
def fwd():
    cases = _fwd_cases()
    ranks = launch("_torch_tp_cases:forward_case", TP, (
        {k: (f, kw, _np_tree(p), t, q, DECODE_STEPS) for k, (f, kw, p, t, q) in cases.items()},),
        timeout_s=RANK_LIMIT_S, device="cpu")
    return ({k: _jax_sharded_forward(*c) for k, c in cases.items()},
            {k: _port_whole_forward(*c) for k, c in cases.items()}, ranks)


def _port_whole_forward(family, kw, params, tokens, kv_quant):
    b = C.bundle(family, kw, kv_quant)
    p = to_port(params)
    logits, cache = b.forward(p, b.cfg, torch.as_tensor(tokens), b.make_cache(tokens.shape[0], 64,
                                                                               device="cpu"))
    seq = [logits.numpy()]
    for _ in range(DECODE_STEPS):
        logits, cache = b.forward(p, b.cfg, logits[:, -1:].argmax(-1), cache)
        seq.append(logits.numpy())
    return seq


@pytest.mark.parametrize("case", ["llama", "qwen2_prefill", "opt", "llama_int8"])
def test_tp_forward_matches_jax_sharded_forward(fwd, case):
    """A prefill (12 tokens: the flash path's plain version; 40: the
    einsum path), then greedy decode steps through the cache at this rank's
    kv heads. Both ranks hold the same gathered logits."""
    ref, whole, ranks = fwd
    for r in ranks:
        assert r[case]["cache_heads"] == 8 // TP
        for got, want, own in zip(r[case]["logits"], ref[case], whole[case]):
            assert got.shape == want.shape
            if case == "llama_int8":
                assert rel_err(got, want) <= 2e-2
                assert rel_err(got, own) <= 5e-3
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
                assert rel_err(got, own) <= 1e-5
    for a, b in zip(ranks[0][case]["logits"], ranks[1][case]["logits"]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- tp sampling

@pytest.fixture(scope="module")
def topk():
    x = np.random.default_rng(0).normal(size=(3, 4096)).astype(np.float32) * 4.0
    x = np.round(x * 2.0) / 2.0  # many exact ties, at the k-th value too
    return x, launch("_torch_tp_cases:topk_case", TP, (x, 20, 0.9, 0.8), timeout_s=RANK_LIMIT_S,
                     device="cpu")


def test_tp_topk_equals_dense_sparse_path_with_ties(topk):
    x, ranks = topk
    ref = j_topk(jnp.asarray(x), JSampling(0.8, 20, 0.9))
    for r in ranks:
        np.testing.assert_array_equal(r["idx"], r["ref_idx"])
        np.testing.assert_array_equal(r["probs"], r["ref_probs"])
        np.testing.assert_array_equal(r["idx"], np.asarray(ref.idx))  # lax.top_k's tie order
        np.testing.assert_allclose(r["probs"], np.asarray(ref.probs), rtol=1e-6, atol=1e-7)


def test_tp_topk_moves_only_the_candidates(topk):
    """The counterpart of JAX's test_tp_topk_sampling_avoids_fullwidth_gather:
    one all_reduce of N x tp x (value, id) x k numbers, nothing else."""
    x, ranks = topk
    n, k = x.shape[0], 20
    for r in ranks:
        assert r["moved"] == {"all_reduce": [1, n * TP * 2 * k]}
        assert n * TP * 2 * k < x.size


def test_tp_mesh_requires_top_k():
    from llmspeculativesampling_tpu_torch.ops.sampling import SamplingConfig

    with pytest.raises(ValueError, match="top_k > 0"):
        SamplingConfig(1.0, 0, 0.9, tp_mesh=_port_mesh(0))


# ------------------------------------------------------------------- engines

GREEDY_TOKENS = 10


@pytest.fixture(scope="module")
def engines():
    pt = _jax_params("llama", C.LLAMA)
    return pt, launch("_torch_tp_cases:engines_case", TP, (_np_tree(pt), GREEDY_TOKENS),
                      timeout_s=RANK_LIMIT_S, device="cpu")


@pytest.mark.parametrize("name", ["speculative", "autoregressive", "speculative_v2", "multi",
                                  "multi_beam", "mjsd", "bild", "beam_v2", "beam_v1",
                                  "random_beam"])
def test_tp_mesh_reaches_every_engine(engines, name):
    """The counterpart of JAX's test_tp_mesh_reaches_every_engine: the
    whole tree, the shards with tp_mesh=None and with tp_mesh give the same
    ids, on both ranks."""
    _, ranks = engines
    whole, gathered, tp = ranks[0][name]
    np.testing.assert_array_equal(gathered, whole)
    np.testing.assert_array_equal(tp, whole)
    for a, b in zip(ranks[0][name], ranks[1][name]):
        np.testing.assert_array_equal(a, b)


def test_greedy_tp_ids_equal_jax(engines):
    pt, ranks = engines
    jcfg = JCfg(**C.LLAMA)
    pd = {"embed": pt["embed"], "ln_final": pt["ln_final"], "lm_head": pt["lm_head"],
          "layers": jax.tree.map(lambda a: a[:1], pt["layers"])}
    bt = JBundle("llama", jcfg, jl.forward)
    bd = JBundle("llama", JCfg(**{**C.LLAMA, "num_layers": 1}), jl.forward)
    kw = dict(eos_token_id=-1, top_k=1, key=jax.random.key(0))
    want_spec = j_spec(bd, pd, bt, pt, C.PROMPT, GREEDY_TOKENS, gamma=3, **kw)
    want_ar = j_ar(bt, pt, C.PROMPT, GREEDY_TOKENS, **kw)
    for r in ranks:
        np.testing.assert_array_equal(r["greedy_spec"], np.asarray(want_spec))
        np.testing.assert_array_equal(r["greedy_ar"], np.asarray(want_ar))


# ------------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def serving():
    return launch("_torch_tp_cases:serving_case", TP, timeout_s=RANK_LIMIT_S, device="cpu")


@pytest.mark.parametrize("kind", ["slots", "paged"])
@pytest.mark.parametrize("family", ["llama", "opt"])
def test_serving_engine_mesh_gives_unsharded_ids(serving, kind, family):
    """ContinuousBatchingEngine(mesh=) / PagedEngine(mesh=) at tp=2: the
    one-process engine's completions, on both ranks (JAX's
    test_sharded_continuous_batching_engine, test_sharded_paged_engine and
    its OPT twin)."""
    want = C.serve_all(kind, family)
    for r in serving:
        for got, w in zip(r[(kind, family)], want):
            np.testing.assert_array_equal(got, w)
