"""The port's tree/beam building blocks against the JAX package on the CPU.

* ``ops/dp.py`` and the sparse-joint sampling functions of ``ops/sampling.py``
  on numpy-seeded inputs, within 1e-6 (the same fp32 math, sums in other
  orders). Candidate lists are compared as the dense distributions they
  stand for: ids of zero-probability candidates (ties at -inf) may come in
  another order. The Gumbel draws of ``sample_k_topk`` use other random
  bits, so only their deterministic cases are compared.
* ``compact_tree_paths`` (dense and int8 caches), ``ancestor_matrix`` and
  ``backtrack_path``: exactly equal.
* The accept walks (v2 and v1, dense and sparse) on the same draft tree,
  target dists and accept uniforms as JAX's (its uniform draw is patched
  to return the port's), with the Gumbel noise of the resampling draws set
  to 0 on both sides (each draw becomes its distribution's argmax, or its
  top n): the same accepted depth, full-accept flag, per-level widths and
  next tokens, and the same acceptance sum and row scores within 1e-5.
* ``tree_verify``'s p_root / p_nodes on converted weights, dense fp32 and
  int8, sparse (top_k > 0) and dense paths, at the logit tolerances of
  ``tests/test_torch_llama.py`` (relative to the largest probability):
  1e-4 fp32, 5e-3 int8 weights. A 13-token tree takes the port's
  flash-decode path (its plain version on the CPU) under the tree bias; a
  33-token tree takes the einsum path, as in both packages.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.cache import kvcache as jkv
from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine import beam_draft as jbd
from llmspeculativesampling_tpu.engine import beam_tree as jbt
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.ops import dp as jdp
from llmspeculativesampling_tpu.ops import sampling as js
from llmspeculativesampling_tpu.quant.core import quantize_params as jquant
from llmspeculativesampling_tpu_torch.cache import kvcache as tkv
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine import beam_draft as tbd
from llmspeculativesampling_tpu_torch.engine import beam_tree as tbt
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.ops import dp as tdp
from llmspeculativesampling_tpu_torch.ops import sampling as ts

from _torch_port import one_thread, rel_err, to_np, to_port  # noqa: F401 (fixture)

B, V = 4, 50


def _t(x):
    return torch.from_numpy(np.array(x))


def _dense(dist, n):
    """A (flat-id) candidate dist -> dense numpy [..., n]."""
    idx, probs = to_np(dist.idx).astype(np.int64), to_np(dist.probs).astype(np.float64)
    out = np.zeros(idx.shape[:-1] + (n,))
    np.add.at(out.reshape(-1, n), (np.arange(idx.size // idx.shape[-1])[:, None],
                                   idx.reshape(-1, idx.shape[-1])), probs.reshape(-1, idx.shape[-1]))
    return out


def _pq(seed, n=B * V):
    rng = np.random.default_rng(seed)
    lp = rng.standard_normal(n).astype(np.float32) * 2
    lq = lp + rng.standard_normal(n).astype(np.float32)
    p, q = np.exp(lp) / np.exp(lp).sum(), np.exp(lq) / np.exp(lq).sum()
    return p.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_dp_matches_jax(seed):
    p, q = _pq(seed)
    for m in (1, 2, 4):
        ja = jdp.acceptance_alphas(jnp.asarray(p), jnp.asarray(q), m)
        ta = tdp.acceptance_alphas(_t(p), _t(q), m)
        np.testing.assert_allclose(to_np(ta), np.asarray(ja), atol=1e-6)
        jprobs, jexp = jdp.num_accept_distribution(ja, m)
        tprobs, texp = tdp.num_accept_distribution(_t(np.asarray(ja)), m)
        np.testing.assert_allclose(to_np(tprobs), np.asarray(jprobs), atol=1e-6)
        np.testing.assert_allclose(float(texp), float(jexp), atol=1e-6)
        jw, jexp2 = jdp.get_num_acc_prob(jnp.asarray(p), jnp.asarray(q), m)
        tw, texp2 = tdp.get_num_acc_prob(_t(p), _t(q), m)
        np.testing.assert_allclose(to_np(tw), np.asarray(jw), atol=1e-6)  # reference layout
        np.testing.assert_allclose(float(texp2), float(jexp2), atol=1e-6)
        for thres in (0.0, 0.3, 0.7, 0.95, 2.0):
            assert int(tdp.get_expect_cnt_by_thres(tw, thres)) == int(
                jdp.get_expect_cnt_by_thres(jw, thres))


def _rows(seed, k=8, top_p=0.9):
    """Per-row sparse dists [B, k] (JAX's, carried across), scores, valid."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 2
    d = js.norm_logits_topk(jnp.asarray(logits), js.SamplingConfig(1.0, k, top_p))
    scores = np.log(rng.uniform(0.05, 1.0, B)).astype(np.float32)
    valid = np.array([True, True, False, True])
    return (js.TopKDist(d.idx, d.probs), ts.TopKDist(_t(np.asarray(d.idx)).long(),
                                                      _t(np.asarray(d.probs))), scores, valid)


@pytest.mark.parametrize("top_p", [0.0, 0.9])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("seed", range(2))
def test_sparse_joint_functions_match_jax(seed, temperature, top_p):
    jd, td, scores, valid = _rows(seed)
    jcfg, tcfg = js.SamplingConfig(temperature, 6, top_p), ts.SamplingConfig(temperature, 6, top_p)
    for out_k in (None, B * 8):
        j = js.joint_topk_from_dists(jd, jnp.asarray(scores), jnp.asarray(valid), jcfg, V, out_k)
        t = ts.joint_topk_from_dists(td, _t(scores), _t(valid), tcfg, V, out_k)
        np.testing.assert_allclose(_dense(t, B * V), _dense(j, B * V), atol=1e-6)

    rng = np.random.default_rng(seed + 10)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 2
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    j = js.joint_topk_from_logp(jnp.asarray(logp), jnp.asarray(scores), jcfg)
    t = ts.joint_topk_from_logp(_t(logp), _t(scores), tcfg)
    np.testing.assert_allclose(_dense(t, B * V), _dense(j, B * V), atol=1e-6)
    j = js.joint_rowwarp_dense(jnp.asarray(logp), jnp.asarray(scores), jcfg)
    t = ts.joint_rowwarp_dense(_t(logp), _t(scores), tcfg)
    np.testing.assert_allclose(to_np(t), np.asarray(j), atol=1e-6)
    j = js.joint_rowwarp_topk(jnp.asarray(logp), jnp.asarray(scores), jcfg)
    t = ts.joint_rowwarp_topk(_t(logp), _t(scores), tcfg)
    np.testing.assert_allclose(_dense(t, B * V), _dense(j, B * V), atol=1e-6)

    # rewarp of a flat joint with zero entries; min_sum / alphas between two joints
    base_j = js.joint_topk_from_dists(jd, jnp.asarray(scores), jnp.asarray(valid),
                                      js.SamplingConfig(1.0, 0, 0.0), V, B * 8)
    base_t = ts.TopKDist(_t(np.asarray(base_j.idx)).long(), _t(np.asarray(base_j.probs)))
    np.testing.assert_allclose(_dense(ts.rewarp_topk(base_t, tcfg), B * V),
                               _dense(js.rewarp_topk(base_j, jcfg), B * V), atol=1e-6)
    q_j = js.joint_rowwarp_topk(jnp.asarray(logp), jnp.asarray(scores), js.SamplingConfig(1.0, 8, top_p))
    q_t = ts.TopKDist(_t(np.asarray(q_j.idx)).long(), _t(np.asarray(q_j.probs)))
    p_j = js.joint_topk_from_dists(jd, jnp.asarray(scores), jnp.asarray(valid), jcfg, V)
    p_t = ts.TopKDist(_t(np.asarray(p_j.idx)).long(), _t(np.asarray(p_j.probs)))
    np.testing.assert_allclose(float(ts.min_sum(p_t, q_t)), float(js.min_sum(p_j, q_j)), atol=1e-6)
    for m in (1, 4):
        np.testing.assert_allclose(to_np(ts.acceptance_alphas_topk(p_t, q_t, m)),
                                   np.asarray(js.acceptance_alphas_topk(p_j, q_j, m)), atol=1e-6)


def test_sample_k_topk_deterministic_cases():
    """Exactly n positive candidates: the draw is that set; fewer than n
    (or n above k): the over-draws become the argmax, as in JAX."""
    idx = np.array([[7, 3, 11, 5, 2], [9, 8, 1, 4, 6]], np.int32)
    probs = np.array([[0.5, 0.3, 0.2, 0.0, 0.0], [0.6, 0.4, 0.0, 0.0, 0.0]], np.float32)
    jd = js.TopKDist(jnp.asarray(idx), jnp.asarray(probs))
    td = ts.TopKDist(_t(idx).long(), _t(probs))
    for n, seed in ((3, 0), (4, 1), (7, 2)):
        j = np.asarray(js.sample_k_topk(jax.random.key(seed), jd, n))
        t = to_np(ts.sample_k_topk(torch.Generator().manual_seed(seed), td, n))
        assert t.shape == j.shape == (2, n)
        for row in range(2):
            assert sorted(t[row].tolist()) == sorted(j[row].tolist())


def _cache_pair(quant, seed=0):
    rng = np.random.default_rng(seed)
    shape = (2, 3, 2, 32, 8)  # [L, B, H, S_max, D]
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if not quant:
        jc = jkv.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(20, jnp.int32))
        return jc, tkv.KVCache(_t(k), _t(v), 20)
    kq, vq = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32) for _ in range(2))
    jc = jkv.QuantKVCache(jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(vs),
                          jnp.asarray(20, jnp.int32))
    return jc, tkv.QuantKVCache(_t(kq), _t(vq), _t(ks), _t(vs), 20)


@pytest.mark.parametrize("quant", [False, True])
def test_compact_tree_paths_matches_jax(quant):
    rng = np.random.default_rng(3)
    for prefix, t_len, n_valid in ((12, 4, 3), (12, 4, 0), (9, 5, 5)):
        jc, tc = _cache_pair(quant, prefix)
        path_idx = rng.integers(0, 12, (3, t_len)).astype(np.int32)
        valid = np.broadcast_to(np.arange(t_len) < n_valid, (3, t_len))
        jo = jkv.compact_tree_paths(jc, jnp.asarray(path_idx), jnp.asarray(valid),
                                    jnp.asarray(prefix, jnp.int32))
        to = tkv.compact_tree_paths(tc, _t(path_idx), _t(valid.copy()), prefix)
        assert to.length == int(jo.length) == prefix + n_valid
        for a, b in zip(tkv.kv_buffers(to), (jo.k_q, jo.v_q, jo.k_s, jo.v_s) if quant else (jo.k, jo.v)):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))


def test_ancestor_matrix_and_backtrack_match_jax():
    rng = np.random.default_rng(0)
    for gamma, b in ((3, 4), (4, 8), (1, 2)):
        parents = rng.integers(0, b, (gamma, b))
        toks = rng.integers(0, 64, (gamma, b))
        ja = jbt.ancestor_matrix(jnp.asarray(parents, jnp.int32), gamma, b)
        ta = tbt.ancestor_matrix(_t(parents), gamma, b)
        np.testing.assert_array_equal(to_np(ta), np.asarray(ja))
        par = rng.integers(0, b, 5)
        for level_end in range(gamma + 1):
            jout = jax.vmap(lambda p: jbt.backtrack_path(
                jnp.asarray(parents, jnp.int32), jnp.asarray(toks, jnp.int32), p,
                jnp.asarray(level_end), gamma, b))(jnp.asarray(par, jnp.int32))
            tout = tbt.backtrack_path(_t(parents), _t(toks), _t(par), level_end, gamma, b)
            for x, y in zip(tout, jout):
                np.testing.assert_array_equal(to_np(x), np.asarray(y))


def _models(int8):
    kw = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2,
              num_kv_heads=1, max_position=512, dtype="float32")
    params = jl.init_params(JCfg(**kw), jax.random.key(4))
    if int8:
        params = jquant(params, "llama", quantize_lm_head=True)
    return (JBundle("llama", JCfg(**kw), jl.forward), params,
            TBundle("llama", TCfg(**kw), tl.forward), to_port(params))


@pytest.mark.parametrize("top_k", [10, 0])
@pytest.mark.parametrize("int8,tol", [(False, 1e-4), (True, 5e-3)])
def test_tree_verify_matches_jax(int8, tol, top_k):
    jb, jp, tb, tp = _models(int8)
    rng = np.random.default_rng(5)
    jcfg, tcfg = js.SamplingConfig(1.0, top_k, 0.9), ts.SamplingConfig(1.0, top_k, 0.9)
    for r_rows, gamma, b in ((2, 3, 4), (1, 4, 8)):  # 13 tree tokens (flash), 33 (einsum)
        cur_len, t_max = 20, 64
        rows = rng.integers(1, 64, (r_rows, t_max))
        parents = rng.integers(0, b, (gamma, b))
        node_tokens = rng.integers(1, 64, gamma * b)
        slot = np.minimum(np.arange(b), r_rows - 1)
        roots = [slot[parents[0]]]
        for s in range(1, gamma):
            roots.append(roots[-1][parents[s]])
        node_roots = np.stack(roots).reshape(-1)
        jc, tc = jb.make_cache(r_rows, t_max), tb.make_cache(r_rows, t_max, device="cpu")
        _, jc = jb.forward(jp, jb.cfg, jnp.asarray(rows[:, :cur_len], jnp.int32), jc)
        _, tc = tb.forward(tp, tb.cfg, _t(rows[:, :cur_len]).long(), tc)
        janc = jbt.ancestor_matrix(jnp.asarray(parents, jnp.int32), gamma, b)
        tanc = tbt.ancestor_matrix(_t(parents), gamma, b)
        jr, jn, jc2 = jbt.tree_verify(jb, jp, jcfg, gamma, b, jnp.asarray(rows, jnp.int32),
                                      jnp.asarray(cur_len, jnp.int32), jc,
                                      jnp.asarray(node_tokens, jnp.int32),
                                      jnp.asarray(node_roots, jnp.int32), janc)
        tr, tn, tc2 = tbt.tree_verify(tb, tp, tcfg, gamma, b, _t(rows).long(), cur_len, tc,
                                      _t(node_tokens).long(), _t(node_roots), tanc)
        assert tc2.length == int(jc2.length) == cur_len + gamma * b
        for got, ref in ((tr, jr), (tn, jn)):
            if top_k:
                got, ref = _dense(got, 64), _dense(ref, 64)
            assert rel_err(got, ref) < tol, (r_rows, gamma, b, rel_err(got, ref))


def _walk_inputs(seed, gamma, b, r_slots, vocab, sparse):
    """A draft tree (parents, tokens drawn from the draft joint, their
    joint probs) and target dists for the root rows and the nodes, as the
    JAX and the port walks take them. Target logits are the draft's plus
    noise, so levels accept and fail."""
    rng = np.random.default_rng(seed)
    cfg = js.SamplingConfig(1.0, 8 if sparse else 0, 0.9 if sparse else 0.0)
    qlog = rng.standard_normal((gamma, b, vocab)).astype(np.float32) * 2
    scores = np.log(rng.uniform(0.2, 1.0, b)).astype(np.float32)
    joints, parents, toks, chosen = [], [], [], []
    for i in range(gamma):
        logp = jax.nn.log_softmax(jnp.asarray(qlog[i]), axis=-1)
        if sparse:
            j = js.joint_rowwarp_topk(logp, jnp.asarray(scores), cfg)
            dense = _dense(js.TopKDist(j.idx[None], j.probs[None]), b * vocab)[0]
        else:
            j = js.joint_rowwarp_dense(logp, jnp.asarray(scores), cfg)
            dense = np.asarray(j, np.float64)
        t = rng.choice(b * vocab, size=b, replace=False, p=dense / dense.sum())
        joints.append(j)
        parents.append(t // vocab)
        toks.append(t % vocab)
        chosen.append(dense[t].astype(np.float32))
    plog = np.concatenate([qlog[0][:r_slots], qlog.reshape(gamma * b, vocab)])
    plog = plog + rng.standard_normal(plog.shape).astype(np.float32) * 0.7
    p_all = (js.norm_logits_topk if sparse else js.norm_logits)(jnp.asarray(plog), cfg)
    if sparse:
        p_root = js.TopKDist(p_all.idx[:r_slots], p_all.probs[:r_slots])
        p_nodes = js.TopKDist(p_all.idx[r_slots:], p_all.probs[r_slots:])
        joint_q = js.TopKDist(jnp.stack([j.idx for j in joints]), jnp.stack([j.probs for j in joints]))
    else:
        p_root, p_nodes, joint_q = p_all[:r_slots], p_all[r_slots:], jnp.stack(joints)
    steps = dict(step_beam_idx=np.stack(parents).astype(np.int32),
                 step_next_tok=np.stack(toks).astype(np.int32), step_chosen_q=np.stack(chosen))
    return cfg, steps, joint_q, p_root, p_nodes, scores


def _to_t(x):
    if isinstance(x, js.TopKDist):
        return ts.TopKDist(_t(np.asarray(x.idx)).long(), _t(np.asarray(x.probs)))
    return _t(np.asarray(x))


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_walks_match_jax(mode, sparse, monkeypatch):
    gamma, b, vocab = 4, 4, 24
    r_slots = 1 if mode == "v2" else b
    depths = []
    for seed in range(10 if mode == "v2" else 3):  # v2's residual updates need more trees
        cfg, steps, joint_q, p_root, p_nodes, scores = _walk_inputs(seed, gamma, b, r_slots, vocab,
                                                                    sparse)
        tcfg = ts.SamplingConfig(cfg.temperature, cfg.top_k, cfg.top_p)
        none = {f: None for f in ("tail", "beam_scores", "seq_q", "root", "perbeam_probs",
                                  "step_root", "cache")}
        jres = jbd.BeamDraftResult(**{**none, "key": None}, step_joint_q=joint_q,
                                   **{k: jnp.asarray(v) for k, v in steps.items()})
        tres = tbd.BeamDraftResult(**none, step_joint_q=_to_t(joint_q),
                                   **{k: _t(v).long() if v.dtype == np.int32 else _t(v)
                                      for k, v in steps.items()})
        shape = (gamma, b) if mode == "v2" else (gamma,)
        r = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
        monkeypatch.setattr(jax.random, "uniform", lambda key, shp, *a, **k: jnp.asarray(
            r.numpy().reshape(shp)))
        for mod in (jax.random, jax._src.random):
            monkeypatch.setattr(mod, "gumbel", lambda key, shp=(), dtype=jnp.float32, *a, **k:
                                jnp.zeros(shp, dtype))
        monkeypatch.setattr(ts, "_gumbel_of", torch.zeros_like)
        gen = torch.Generator().manual_seed(seed)
        if mode == "v2":
            jwalk = jbt._v2_walk_sparse if sparse else jbt._v2_walk
            twalk = tbt._v2_walk_sparse if sparse else tbt._v2_walk
            jo = jwalk(cfg, gamma, b, vocab, 0.7, 1, jres, p_root, p_nodes, r_slots, jax.random.key(0))
            to = twalk(tcfg, gamma, b, vocab, 0.7, 1, tres, _to_t(p_root), _to_t(p_nodes), r_slots,
                       gen)
            np.testing.assert_array_equal(to_np(to[5]), np.asarray(jo[6]))  # per-level widths
            outs = [(jo, to)]
        else:
            jwalk = jbt._v1_walk_sparse if sparse else jbt._v1_walk
            twalk = tbt._v1_walk_sparse if sparse else tbt._v1_walk
            outs = []
            for first in (True, False):
                jst = types.SimpleNamespace(first=jnp.asarray(first), beam_scores=jnp.asarray(scores))
                tst = types.SimpleNamespace(first=first, beam_scores=_t(scores))
                outs.append((jwalk(cfg, gamma, b, vocab, 1, jres, p_root, p_nodes, jst, r_slots,
                                   jax.random.key(0)),
                             twalk(tcfg, gamma, b, vocab, 1, tres, _to_t(p_root), _to_t(p_nodes),
                                   tst, r_slots, torch.Generator().manual_seed(seed))))
        for jo, to in outs:
            assert int(to[1]) == int(jo[1]) and bool(to[2]) == bool(jo[2]), (seed, int(to[1]))
            np.testing.assert_array_equal(to_np(to[0]), np.asarray(jo[0]))  # next tokens
            np.testing.assert_allclose(to_np(to[3]), np.asarray(jo[3]), atol=1e-5)  # row scores
            np.testing.assert_allclose(float(to[4]), float(jo[4]), atol=1e-5)
            depths.append(int(to[1]))
    if mode == "v2":
        assert len(set(depths)) > 1, depths  # the inputs reach different depths


def test_top_width_matches_jax():
    rng = np.random.default_rng(2)
    b, gamma, vocab = 6, 3, 16
    arrays = dict(tail=rng.integers(0, vocab, (b, gamma)), beam_scores=rng.standard_normal(b),
                  seq_q=rng.uniform(size=(b, gamma)), perbeam_probs=rng.uniform(size=(b, gamma, vocab)))
    none = {f: None for f in ("root", "step_beam_idx", "step_next_tok", "step_chosen_q",
                              "step_joint_q", "step_root", "cache")}
    jres = jbd.BeamDraftResult(**none, key=None, **{k: jnp.asarray(v.astype(np.float32) if
                                                              v.dtype == np.float64 else v)
                                                    for k, v in arrays.items()})
    tres = tbd.BeamDraftResult(**none, **{k: _t(v.astype(np.float32) if v.dtype == np.float64
                                                  else v) for k, v in arrays.items()})
    for width in (1, 3, 6):
        for got, ref in zip(tbd.top_width(tres, width), jbd.top_width(jres, width)):
            np.testing.assert_array_equal(to_np(got), np.asarray(ref))
