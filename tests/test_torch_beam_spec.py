"""The port's beam-drafted engines (``engine/beam_spec.py``: multi-beam and
MJSD) and multi's beam dispatch against the JAX engines on converted
weights, on the CPU.

* Greedy (top_k=1): every draw is an argmax, so the port must give JAX's
  ids one for one, and the target's greedy path; with the draft equal to
  the target every candidate is accepted, so those runs go through the
  bonus sample and the row re-broadcast every step.
* Exact decisions: ``leading_accept`` and ``mjsd_accept`` equal JAX's
  ``_leading_accept`` / ``_mjsd_accept`` on seeded numpy inputs and the
  same injected r; both residual constructions (dense and sparse, beam
  and MJSD) equal the JAX engine's within 1e-6 (fp32, sums in other
  orders). Whole runs at top_k 8 and at the dense path, with the Gumbel
  noise of both packages replaced by the same fixed values
  (``_torch_port.patch_noise``) and one fixed accept uniform: the same
  ids, accept counts, acc_rate within 1e-5 and, read at each accept, the
  same q buffers within 1e-5, with ``ref_row_compat`` off and on (where
  the buffers must differ from the aligned ones).
* MJSD at accept_thres 0 accepts every draft, at 1.5 none.
* The first-token distribution of MJSD at width = num_beams = gamma = 1
  against the reference's rule (``tests/test_distribution_parity.py``
  :124-156) at 1,600 draws, TV_TOL 0.07 (see
  ``tests/test_torch_tree_engine.py`` for the budget).
* The ``details`` key sets equal JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.engine import beam_spec as jbs
from llmspeculativesampling_tpu.ops import sampling as js
from llmspeculativesampling_tpu_torch.engine import beam_spec as tbs
from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate as t_ar
from llmspeculativesampling_tpu_torch.ops import sampling as ts

from _torch_port import one_thread, patch_noise, to_np  # noqa: F401 (fixture)
from test_speculative import EOS, PROMPT
from test_torch_tree_engine import (  # noqa: F401 (fixtures)
    TOPK, TV_TOL, _first_tokens, _tv, dists, models)


@pytest.fixture(scope="module")
def greedy_ar(models):
    _, (_, _, tbt_, tpt) = models
    return t_ar(tbt_, tpt, PROMPT, 16, eos_token_id=EOS, top_k=1, device="cpu")


def _pick(models, same):
    (bd, pd, bt, pt), (tbd, tpd, tbt_, tpt) = models
    if same:
        return (bt, pt, bt, pt), (tbt_, tpt, tbt_, tpt)
    return (bd, pd, bt, pt), (tbd, tpd, tbt_, tpt)


@pytest.mark.parametrize("same", [False, True], ids=["distinct", "draft_is_target"])
@pytest.mark.parametrize("mode", ["beam", "mjsd"])
def test_greedy_equals_jax_and_ar(models, greedy_ar, mode, same):
    """The JAX tests' settings (``tests/test_beam_algorithms.py:76-105``):
    gamma 3, width 2, 4 beams, 16 tokens."""
    jm, tm = _pick(models, same)
    kw = dict(gamma=3, width=2, num_beams=4, eos_token_id=EOS, top_k=1, details=True)
    if mode == "mjsd":
        kw["accept_thres"] = 0.1
    jrun = jbs.multi_beam_generate if mode == "beam" else jbs.mjsd_generate
    trun = tbs.multi_beam_generate if mode == "beam" else tbs.mjsd_generate
    jo, jd = jrun(*jm, PROMPT, 16, key=jax.random.key(1), **kw)
    to, td = trun(*tm, PROMPT, 16, device="cpu", **kw)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(to[:len(greedy_ar)], greedy_ar)
    assert sorted(td) == sorted(jd)
    assert td["acc_len"] == jd["acc_len"]
    assert td["acc_rate"] == pytest.approx(jd["acc_rate"], abs=1e-6)
    if same:
        assert min(td["acc_len"]) == 3  # every candidate accepted: bonus + re-broadcast each step


@pytest.mark.parametrize("thres", [0.0, 1.5])
def test_mjsd_threshold_extremes(models, thres):
    """accept_thres 0 clears every ratio (min(1, .) >= 0): every step
    accepts gamma; 1.5 clears none (the ratio is capped at 1), so MJSD
    degrades to target-only sampling."""
    _, tm = models
    out, d = tbs.mjsd_generate(*tm, PROMPT, 12, gamma=3, width=2, num_beams=4,
                               accept_thres=thres, eos_token_id=EOS, top_k=8, details=True,
                               device="cpu", generator=torch.Generator().manual_seed(2))
    assert d["target_call_times"] >= 2
    if thres == 0.0:
        assert d["accepted_count"] == 3 * d["target_call_times"]
    else:
        assert d["accepted_count"] == 0 and d["tokens_generated"] >= 1
    assert out.min() >= 0 and out.max() < 64


@pytest.mark.parametrize("seed", range(4))
def test_accept_rules_match_jax(seed):
    rng = np.random.default_rng(seed)
    w, gamma = 5, 4
    p_sel = rng.uniform(0, 1, (w, gamma)).astype(np.float32)
    q_sel = rng.uniform(0, 1, (w, gamma)).astype(np.float32)
    p_sel[0, 1] = 0.0  # a zero-probability draft
    seq_q = rng.uniform(1e-4, 0.3, (w, gamma)).astype(np.float32)
    r = rng.uniform(0, 1, (w, gamma)).astype(np.float32)
    got = tbs.leading_accept(None, torch.from_numpy(p_sel), torch.from_numpy(q_sel),
                             torch.from_numpy(r))
    ref = jbs._leading_accept(None, jnp.asarray(p_sel), jnp.asarray(q_sel), jnp.asarray(r))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    for thres in (0.0, 0.05, 0.1, 0.3, 1.0, 1.5):
        got = tbs.mjsd_accept(thres, torch.from_numpy(p_sel), torch.from_numpy(seq_q))
        ref = jbs._mjsd_accept(thres, jnp.asarray(p_sel), jnp.asarray(seq_q))
        np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    np.testing.assert_allclose(to_np(tbs.mjsd_rate(torch.from_numpy(p_sel), torch.from_numpy(seq_q))),
                               np.minimum(np.exp(np.cumsum(np.log(p_sel + 1e-30), 1))
                                          / (seq_q + 1e-30), 1.0), rtol=1e-5)


def _jax_residual(mode, p_l, q_l):
    """The JAX engine's reject distribution, as written in
    ``llmspeculativesampling_tpu/engine/beam_spec.py:174-204``."""
    if isinstance(p_l, js.TopKDist):
        if mode == "beam":
            q_at_p = jnp.take(q_l, p_l.idx)
            wres = jnp.maximum(p_l.probs - q_at_p, 0.0)
            rp = wres / (jnp.sum(wres) + 1e-6)
            rp = jnp.where(jnp.sum(rp) < 1e-6, p_l.probs, rp)
            return js.TopKDist(p_l.idx, rp)
        return js.TopKDist(p_l.idx, js.max_fn(p_l.probs))
    if mode == "beam":
        resid = js.max_fn(p_l - q_l)
        return jnp.where(jnp.sum(resid) < 1e-6, p_l, resid)
    return js.max_fn(p_l)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("mode", ["beam", "mjsd"])
def test_residuals_match_jax(mode, sparse):
    vocab, k = 40, 8
    for seed in range(4):
        rng = np.random.default_rng(seed)
        logits = rng.standard_normal(vocab).astype(np.float32) * 2
        q_l = rng.dirichlet(np.ones(vocab)).astype(np.float32)
        if seed == 1:
            q_l = np.zeros(vocab, np.float32)  # past the last draft: the zero row
        if seed == 2:  # q covers p: the residual is empty and falls back to p
            q_l = np.asarray(js.norm_logits(jnp.asarray(logits), js.SamplingConfig(1.0, k, 0.0))) * 2
        cfg_j, cfg_t = js.SamplingConfig(1.0, k if sparse else 0, 0.9), ts.SamplingConfig(
            1.0, k if sparse else 0, 0.9)
        p_j = js.dist_norm(jnp.asarray(logits), cfg_j)
        p_t = ts.dist_norm(torch.from_numpy(logits), cfg_t)
        ref = _jax_residual(mode, p_j, jnp.asarray(q_l))
        got = tbs.residual(mode, p_t, torch.from_numpy(q_l))
        if sparse:
            ref = np.asarray(js.dense_probs(ref, vocab))
            got = to_np(ts.dense_probs(got, vocab))
        np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("compat", [False, True], ids=["aligned", "ref_row_compat"])
@pytest.mark.parametrize("top_k", [8, 0], ids=["sparse", "dense"])
@pytest.mark.parametrize("mode", ["beam", "mjsd"])
def test_runs_match_jax_under_fixed_noise(models, monkeypatch, mode, top_k, compat):
    """Whole runs with every draw made deterministic and equal on both
    sides: 19 new tokens (a budget no other test compiles the JAX engine
    with, so no other test reuses this trace), gamma 3, width 3 of 4
    beams, top_p 0.9; the q buffers each accept reads (beam: q at each
    candidate token; MJSD: the joint seq_q) are recorded on both sides."""
    (bd, pd, bt, pt), tm = models
    u0 = float(torch.rand((), generator=torch.Generator().manual_seed(5)))
    patch_noise(monkeypatch, uniform=u0)
    jbufs, tbufs = [], []

    def spy_j(fn, qpos):
        def wrapped(*a):
            jax.debug.callback(lambda q: jbufs.append(np.asarray(q)), a[qpos], ordered=True)
            return fn(*a)
        return wrapped

    def spy_t(fn, qpos, sink):
        def wrapped(*a):
            sink.append(to_np(a[qpos]))
            return fn(*a)
        return wrapped

    if mode == "beam":
        monkeypatch.setattr(jbs, "_leading_accept", spy_j(jbs._leading_accept, 2))
        monkeypatch.setattr(tbs, "leading_accept", spy_t(tbs.leading_accept, 2, tbufs))
    else:
        monkeypatch.setattr(jbs, "_mjsd_accept", spy_j(jbs._mjsd_accept, 2))
        monkeypatch.setattr(tbs, "mjsd_accept", spy_t(tbs.mjsd_accept, 2, tbufs))
    kw = dict(gamma=3, width=3, num_beams=4, eos_token_id=-1, top_k=top_k, top_p=0.9,
              details=True, ref_row_compat=compat, random_seed=5 if mode == "beam" else None)
    if mode == "mjsd":
        kw["accept_thres"] = 0.05
    jrun = jbs.multi_beam_generate if mode == "beam" else jbs.mjsd_generate
    trun = tbs.multi_beam_generate if mode == "beam" else tbs.mjsd_generate
    jo, jd = jrun(bd, pd, bt, pt, PROMPT, 19, key=jax.random.key(0), **kw)
    to, td = trun(*tm, PROMPT, 19, device="cpu", **kw)
    np.testing.assert_array_equal(to, jo)
    assert td["acc_len"] == jd["acc_len"]
    assert td["acc_rate"] == pytest.approx(jd["acc_rate"], abs=1e-5)
    assert len(tbufs) == len(jbufs) == len(td["acc_len"]) >= 4
    for got, ref in zip(tbufs, jbufs):
        np.testing.assert_allclose(got, ref, atol=1e-5)
    if compat:  # the misaligned buffers are not the aligned ones
        aligned = []
        monkeypatch.setattr(tbs, "leading_accept" if mode == "beam" else "mjsd_accept",
                            spy_t(tbs.leading_accept if mode == "beam" else tbs.mjsd_accept, 2,
                                  aligned))
        trun(*tm, PROMPT, 19, device="cpu", **{**kw, "ref_row_compat": False})
        assert any(a.shape != b.shape or not np.allclose(a, b) for a, b in zip(aligned, tbufs))


def test_mjsd_first_token_matches_reference_rule(models, dists):
    """width = num_beams = gamma = 1: the draft token x ~ q is kept iff
    accept_thres <= min(1, p(x)/q(x)); otherwise max_fn(p) is drawn, so
    P(t) = q(t) [thres <= min(1, p/q)] + P(reject) max_fn(p)(t)."""
    _, tm = models
    q, p = dists
    thres = 0.5
    draws = _first_tokens(lambda g: tbs.mjsd_generate(
        *tm, PROMPT, 1, gamma=1, width=1, num_beams=1, accept_thres=thres, eos_token_id=-1,
        top_k=TOPK, generator=g, device="cpu"))
    ratio = np.minimum(np.divide(p, q, out=np.zeros_like(p), where=q > 0), 1.0)
    keep = (thres <= ratio) & (q > 0)
    oracle = q * keep + (q * ~keep).sum() * p / (p.sum() + 1e-6)
    tv = _tv(draws, oracle)
    assert tv < TV_TOL, f"mjsd vs rule TV {tv:.4f}"
