"""The port's sampling ops (``ops/sampling.py``) against the JAX package's.

Deterministic functions (filters, softmax pipeline, residuals, the sparse
TopKDist path and the dist_* dispatch) agree exactly or within 1e-6 (fp32
softmax/cumsum in other orders). Samplers draw from a torch.Generator,
whose bits differ from jax.random's, so they are held to the distribution
they must sample, as tests/test_distribution_parity.py does: total
variation < 0.03 over 20000 draws (its expected value here is ~0.01)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.ops import sampling as js
from llmspeculativesampling_tpu_torch.ops import sampling as ts

N = 20000
TV_TOL = 0.03


def _logits(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 2.0).astype(np.float32)


def _tv(draws, probs):
    hist = np.bincount(np.asarray(draws).ravel(), minlength=probs.shape[-1]) / np.asarray(draws).size
    return 0.5 * np.abs(hist - probs).sum()


@pytest.mark.parametrize("k", [0, 1, 5, 64])
def test_apply_top_k_keeps_ties_like_jax(k):
    x = _logits((3, 64))
    x[0, :4] = x[0].max()  # ties at the top
    got = ts.apply_top_k(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(js.apply_top_k(jnp.asarray(x), k)))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.9, 1.0])
def test_apply_top_p_matches_jax(p):
    x = _logits((4, 50), seed=1)
    x[1, 10] = x[1, 11]  # a tie: the stable sort keeps index order
    got = ts.apply_top_p(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(np.asarray(js.apply_top_p(jnp.asarray(x), p))))


@pytest.mark.parametrize("cfg", [(1.0, 0, 0.0), (0.7, 10, 0.0), (1.0, 20, 0.9), (1.3, 0, 0.8)])
def test_norm_logits_matches_jax(cfg):
    x = _logits((2, 3, 80), seed=2)
    got = ts.norm_logits(torch.from_numpy(x), ts.SamplingConfig(*cfg)).numpy()
    ref = np.asarray(js.norm_logits(jnp.asarray(x), js.SamplingConfig(*cfg)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_residual_and_acceptance_math_match_jax():
    rng = np.random.default_rng(3)
    p = rng.dirichlet(np.ones(30), 4).astype(np.float32)
    q = rng.dirichlet(np.ones(30), 4).astype(np.float32)
    tp_, tq_ = torch.from_numpy(p), torch.from_numpy(q)
    for fn_t, fn_j, args in ((ts.max_fn, js.max_fn, (p - q,)),
                             (ts.acceptance_prob, js.acceptance_prob, (p, q)),
                             (ts.residual_update, js.residual_update, (p, q))):
        got = fn_t(*(torch.from_numpy(a) for a in args)).numpy()
        np.testing.assert_allclose(got, np.asarray(fn_j(*(jnp.asarray(a) for a in args))),
                                   rtol=1e-6, atol=1e-7)
    assert tp_.shape == tq_.shape


@pytest.mark.parametrize("cfg", [(1.0, 20, 0.9), (0.8, 5, 0.0), (1.0, 1, 0.0)])
def test_sparse_path_matches_jax(cfg):
    x = _logits((5, 100), seed=4)
    tcfg, jcfg = ts.SamplingConfig(*cfg), js.SamplingConfig(*cfg)
    td, jd = ts.norm_logits_topk(torch.from_numpy(x), tcfg), js.norm_logits_topk(jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(td.idx.numpy(), np.asarray(jd.idx))
    np.testing.assert_allclose(td.probs.numpy(), np.asarray(jd.probs), rtol=1e-6, atol=1e-7)
    # sparse == dense on the support
    dense = ts.norm_logits(torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ts.dense_probs(td, 100).numpy(), dense.numpy(), atol=1e-6)
    tok = np.asarray([int(jd.idx[i, i % jd.idx.shape[1]]) for i in range(5)], np.int64)
    np.testing.assert_allclose(ts.prob_of_topk(td, torch.from_numpy(tok)).numpy(),
                               np.asarray(js.prob_of_topk(jd, jnp.asarray(tok, jnp.int32))), atol=1e-7)
    # residual between two sparse distributions
    td2 = ts.norm_logits_topk(torch.from_numpy(x[::-1].copy()), tcfg)
    jd2 = js.norm_logits_topk(jnp.asarray(x[::-1].copy()), jcfg)
    tr, jr = ts.residual_topk(td, td2), js.residual_topk(jd, jd2)
    np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
    np.testing.assert_allclose(tr.probs.numpy(), np.asarray(jr.probs), rtol=1e-6, atol=1e-7)


def test_dist_helpers_match_jax():
    x = _logits((4, 60), seed=5)
    for cfg in ((1.0, 10, 0.9), (1.0, 0, 0.0)):
        td = ts.dist_norm(torch.from_numpy(x), ts.SamplingConfig(*cfg))
        jd = js.dist_norm(jnp.asarray(x), js.SamplingConfig(*cfg))
        pad_t, pad_j = ts.dist_pad_zero_rows(td, 1), js.dist_pad_zero_rows(jd, 1)
        for n in (0, 3, 4):
            a = ts.dist_take(pad_t, torch.tensor(n))
            b = js.dist_take(pad_j, jnp.asarray(n))
            for u, v in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                np.testing.assert_allclose(u.float().numpy(), np.asarray(v, np.float32), atol=1e-7)
        cat_t, cat_j = ts.dist_concat([td, td]), js.dist_concat([jd, jd])
        for u, v in zip(cat_t if cfg[1] else (cat_t,), cat_j if cfg[1] else (cat_j,)):
            np.testing.assert_allclose(u.float().numpy(), np.asarray(v, np.float32), atol=1e-7)
        toks = np.array([1, 2, 3, 4])
        tp_ = ts.dist_prob_of(td, torch.from_numpy(toks))
        jp_ = js.dist_prob_of(jd, jnp.asarray(toks, jnp.int32))
        np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), atol=1e-7)


def test_sample_is_target_distributed_and_guards_zero_prob():
    probs = np.random.default_rng(6).dirichlet(np.ones(12) * 0.7).astype(np.float32)
    probs[3] = 0.0
    probs /= probs.sum()
    gen = torch.Generator().manual_seed(0)
    draws = ts.sample(gen, torch.from_numpy(np.tile(probs, (N, 1))))
    assert draws.dtype == torch.long and int((draws == 3).sum()) == 0
    assert _tv(draws.numpy(), probs) < TV_TOL
    onehot = torch.zeros(1, 12)
    onehot[0, 7] = 1.0
    assert int(ts.sample(gen, onehot)[0]) == 7


def test_sample_topk_is_target_distributed():
    x = _logits((1, 200), seed=7)
    cfg = ts.SamplingConfig(1.0, 20, 0.9)
    d = ts.norm_logits_topk(torch.from_numpy(np.tile(x, (N, 1))), cfg)
    draws = ts.sample_topk(torch.Generator().manual_seed(1), d)
    ref = np.asarray(js.norm_logits(jnp.asarray(x), js.SamplingConfig(1.0, 20, 0.9)))[0]
    assert _tv(draws.numpy(), ref) < TV_TOL
    # the JAX sampler on the same distribution lands on the same histogram
    jdraws = jax.vmap(lambda k: js.sample_topk(k, js.norm_logits_topk(jnp.asarray(x[0]), js.SamplingConfig(1.0, 20, 0.9))))(
        jax.random.split(jax.random.key(0), N))
    assert _tv(draws.numpy(), np.bincount(np.asarray(jdraws), minlength=200) / N) < 2 * TV_TOL


def test_sample_k_draws_without_replacement():
    probs = np.random.default_rng(8).dirichlet(np.ones(10)).astype(np.float32)
    gen = torch.Generator().manual_seed(2)
    out = ts.sample_k(gen, torch.from_numpy(np.tile(probs, (N, 1))), 3)
    assert out.shape == (N, 3)
    assert bool((out[:, 0] != out[:, 1]).all() and (out[:, 1] != out[:, 2]).all())
    assert _tv(out[:, 0].numpy(), probs) < TV_TOL  # the first draw is plain sampling
