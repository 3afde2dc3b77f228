"""The port's paged continuous-batching engine (``serve/paged.py``) against
the JAX ``PagedEngine(on_demand=False)``, the ports of
tests/test_paged_engine.py's engine tests, and the pieces under it: the
batched accept (``engine/speculative.py::accept_phase_rows``) and the
per-row random streams (``ops/sampling.py``).

* At top_k=1 both engines are deterministic (one-hot p and q), so the port
  must give JAX's output ids token for token; the pair's fp32 logits agree
  to 2e-4 (tests/test_torch_paged.py), far inside the greedy top-2 gaps.
* Accept decisions for the same p/q stacks and accept uniforms are compared
  exactly; the resample/bonus draw uses each side's own random bits.
* The row streams' uniforms are tested for their mean and spread (4e5
  draws: standard error of the mean 4.6e-4, a 5e-3 bound) and a sampler
  driven by them by a chi-square test at p > 1e-4.
"""

import collections

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine import speculative as jspec
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.ops import sampling as js
from llmspeculativesampling_tpu.serve.paged import PagedEngine as JEngine
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine import speculative as tspec
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.ops import sampling as ts
from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

from _torch_port import to_port

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
          num_kv_heads=4, max_position=2048, dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """tests/test_paged_engine.py's pair: a 2-layer target and its first
    layer as the draft, as JAX and as converted port params."""
    pt = jl.init_params(JCfg(**KW), jax.random.key(0))
    pd = {"embed": pt["embed"], "ln_final": pt["ln_final"], "lm_head": pt["lm_head"],
          "layers": jax.tree.map(lambda x: x[:1], pt["layers"])}
    return pd, pt, to_port(pd), to_port(pt)


def _engine(pair, kv_quant=False, **kw):
    _, _, tpd, tpt = pair
    kw.setdefault("batch_rows", 3)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("page", 32)
    kw.setdefault("max_pages_per_req", 8)
    kw.setdefault("max_new_cap", 64)
    kw.setdefault("gamma", 3)
    kw.setdefault("eos_token_id", -1)  # random weights: no natural EOS
    kw.setdefault("top_k", 10)
    kw.setdefault("top_p", 0.9)
    kw.setdefault("prompt_bucket", 32)
    return PagedEngine(TBundle("llama", TCfg(**{**KW, "num_layers": 1}), tl.forward), tpd,
                       TBundle("llama", TCfg(**KW), tl.forward), tpt, kv_quant=kv_quant,
                       device="cpu", **kw)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_outputs_equal_jax_engine(pair, kv_quant):
    """Five requests of different prompt lengths over three rows (so rows
    are reused), the same settings on both engines, top_k=1."""
    jpd, jpt, _, _ = pair
    kw = dict(batch_rows=3, num_blocks=24, page=32, max_pages_per_req=8, max_new_cap=64,
              gamma=3, eos_token_id=-1, top_k=1, top_p=0.9, prompt_bucket=32, kv_quant=kv_quant,
              steps_per_sync=2)
    prompts = [list(range(5 + i, 20 + 4 * i)) for i in range(5)]
    news = [12, 7, 16, 9, 12]
    je = JEngine(JBundle("llama", JCfg(**{**KW, "num_layers": 1}), jl.forward), jpd,
                 JBundle("llama", JCfg(**KW), jl.forward), jpt, on_demand=False, **kw)
    jr = [je.submit(p, n) for p, n in zip(prompts, news)]
    je.run_until_idle()
    te = _engine(pair, **kw)
    tr = [te.submit(p, n) for p, n in zip(prompts, news)]
    te.run_until_idle()
    for a, b in zip(jr, tr):
        jc, tc = je.result(a), te.result(b)
        np.testing.assert_array_equal(tc.output_ids, np.asarray(jc.output_ids))
        assert tc.details["acc_len"] == jc.details["acc_len"]
        assert set(tc.details) == set(jc.details)
    assert te.allocator.free_blocks == te.allocator.num_blocks


def test_single_request_completes(pair):
    eng = _engine(pair)
    rid = eng.submit(list(range(5, 25)), max_new_tokens=16)
    eng.run_until_idle()
    c = eng.result(rid)
    gen = len(c.output_ids) - c.prompt_len
    assert 16 <= gen <= 16 + eng.gamma
    assert (c.output_ids >= 0).all() and (c.output_ids < 128).all()
    assert sum(c.details["acc_len"]) == c.details["accepted_count"]
    assert 0.0 <= c.details["acc_rate"] <= 1.0
    assert eng.allocator.free_blocks == eng.allocator.num_blocks


def test_pool_pressure_queues_and_recycles(pair):
    eng = _engine(pair, batch_rows=3, num_blocks=8, page=32, max_pages_per_req=4)
    rng = np.random.default_rng(0)
    lens = (8, 12, 5, 9, 7, 6)
    rids = [eng.submit(rng.integers(2, 120, size=rng.integers(4, 30)).tolist(), int(n))
            for n in lens]
    eng.run_until_idle()
    assert eng.num_active == 0 and not eng._pending
    for rid, want in zip(rids, lens):
        c = eng.result(rid)
        assert want <= len(c.output_ids) - c.prompt_len <= want + eng.gamma
    assert eng.allocator.free_blocks == 8


def test_mixed_length_coexistence(pair):
    # one step per chunk: no short request can finish in the first step
    eng = _engine(pair, batch_rows=4, num_blocks=16, page=32, max_pages_per_req=8,
                  steps_per_sync=1)
    long_rid = eng.submit([2 + i % 120 for i in range(150)], max_new_tokens=40)  # 6 pages
    short = [eng.submit(list(range(3, 13)), max_new_tokens=8) for _ in range(3)]
    eng.step()
    assert eng.num_active == 4
    eng.run_until_idle()
    c = eng.result(long_rid)
    assert c is not None and len(c.output_ids) - c.prompt_len >= 40
    assert all(eng.result(rid) is not None for rid in short)


def test_burst_vs_trickle_determinism(pair):
    """Per-request streams are keyed by (seed, rid): the same request set
    gives the same outputs submitted at once or one per step."""
    eng = _engine(pair, seed=7)
    rids = [eng.submit(list(range(5 + i, 20 + i)), 10) for i in range(4)]
    eng.run_until_idle()
    burst = [eng.result(r).output_ids for r in rids]
    eng2 = _engine(pair, seed=7)
    rids2 = []
    for i in range(4):
        rids2.append(eng2.submit(list(range(5 + i, 20 + i)), 10))
        eng2.step()
    eng2.run_until_idle()
    for a, rid in zip(burst, rids2):
        np.testing.assert_array_equal(a, eng2.result(rid).output_ids)


def test_release_cadence_invariance(pair):
    """Rows left idle with a stale table between requests must not write
    into pages a newly admitted request reuses: outputs are the same whether
    requests are released at once or two at a time."""
    prompts = [list(range(5 + 7 * i, 15 + 7 * i + (i % 3))) for i in range(6)]

    def run(drip):
        eng = _engine(pair, batch_rows=4, num_blocks=16, page=16, max_pages_per_req=4,
                      max_new_cap=16, gamma=2, steps_per_sync=2, prompt_bucket=16, seed=7)
        if drip:
            q = collections.deque(enumerate(prompts))
            while q or eng.num_active or eng._pending:
                free = sum(r is None for r in eng._row_req)
                while q and free >= 2 and len(eng._pending) < 2:
                    i, p = q.popleft()
                    eng.submit_with_rid(i, np.asarray(p, np.int32), 12)
                    free -= 1
                eng.step()
        else:
            for i, p in enumerate(prompts):
                eng.submit_with_rid(i, np.asarray(p, np.int32), 12)
            eng.run_until_idle()
        return {r: eng.result(r).output_ids.tolist() for r in range(len(prompts))}

    assert run(False) == run(True)


def test_int8_paged_pool(pair):
    eng = _engine(pair, kv_quant=True)
    rids = [eng.submit(list(range(4, 24)), max_new_tokens=8) for _ in range(3)]
    eng.run_until_idle()
    for rid in rids:
        assert len(eng.result(rid).output_ids) - 20 >= 8


def test_partial_result_and_submit_checks(pair):
    eng = _engine(pair, steps_per_sync=1)
    rid = eng.submit(list(range(5, 25)), max_new_tokens=30)
    eng.step()
    part = eng.partial_result(rid)
    assert part is not None and 20 < len(part) <= 20 + eng.gamma + 1
    np.testing.assert_array_equal(part[:20], np.arange(5, 25))
    assert eng.partial_result(rid + 1) is None
    with pytest.raises(ValueError, match="at least 2"):
        eng.submit([1])
    with pytest.raises(ValueError, match="max pages"):
        eng.submit(list(range(250)), 10)


@pytest.mark.parametrize("option,value", [
    ("on_demand", True), ("prefix_cache", True), ("chunked_prefill", True),
    ("prefill_extra", 2), ("adaptive_gamma", (4, 8)), ("mesh", object()),
])
def test_later_options_raise(pair, option, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(pair, **{option: value})


def test_engine_defaults_to_the_card(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tpd, tpt = pair
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedEngine(TBundle("llama", TCfg(**{**KW, "num_layers": 1}), tl.forward), tpd,
                    TBundle("llama", TCfg(**KW), tl.forward), tpt)


# --------------------------------------------------------- accept, streams

@pytest.mark.parametrize("top_k", [20, 0])
def test_accept_rows_decisions_match_jax(top_k):
    """Four rows at different cur_len, each with its own p/q stacks and
    accept uniforms: the batched accept against JAX's accept_phase per row."""
    gamma, vocab, b = 4, 40, 4
    rng = np.random.default_rng(top_k)
    ql = rng.standard_normal((b, gamma, vocab)).astype(np.float32) * 2
    pl = np.concatenate([ql, rng.standard_normal((b, 1, vocab)).astype(np.float32)], axis=1)
    pl = pl + rng.standard_normal(pl.shape).astype(np.float32) * np.asarray(
        [0.3, 3.0, 0.3, 1.0], np.float32)[:, None, None]
    jcfg, tcfg = js.SamplingConfig(1.0, top_k, 0.9), ts.SamplingConfig(1.0, top_k, 0.9)
    order = np.argsort(ql, axis=-1)  # drafts: the top token, or the runner-up
    drafts = np.asarray([[order[i, j, -1 - j % 2] for j in range(gamma)] for i in range(b)],
                        np.int32)
    r = rng.random((b, gamma)).astype(np.float32)
    cur = np.asarray([10, 3, 17, 8])
    tq = ts.dist_norm(torch.from_numpy(ql), tcfg)
    tp = ts.dist_norm(torch.from_numpy(pl), tcfg)
    u_t, _ = ts.row_uniform(ts.row_keys(0, range(b)), ts.dist_width(tp))
    tokens = torch.zeros((b, 32), dtype=torch.long)
    out = tspec.accept_phase_rows(gamma, tokens, torch.from_numpy(cur), tq,
                                  torch.from_numpy(drafts).long(), tp, torch.from_numpy(r), u_t)
    _, t_len, t_t, t_n, t_all, t_rate = out
    for i in range(b):
        jq = js.dist_norm(jnp.asarray(ql[i]), jcfg)
        jp = js.dist_norm(jnp.asarray(pl[i]), jcfg)
        _, j_len, _, j_n, j_all, j_rate, _ = jspec.accept_phase(
            jcfg, gamma, -1, jnp.zeros((1, 32), jnp.int32), jnp.asarray(int(cur[i])), jq,
            jnp.asarray(drafts[i]), jp, jax.random.key(0), jnp.asarray(r[i]))
        assert int(t_n[i]) == int(j_n) and int(t_len[i]) == int(j_len)
        assert bool(t_all[i]) == bool(j_all)
        np.testing.assert_allclose(float(t_rate[i]), float(j_rate), rtol=1e-6)
        assert int(tokens[i, int(t_len[i]) - 1]) == int(t_t[i])
    assert bool(t_all.any()) and not bool(t_all.all())  # bonus and resample both exercised


def test_row_streams_are_independent_of_their_batch():
    keys = ts.row_keys(5, [3, 11, 42])
    u_all, k2 = ts.row_uniform(keys, 64)
    u_one, _ = ts.row_uniform(ts.row_keys(5, [11]), 64)
    assert torch.equal(u_all[1], u_one[0])
    assert torch.equal(k2[:, 1], torch.ones(3, dtype=torch.long))
    u_next, _ = ts.row_uniform(k2, 64)
    assert not torch.equal(u_next, u_all)  # the counter moves the stream
    assert not torch.equal(ts.row_uniform(ts.row_keys(6, [11]), 64)[0], u_one)  # seed matters
    assert bool(((u_all > 0) & (u_all < 1)).all())


def test_row_stream_uniforms_and_draws_are_fair():
    keys = ts.row_keys(0, range(100))
    us = []
    for _ in range(4):
        u, keys = ts.row_uniform(keys, 1000)
        us.append(u)
    u = torch.cat(us).double()
    assert abs(float(u.mean()) - 0.5) < 5e-3 and abs(float(u.var()) - 1 / 12) < 2e-3
    probs = torch.tensor([0.5, 0.25, 0.15, 0.1]).expand(4000, 4)
    draws = ts.sample_u(probs, ts.row_uniform(ts.row_keys(1, range(4000)), 4)[0])
    counts = np.bincount(draws.numpy(), minlength=4)
    expected = probs[0].numpy() * 4000
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 21.1, (counts, chi2)  # 3 degrees of freedom, p = 1e-4
