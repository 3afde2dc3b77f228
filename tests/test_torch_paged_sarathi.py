"""SARATHI chunked prefill and the adaptive-gamma controller of the port's
paged engine (``serve/paged.py``) against the JAX package's, on
tests/test_torch_paged_cache_mgmt.py's tiny pair.

* One step with a row still prefilling: fp32 pools within 1e-4 (the same
  fp32 math in other orders); lengths, tokens and ``prefill_to`` exactly,
  at top_k=1, where both packages are deterministic.
* Engines at top_k=1 must give JAX's ids; in fp32 a piggybacked cold
  prompt must give the monolithic engine's ids at top_k=10 too (its stream
  key is frozen through its prefill).
* The controller is the same host arithmetic in both packages: the same
  scripted trace, under one patched clock, must give the same arms,
  phases, rates and ``adaptive_stats()``.
"""

import time

import numpy as np
import jax
import pytest
import torch

from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.serve import paged as jengine
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.serve import paged as tengine

from _torch_port import one_thread, rel_err, to_np, to_port  # noqa: F401

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
          num_kv_heads=4, max_position=2048, dtype="float32")
# tests/test_paged_engine.py's SARATHI settings: a 20-token request decodes
# while a 120-token cold prompt is admitted (JAX's ids 30-149 pass the
# vocabulary, which its gather clamps and PyTorch's refuses: ids 4-123 here)
SARATHI = dict(batch_rows=2, num_blocks=24, page=32, max_pages_per_req=8, max_new_cap=64,
               gamma=3, steps_per_sync=1, extend_chunk=16, seed=5)
SHORT, LONG = list(range(5, 25)), list(range(4, 124))


@pytest.fixture(scope="module")
def pair():
    """A 2-layer target and its first layer as the draft, as JAX params and
    as port params."""
    pt = jl.init_params(JCfg(**KW), jax.random.key(0))
    pd = {"embed": pt["embed"], "ln_final": pt["ln_final"], "lm_head": pt["lm_head"],
          "layers": jax.tree.map(lambda x: x[:1], pt["layers"])}
    return pd, pt, to_port(pd), to_port(pt)


def _kw(**kw):
    """tests/test_paged_engine.py::_engine's defaults."""
    base = dict(batch_rows=3, num_blocks=24, page=32, max_pages_per_req=8, max_new_cap=64,
                gamma=3, eos_token_id=-1, top_k=10, top_p=0.9, prompt_bucket=32)
    return {**base, **kw}


def _engine(pair, **kw):
    _, _, tpd, tpt = pair
    return tengine.PagedEngine(TBundle("llama", TCfg(**{**KW, "num_layers": 1}), tl.forward), tpd,
                               TBundle("llama", TCfg(**KW), tl.forward), tpt, device="cpu",
                               **_kw(**kw))


def _jax_engine(pair, **kw):
    jpd, jpt, _, _ = pair
    return jengine.PagedEngine(JBundle("llama", JCfg(**{**KW, "num_layers": 1}), jl.forward), jpd,
                               JBundle("llama", JCfg(**KW), jl.forward), jpt, **_kw(**kw))


def _short_then_long(eng, long_new=16):
    """The short request decodes one chunk, then the long one arrives;
    drained. Returns (short, long) completions."""
    r_short = eng.submit(SHORT, max_new_tokens=48)
    eng.step()
    r_long = eng.submit(LONG, max_new_tokens=long_new)
    eng.run_until_idle()
    return eng.result(r_short), eng.result(r_long)


# ------------------------------------------------------------------ the step

@pytest.mark.parametrize("extra", [0, 8])
def test_prefilling_step_matches_jax(pair, extra):
    """Both engines admit the short request, decode a chunk, then stage the
    120-token prompt (draft-only windows, cur_len 1, prefill_to 120); one
    ``_paged_spec_step`` on each state: the pools, lengths, tokens and
    prefill_to agree, the prefilling row's stream key is unchanged, and its
    draft table is gated for the step only."""
    kw = dict(SARATHI, chunked_prefill=True, prefill_extra=extra, top_k=1)
    engines = []
    for make in (_jax_engine, _engine):
        eng = make(pair, **kw)
        eng.submit(SHORT, max_new_tokens=48)
        eng.step()
        eng.submit(LONG, max_new_tokens=16)
        eng._admit()
        eng._ensure_runway()
        eng._flush_maintenance()
        engines.append(eng)
    je, te = engines
    assert je._n_prefilling() == te._n_prefilling() == 1
    js, ts = je.state, te.state
    np.testing.assert_array_equal(to_np(ts.prefill_to), [len(SHORT), len(LONG)])
    np.testing.assert_array_equal(to_np(ts.cur_len), to_np(js.cur_len))
    key_before = ts.key.clone()
    tables_before = ts.draft_cache.block_tables.clone()
    jb_d, jb_t, tb_d, tb_t = je.bundle_d, je.bundle_t, te.bundle_d, te.bundle_t
    js = jengine._paged_spec_step(jb_d, jb_t, je.params_d, je.params_t, je.scfg, 3, -1, js, extra)
    ts = tengine._paged_spec_step(tb_d, tb_t, te.params_d, te.params_t, te.scfg, 3, -1, ts, extra)
    np.testing.assert_array_equal(to_np(ts.cur_len), to_np(js.cur_len))
    assert int(ts.cur_len[1]) == 1 + 3 + extra  # gamma + extra prompt tokens a step
    np.testing.assert_array_equal(to_np(ts.tokens), to_np(js.tokens))
    np.testing.assert_array_equal(to_np(ts.prefill_to), to_np(js.prefill_to))
    np.testing.assert_array_equal(to_np(ts.steps), [2, 0])  # the prefilling row records nothing
    np.testing.assert_array_equal(to_np(ts.steps), to_np(js.steps))
    np.testing.assert_array_equal(to_np(ts.accepted), to_np(js.accepted))
    assert torch.equal(ts.key[1], key_before[1]) and not torch.equal(ts.key[0], key_before[0])
    assert torch.equal(ts.draft_cache.block_tables, tables_before)
    n = je.allocator.num_blocks
    for name in ("draft_cache", "target_cache"):
        for field in ("k", "v"):
            got = to_np(getattr(getattr(ts, name), field))[:, :n]
            ref = to_np(getattr(getattr(js, name), field))[:, :n]
            assert rel_err(got, ref) < 1e-4, (name, field)


# ------------------------------------------------------------ engine mirrors

def test_chunked_prefill_interleaves_and_matches(pair):
    """tests/test_paged_engine.py:490: the cold prompt rides the decode
    chunks (at least 3 of them), every id equals the monolithic engine's,
    also with prefill_extra 8, which needs fewer chunks."""
    runs = {}
    for flag, extra in ((False, 0), (True, 0), (True, 8)):
        eng = _engine(pair, **SARATHI, chunked_prefill=flag, prefill_extra=extra)
        short, long_ = _short_then_long(eng)
        runs[flag, extra] = (eng, short.output_ids.tolist(), long_.output_ids.tolist())
        assert eng.allocator.free_blocks == 24
    mono, chunked, wide = runs[False, 0], runs[True, 0], runs[True, 8]
    assert mono[0].interleaved_chunks == 0 and chunked[0].interleaved_chunks >= 3
    assert 0 < wide[0].interleaved_chunks < chunked[0].interleaved_chunks
    assert chunked[1:] == mono[1:] and wide[1:] == mono[1:]


@pytest.mark.parametrize("extra", [0, 8])
def test_greedy_ids_equal_jax_with_chunked_prefill(pair, extra):
    out = []
    for make in (_jax_engine, _engine):
        eng = make(pair, **SARATHI, chunked_prefill=True, prefill_extra=extra, top_k=1)
        short, long_ = _short_then_long(eng)
        assert eng.interleaved_chunks >= 2
        out.append((np.asarray(short.output_ids).tolist(), np.asarray(long_.output_ids).tolist()))
    assert out[1] == out[0]


def test_staged_prefix_pages_register_only_after_prefill(pair):
    """tests/test_paged_engine.py:765: a staged prompt's pages are not
    registered, and its TTFT not stamped, while its prefill runs; then they
    are, and a later request hitting them gives a cold engine's ids."""
    kw = dict(SARATHI, chunked_prefill=True, prefix_cache=True)
    eng = _engine(pair, **kw)
    r_short = eng.submit(SHORT, max_new_tokens=48)
    eng.step()
    hashes = tengine.prompt_page_hashes(np.asarray(LONG, np.int32), eng.page)
    assert len(hashes) >= 3
    r_long = eng.submit(LONG, max_new_tokens=16)
    saw = False
    for _ in range(300):
        eng.step()
        if eng._n_prefilling():
            saw = True
            assert not any(h in eng.allocator._by_hash for h in hashes)
            row = next(i for i, r in enumerate(eng._row_req) if r is not None and r.rid == r_long)
            assert eng._row_req[row].prefill_time is None
        elif saw and not eng._pending:
            break
    assert saw
    eng.run_until_idle()
    assert eng.result(r_short) is not None and eng.result(r_long).details["ttft_s"] > 0
    assert all(h in eng.allocator._by_hash for h in hashes)
    eng.submit_with_rid(r_long, LONG, 16)  # the cold engine's rid: the same stream
    eng.run_until_idle()
    hit = eng.result(r_long)
    assert hit.details["prefix_cached_tokens"] > 0
    cold = _engine(pair, **kw)
    _, cold_long = _short_then_long(cold)
    assert hit.output_ids.tolist() == cold_long.output_ids.tolist()


def test_drain_never_publishes_staged_pages_and_work_resumes(pair):
    """tests/test_paged_engine.py:824: draining mid-prefill drops the staged
    row's pending registration and frees every page; the drained requests,
    put back with ``submit_request``, give the undrained run's ids (the
    decoding row resumes from its snapshot, the staged one restarts)."""
    kw = dict(SARATHI, chunked_prefill=True, prefix_cache=True)
    eng = _engine(pair, **kw)
    r_short = eng.submit(SHORT, max_new_tokens=48)
    eng.step()
    r_long = eng.submit(LONG, max_new_tokens=16)
    for _ in range(3):
        eng.step()
    assert eng._n_prefilling() > 0
    drained = eng.drain_requests()
    hashes = tengine.prompt_page_hashes(np.asarray(LONG, np.int32), eng.page)
    assert not eng._pending_reg and not any(h in eng.allocator._by_hash for h in hashes)
    assert eng.allocator.free_blocks == eng.allocator.num_blocks and not eng._pending
    assert sorted(r.rid for r in drained) == [r_short, r_long]
    for req in drained:
        eng.submit_request(req)
    eng.run_until_idle()
    ref = _engine(pair, **kw)
    short, long_ = _short_then_long(ref)
    assert eng.result(r_short).output_ids.tolist() == short.output_ids.tolist()
    assert eng.result(r_long).output_ids.tolist() == long_.output_ids.tolist()


def test_warmup_runs_the_piggyback_path(pair):
    """tests/test_paged_engine.py:848: the parked request outlives a chunk,
    so the warm-up's long prompt is staged; nothing is left behind."""
    eng = _engine(pair, **SARATHI, chunked_prefill=True)
    eng.warmup()
    assert eng.interleaved_chunks > 0
    assert eng.num_active == 0 and not eng._pending and not eng.completions
    assert eng._next_rid == 0 and eng.allocator.free_blocks == eng.allocator.num_blocks


def test_warmup_leaves_controller_pristine(pair):
    """tests/test_paged_engine.py:696: warm-up completions close epochs; the
    controller is reset after all of them."""
    eng = _engine(pair, gamma=4, adaptive_gamma=(2, 4, 8))
    eng.warmup(prompt_lens=(8,))
    assert eng._ep_phase == "ramp" and eng.gamma == 2
    assert eng._ep_rate == {} and eng._ep_history == [] and eng._arm_rate == {}
    assert eng._ramp_chunks == 0 and eng._ep_completions == 0 and eng._ep_tokens == 0
    assert not eng._resync and eng._next_rid == 0 and eng._last_fetch_t is None
    assert eng.adaptive_stats()["mode"] == "epoch"


# -------------------------------------------------------------- controller

def _drive(eng, kind, *args):
    """One controller event on either package's engine."""
    if kind == "dispatch":  # the chunk body is stubbed: (gamma, live rows)
        eng._dispatch_chunk()
        return eng._chunk_log.popleft() if hasattr(eng, "_chunk_log") else eng._chunk_arm
    if kind == "feed":
        eng._update_gamma(*args)
    elif kind == "complete":
        tokens, completions = args
        eng._ep_tokens += tokens
        eng._ep_completions += completions
    elif kind == "tick":
        eng._epoch_tick()
    elif kind == "reset":
        eng._epoch_reset()
    elif kind == "admit":  # the hold after an arm switch: held, then cleared
        eng._pending.extend([object()] * 8)
        eng._admit()
        held = eng._resync
        eng._pending.clear()
        eng._row_req[0] = None
        eng._admit()
        eng._row_req[0] = object()
        return held
    return None


def _state(eng):
    return (eng.gamma, eng._ep_phase, dict(eng._arm_rate), dict(eng._ep_rate), eng._acc_ema,
            eng._resync, eng._ep_count, eng._chunk_count, eng._ep_incumbent, eng._best_wall_pc)


@pytest.mark.parametrize("mode", ["chunk", "epoch"])
def test_controller_trace_matches_jax(pair, mode, monkeypatch):
    """A scripted trace of 160 chunks (per-arm acceptance and chunk walls,
    completions whose tokens depend on the arm, epoch ticks, idle resets,
    admission holds) into both engines' controllers under one patched
    clock: the same dispatched arms, phases, rates and stats after every
    event."""
    clock = [1000.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    monkeypatch.setattr(jengine, "_paged_chunk", lambda *a, **k: (a[2], None))
    monkeypatch.setattr(tengine, "_paged_chunk_body", lambda *a, **k: (a[2], None))
    kw = dict(batch_rows=4, num_blocks=16, page=32, max_pages_per_req=4, max_new_cap=32, gamma=4,
              adaptive_gamma=(2, 4, 8), adaptive_gamma_mode=mode)
    je, te = _jax_engine(pair, **kw), _engine(pair, **kw)
    for eng in (je, te):
        eng._row_req[0] = object()  # one busy row: epochs open
    assert _state(je) == _state(te)
    rng = np.random.default_rng(11)
    accept = {2: 0.9, 4: 0.8, 8: 0.6}   # per-token acceptance of each arm
    per_req = {2: 30, 4: 44, 8: 26}     # tokens a completion brings under each arm
    seen, phases = [], set()
    for i in range(160):
        gj, gt = _drive(je, "dispatch"), _drive(te, "dispatch")
        assert gj == gt, i
        g = gj[0]
        seen.append(g)
        dt = float(rng.uniform(0.05, 0.4))
        clock[0] += dt
        steps = float(rng.integers(1, 9))
        acc = steps * g * accept[g] * float(rng.uniform(0.8, 1.0))
        wall = None if i % 23 == 0 else dt
        events = [("feed", acc, steps, g, wall)]
        if rng.random() < 0.6:
            n = int(rng.integers(1, 3))
            events.append(("complete", n * per_req[g], n))
        events.append(("tick",))
        for kind, *args in events:
            assert _drive(je, kind, *args) == _drive(te, kind, *args)
            assert _state(je) == _state(te), (i, kind)
        if je._resync:
            assert _drive(je, "admit") == _drive(te, "admit") is True
        if i % 41 == 40:
            _drive(je, "reset")
            _drive(te, "reset")
        assert _state(je) == _state(te), i
        phases.add(te._ep_phase)
    assert je.adaptive_stats() == te.adaptive_stats()
    assert set(seen) == {2, 4, 8}
    if mode == "epoch":
        assert {"explore", "exploit"} <= phases and te._ep_count >= 16
        assert any(h["phase"] == "probe" for h in te._ep_history)
        assert any(h["capped"] for h in te._ep_history)


def test_adaptive_greedy_ids_equal_fixed_and_jax(pair):
    """At top_k=1 the output is the target's greedy continuation whatever
    the draft depth: an adaptive run (epoch mode, the ramp rotating every
    arm) gives a fixed-gamma run's ids and JAX's adaptive run's, up to each
    request's budget; its acc_rate divides by the drafts it made."""
    kw = dict(batch_rows=3, top_k=1, steps_per_sync=2)
    prompts = [list(range(5 + i, 25 + 2 * i)) for i in range(6)]
    ids = {}
    for name, make, extra in (("jax", _jax_engine, dict(adaptive_gamma=(2, 4, 8))),
                              ("port", _engine, dict(adaptive_gamma=(2, 4, 8))),
                              ("fixed", _engine, {})):
        eng = make(pair, **kw, **extra)
        rids = [eng.submit(p, 20) for p in prompts]
        eng.run_until_idle()
        comps = [eng.result(r) for r in rids]
        ids[name] = [np.asarray(c.output_ids)[:len(p) + 20].tolist()
                     for c, p in zip(comps, prompts)]
        if name == "port":
            assert set(eng._arm_rate) == {2, 4, 8}  # the ramp ran every arm
            assert all(0.0 < c.details["acc_rate"] <= 1.0 for c in comps)
            assert eng.allocator.free_blocks == eng.allocator.num_blocks
    assert ids["port"] == ids["fixed"] == ids["jax"]
