"""The paged engine's cache management against the JAX package: on-demand
paging with recompute preemption, and the prefix cache with its extend
windows (``cache/paged.py::prompt_page_hashes``, ``SharedPageAllocator``;
``serve/paged.py``), on tests/test_torch_paged_engine.py's tiny pair.

* Hashes and allocator state are compared exactly.
* The extend forward's pools: fp32 within 1e-4 (the same fp32 math in other
  orders); the int8 pool within 3e-2, the paged forward's own tolerance:
  JAX's CPU forward reads the window back through the int8 pool where the
  port's decode path attends to it unquantized (ROADMAP C).
* Engines at top_k=1 are deterministic, so the port must give JAX's ids.
* A preempted request resumes with its evolved stream key; in fp32 on the
  CPU the replay gives the unpreempted run's ids.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.cache import paged as jpaged
from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.serve import paged as jengine
from llmspeculativesampling_tpu_torch.cache import paged as tpaged
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.serve import paged as tengine

from _torch_port import one_thread, rel_err, to_np, to_port  # noqa: F401

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
          num_kv_heads=4, max_position=2048, dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """tests/test_paged_engine.py's pair (a 2-layer target, its first layer
    as the draft), as JAX params and as port params."""
    pt = jl.init_params(JCfg(**KW), jax.random.key(0))
    pd = {"embed": pt["embed"], "ln_final": pt["ln_final"], "lm_head": pt["lm_head"],
          "layers": jax.tree.map(lambda x: x[:1], pt["layers"])}
    return pd, pt, to_port(pd), to_port(pt)


def _bundles(kv_quant=False):
    return (JBundle("llama", JCfg(**{**KW, "num_layers": 1}), jl.forward),
            JBundle("llama", JCfg(**KW), jl.forward, kv_quant=kv_quant),
            TBundle("llama", TCfg(**{**KW, "num_layers": 1}), tl.forward),
            TBundle("llama", TCfg(**KW), tl.forward, kv_quant=kv_quant))


def _kw(**kw):
    """tests/test_paged_engine.py::_engine's defaults."""
    base = dict(batch_rows=3, num_blocks=24, page=32, max_pages_per_req=8, max_new_cap=64,
                gamma=3, eos_token_id=-1, top_k=10, top_p=0.9, prompt_bucket=32)
    return {**base, **kw}


def _engine(pair, kv_quant=False, **kw):
    _, _, tpd, tpt = pair
    _, _, bd, bt = _bundles(kv_quant)
    return tengine.PagedEngine(bd, tpd, bt, tpt, kv_quant=kv_quant, device="cpu", **_kw(**kw))


def _jax_engine(pair, kv_quant=False, **kw):
    jpd, jpt, _, _ = pair
    bd, bt, _, _ = _bundles(kv_quant)
    return jengine.PagedEngine(bd, jpd, bt, jpt, kv_quant=kv_quant, **_kw(**kw))


# ------------------------------------------------------------- host side

PROMPTS = [np.random.default_rng(i).integers(0, 30000, n).tolist()
           for i, n in enumerate((3, 18, 41, 70))]


@pytest.mark.parametrize("reserve_tail", [0, 2])
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("prompt", range(len(PROMPTS)))
def test_prompt_page_hashes_equal_jax(prompt, page, reserve_tail):
    ids = PROMPTS[prompt]
    got = tpaged.prompt_page_hashes(ids, page, reserve_tail)
    assert got == jpaged.prompt_page_hashes(ids, page, reserve_tail)
    assert len(got) == max(len(ids) - reserve_tail, 0) // page


def test_shared_allocator_script_matches_jax():
    """tests/test_paged_engine.py's allocator script (chain lookup, sharing,
    a diverging prompt, parking on free, eviction under pressure), run
    through both packages: the same blocks, refcounts, hit and miss counts
    and capacity after every operation."""
    allocs = [jpaged.SharedPageAllocator(6, 4, 6), tpaged.SharedPageAllocator(6, 4, 6)]
    prompt = list(range(10, 24))
    diverged = list(prompt)
    diverged[6] = 99  # breaks the chain after page 0
    held = {}

    def run(op, *args):
        outs = []
        for a, mod in zip(allocs, (jpaged, tpaged)):
            if op == "alloc_shared":
                total, ids = args
                outs.append(a.alloc_shared(total, mod.prompt_page_hashes(ids, 4)))
            elif op == "register":
                ids, key = args
                hashes = mod.prompt_page_hashes(ids, 4)
                outs.append(a.register(hashes, held[key][0][:len(hashes)]))
            elif op == "free":
                outs.append(a.free(held[args[0]][0]))
            elif op == "lookup":
                outs.append(a.lookup(mod.prompt_page_hashes(args[0], 4)))
            else:
                outs.append(getattr(a, op)())
        assert outs[0] == outs[1], (op, outs)
        j, t = allocs
        assert (j._ref, j.hits, j.misses, j.available_blocks, j.free_blocks) == \
            (t._ref, t.hits, t.misses, t.available_blocks, t.free_blocks), op
        assert list(j._evictable) == list(t._evictable)
        return outs[1]

    held["a"] = run("alloc_shared", 16, prompt)
    run("register", prompt, "a")
    held["b"] = run("alloc_shared", 16, prompt)
    assert held["b"][1] == 12 and held["b"][0][:3] == held["a"][0][:3]
    held["c"] = run("alloc_shared", 8, diverged)
    assert held["c"][1] == 4
    run("free", "a")
    run("free", "b")
    assert allocs[1].available_blocks > allocs[1].free_blocks  # parked, not freed
    run("free", "c")
    assert run("lookup", prompt) == held["a"][0][:3]
    held["d"] = run("alloc_shared", 24, [])  # six pages: evicts the parked ones
    assert len(held["d"][0]) == 6 and run("lookup", prompt) == []
    assert run("alloc_one") is None
    run("free", "d")
    assert run("alloc_one") is not None
    assert allocs[1].available_blocks == 5


# ---------------------------------------------------------- extend forward

N_BLOCKS, PAGE, MAX_PAGES = 12, 16, 6


def _state_pair(bd_t, quant, tables):
    """JAX and port batch states whose caches alone are set: pools of
    ``N_BLOCKS`` pages and the given per-row tables."""
    def caches(init, cfg, dtype, **kw):
        return init(cfg.num_layers, N_BLOCKS, cfg.num_kv_heads, PAGE, cfg.head_dim,
                    batch=len(tables), max_pages=MAX_PAGES, dtype=dtype, quant=quant, **kw)

    jb_d, jb_t, tb_d, tb_t = bd_t
    jstate = jengine.PagedBatchState(*[None] * len(jengine.PagedBatchState._fields))._replace(
        draft_cache=caches(jpaged.init_paged_cache, jb_d.cfg, jnp.float32),
        target_cache=caches(jpaged.init_paged_cache, jb_t.cfg, jnp.float32))
    tstate = tengine.PagedBatchState(
        *[None] * len(dataclasses.fields(tengine.PagedBatchState)))
    tstate.draft_cache = caches(tpaged.init_paged_cache, tb_d.cfg, torch.float32, device="cpu")
    tstate.target_cache = caches(tpaged.init_paged_cache, tb_t.cfg, torch.float32, device="cpu")
    return jstate, tstate


def _pools(cache):
    """Each layer's pool values [L, N, H, page, D] as fp32 numpy (int8 pools
    dequantized), the trash block left out."""
    if hasattr(cache, "k_q"):
        return [to_np(q)[:, :N_BLOCKS].astype(np.float32) * to_np(s)[:, :N_BLOCKS, ..., None]
                for q, s in ((cache.k_q, cache.k_s), (cache.v_q, cache.v_s))]
    return [to_np(cache.k)[:, :N_BLOCKS], to_np(cache.v)[:, :N_BLOCKS]]


@pytest.mark.parametrize("quant", [False, True])
def test_extend_body_matches_jax(pair, quant):
    """A 32-token shared prefix (two pages) prefilled once, then three rows
    admitted as prefix hits over it with suffixes of 29, 6 and 40 tokens, in
    16-token windows through both packages' ``_paged_extend_body``: row 1 is
    exhausted after its first window (sentinel table), row 0's last window
    is padded. The pools must agree, and the shared pages keep their bytes."""
    jpd, jpt, tpd, tpt = pair
    bundles = _bundles(quant)
    jb_d, jb_t, tb_d, tb_t = bundles
    shared = [3, 7]
    own = [[0, 5], [9], [1, 4, 11]]
    tables = np.full((3, MAX_PAGES), N_BLOCKS, np.int32)
    for r, blocks in enumerate(own):
        tables[r, :2 + len(blocks)] = shared + blocks
    jstate, tstate = _state_pair(bundles, quant, tables)
    rng = np.random.default_rng(2)
    prefix = rng.integers(1, 120, (1, 32))
    pre_tab = np.full((1, MAX_PAGES), N_BLOCKS, np.int32)
    pre_tab[0, :2] = shared
    for bundle, params, name in ((jb_d, jpd, "draft_cache"), (jb_t, jpt, "target_cache")):
        cache = getattr(jstate, name)
        view = dataclasses.replace(cache, block_tables=jnp.asarray(pre_tab),
                                   lengths=jnp.zeros((1,), jnp.int32))
        _, after = bundle.forward(params, bundle.cfg, jnp.asarray(prefix, jnp.int32), view,
                                  paged_prefill=True)
        jstate = jstate._replace(**{name: jengine._transplant(cache, after)})
    for bundle, params, cache in ((tb_d, tpd, tstate.draft_cache),
                                  (tb_t, tpt, tstate.target_cache)):
        view = dataclasses.replace(cache, block_tables=torch.from_numpy(pre_tab),
                                   lengths=torch.zeros((1,), dtype=torch.int32))
        bundle.forward(params, bundle.cfg, torch.from_numpy(prefix), view, paged_prefill=True)
    before = [p[:, shared].copy() for c in (tstate.draft_cache, tstate.target_cache)
              for p in _pools(c)]

    p_lens = np.asarray([32 + 29, 32 + 6, 32 + 40])
    suffix = rng.integers(1, 120, (3, 40))
    w = 16
    for j in range(3):
        lens_now = 32 + j * w
        live = lens_now < p_lens
        window = np.zeros((3, w), np.int64)
        for r in np.nonzero(live)[0]:
            take = min(w, int(p_lens[r]) - lens_now)
            window[r, :take] = suffix[r, j * w:j * w + take]
        tabs = np.where(live[:, None], tables, N_BLOCKS).astype(np.int32)
        lens = np.where(live, lens_now, 0).astype(np.int32)
        jstate = jengine._paged_extend_body(
            jpd, jpt, jstate, jnp.asarray(tabs), jnp.asarray(lens), jnp.asarray(window, jnp.int32),
            bundle_d=jb_d, bundle_t=jb_t)
        tstate = tengine._paged_extend_body(
            tpd, tpt, tstate, torch.from_numpy(tabs), torch.from_numpy(lens),
            torch.from_numpy(window), bundle_d=tb_d, bundle_t=tb_t)
    tol = 3e-2 if quant else 1e-4
    written = shared + [b for blocks in own for b in blocks]
    for name in ("draft_cache", "target_cache"):
        for tp, jp in zip(_pools(getattr(tstate, name)), _pools(getattr(jstate, name))):
            assert np.abs(jp[:, written]).max() > 0
            assert rel_err(tp[:, written], jp[:, written]) < tol, name
            unused = [b for b in range(N_BLOCKS) if b not in written]
            assert not tp[:, unused].any(), "an exhausted row wrote outside the trash block"
    after = [p[:, shared] for c in (tstate.draft_cache, tstate.target_cache) for p in _pools(c)]
    for a, b in zip(after, before):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ engine mirrors

def test_prefix_cache_engine_reuses_pages(pair):
    """tests/test_paged_engine.py:223: an identical second prompt reports
    its cached pages and decodes; a distinct prompt does not hit."""
    eng = _engine(pair, prefix_cache=True)
    prompt = list(range(5, 75))  # 70 tokens: two shareable 32-pages
    r1 = eng.submit(prompt, max_new_tokens=8)
    eng.run_until_idle()
    assert eng.result(r1).details["prefix_cached_tokens"] == 0
    r2 = eng.submit(prompt, max_new_tokens=8)
    eng.run_until_idle()
    c2 = eng.result(r2)
    assert c2.details["prefix_cached_tokens"] == 64
    assert len(c2.output_ids) - c2.prompt_len >= 8
    np.testing.assert_array_equal(c2.output_ids[:70], prompt)
    r3 = eng.submit([(200 + i) % 128 for i in range(70)], max_new_tokens=6)
    eng.run_until_idle()
    assert eng.result(r3).details["prefix_cached_tokens"] == 0
    assert eng.allocator.available_blocks == 24


def test_prefix_cache_matches_uncached_output(pair):
    """tests/test_paged_engine.py:250: the same seed and submissions give
    the same ids with and without the cache (shared pages hold the same
    KV; the suffix's agrees within float tolerance)."""
    outs = {}
    for pc in (False, True):
        eng = _engine(pair, prefix_cache=pc, seed=11, batch_rows=2)
        rids = []
        for _ in range(2):  # one after the other: the second hits with the cache
            rids.append(eng.submit(list(range(7, 77)), max_new_tokens=10))
            eng.run_until_idle()
        outs[pc] = [eng.result(r).output_ids.tolist() for r in rids]
        if pc:
            assert eng.allocator.hits > 0
    assert outs[False] == outs[True]


def test_prefix_cache_concurrent_sharing_and_recycle(pair):
    """tests/test_paged_engine.py:272: three concurrent requests share one
    hot prefix; every page ends free or parked."""
    eng = _engine(pair, prefix_cache=True, batch_rows=4, num_blocks=12)
    sys_prompt = list(range(3, 69))  # two shareable pages
    r0 = eng.submit(sys_prompt + [1, 2], max_new_tokens=4)
    eng.run_until_idle()
    assert eng.result(r0) is not None
    rids = [eng.submit(sys_prompt + [50 + i, 60 + i], max_new_tokens=4) for i in range(3)]
    eng.run_until_idle()
    for rid in rids:
        assert eng.result(rid).details["prefix_cached_tokens"] == 64
    assert eng.allocator.available_blocks == 12


def test_on_demand_admits_deeper_than_worst_case(pair):
    """tests/test_paged_engine.py:414: a pool that worst-case reservation
    admits one request into runs three on demand at overcommit 2."""
    kw = dict(batch_rows=3, num_blocks=9, page=16, max_pages_per_req=8, steps_per_sync=1)
    legacy = _engine(pair, on_demand=False, **kw)
    for _ in range(3):
        legacy.submit(list(range(5, 25)), max_new_tokens=60)
    legacy._admit()
    assert legacy.num_active == 1  # 20 + 60 + 3 + 1 = 84 positions: 6 of 9 pages
    eng = _engine(pair, on_demand=True, overcommit=2.0, **kw)
    rids = [eng.submit(list(range(5, 25)), max_new_tokens=60) for _ in range(3)]
    eng._admit()
    assert eng.num_active == 3
    eng.run_until_idle()
    for rid in rids:
        assert eng.result(rid).details["tokens_generated"] >= 60
    assert eng.allocator.free_blocks == 9


def test_preemption_replays_the_unpreempted_run(pair):
    """tests/test_paged_engine.py:442: the pool runs out, the youngest row
    is preempted and resumed from its committed tokens and evolved stream
    key; every request's ids, lengths and merged counters equal those of a
    run that never preempts."""
    prompts = [list(range(5 + 7 * i, 25 + 7 * i)) for i in range(3)]

    def run(num_blocks):
        eng = _engine(pair, on_demand=True, overcommit=2.0, num_blocks=num_blocks, page=16,
                      steps_per_sync=1, seed=3)
        rids = [eng.submit(p, max_new_tokens=56) for p in prompts]
        eng.run_until_idle()
        return eng, [eng.result(rid) for rid in rids]

    small, outs_small = run(10)
    big, outs_big = run(24)
    assert small.preemptions > 0 and big.preemptions == 0
    for cs, cb in zip(outs_small, outs_big):
        assert cs.output_ids.tolist() == cb.output_ids.tolist()
        assert cs.prompt_len == cb.prompt_len
        for key in ("tokens_generated", "accepted_count", "resample_count",
                    "target_sample_count", "target_call_times", "acc_len"):
            assert cs.details[key] == cb.details[key], key
        assert cs.details["acc_rate"] == pytest.approx(cb.details["acc_rate"], rel=1e-6)
        assert sum(cs.details["acc_len"]) == cs.details["accepted_count"]
    assert small.allocator.free_blocks == 10


def test_runway_clamps_to_table_width(pair):
    """tests/test_paged_engine.py:475: prompt + budget + runway (100) past
    the table's 96 positions must clamp, not overflow the table."""
    eng = _engine(pair, batch_rows=2, num_blocks=16, page=16, max_pages_per_req=6,
                  steps_per_sync=4)
    rid = eng.submit(list(range(5, 25)), max_new_tokens=60)
    eng.run_until_idle()
    assert eng.result(rid).details["tokens_generated"] >= 60
    assert eng.allocator.free_blocks == 16


# ----------------------------------------------------- greedy ids vs JAX

def _greedy_runs(pair, submissions, **kw):
    """The same submissions, one list after the other (each drained before
    the next), through both engines at top_k=1 -> (JAX ids, port ids,
    port engine)."""
    out = []
    for make in (_jax_engine, _engine):
        eng = make(pair, top_k=1, steps_per_sync=2, **kw)
        ids = []
        for wave in submissions:
            rids = [eng.submit(p, n) for p, n in wave]
            eng.run_until_idle()
            ids += [np.asarray(eng.result(r).output_ids).tolist() for r in rids]
        out.append((ids, eng))
    return out[0][0], out[1][0], out[1][1]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_ids_equal_jax_with_the_prefix_cache(pair, kv_quant):
    """A request registers a 70-token prefix; three sharers (two of them
    admitted together) then hit it, and one unrelated prompt misses."""
    sys_prompt = list(range(9, 79))
    waves = [[(sys_prompt + [1, 2, 3], 12)],
             [(sys_prompt + [5 + i], 10 + i) for i in range(3)] + [(list(range(40, 60)), 9)]]
    jids, tids, eng = _greedy_runs(pair, waves, prefix_cache=True, batch_rows=4,
                                   kv_quant=kv_quant)
    assert tids == jids
    assert eng.allocator.hits == 6 and eng.allocator.available_blocks == 24


def test_greedy_ids_equal_jax_under_preemption(pair):
    prompts = [(list(range(5 + 7 * i, 25 + 7 * i)), 56) for i in range(3)]
    jids, tids, eng = _greedy_runs(pair, [prompts], on_demand=True, overcommit=2.0,
                                   num_blocks=10, page=16)
    assert eng.preemptions > 0
    assert tids == jids


def test_a_hit_leaves_the_shared_pages_unchanged(pair):
    """Every byte of the shared pages, in both pools, is what the first
    request wrote, after a sharer has been admitted, decoded and freed."""
    eng = _engine(pair, prefix_cache=True, kv_quant=True, batch_rows=2)
    sys_prompt = list(range(11, 77))  # 66 tokens: two shareable pages
    eng.submit(sys_prompt + [3], 6)
    eng.run_until_idle()
    shared = eng.allocator.lookup(tpaged.prompt_page_hashes(sys_prompt + [4, 5], 32))
    assert len(shared) == 2

    def pages():
        return [t[:, shared].clone() for c in (eng.state.draft_cache, eng.state.target_cache)
                for t in (c.k_q, c.k_s, c.v_q, c.v_s)]

    before = pages()
    rid = eng.submit(sys_prompt + [4, 5], 20)
    eng.run_until_idle()
    assert eng.result(rid).details["prefix_cached_tokens"] == 64
    for a, b in zip(pages(), before):
        assert torch.equal(a, b)
