"""The paged engine's captured admission prefill (``serve/paged.py``
``_dispatch_prefill``): a batch of cold prompts padded to a power of two
rows, as the JAX engine pads it, runs over the static buffers of its
(padded rows, bucket) entry; pad rows carry filler prompts and the
sentinel table, so they write the trash block only.

CPU tests run the padded forwards eagerly (the body the card captures)
against the same requests admitted one at a time (K = 1: no pad row), one
thread, a tiny int8 OPT pair. The ``card`` test holds a
replayed admission against the same admission under
``device_loop.eager_steps()`` on a CUDA card and skips without one:
``python -m pytest tests/test_torch_admission_graph.py --noconftest -m card``
on a GPU machine (the card test imports no JAX).
"""

import numpy as np
import pytest
import torch

from llmspeculativesampling_tpu_torch.core.synthetic import (
    synthetic_opt_pair_int8_small_draft,
)
from llmspeculativesampling_tpu_torch.engine import device_loop
from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

TINY = dict(hidden_size=64, ffn_dim=128, num_layers=2, num_heads=4, vocab_size=128,
            draft_hidden=32, draft_ffn=64, draft_layers=1, max_position=256)
PROMPTS = [np.arange(3, 23), np.arange(5, 30), np.arange(7, 38)]  # 20, 25, 31: one bucket of 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return synthetic_opt_pair_int8_small_draft(**TINY, device="cpu")


def _engine(pair, device="cpu", **kw):
    bd, pd, bt, pt = pair
    kw = {**dict(batch_rows=6, num_blocks=24, page=16, max_pages_per_req=6, max_new_cap=16,
                 gamma=3, eos_token_id=-1, top_k=1, prompt_bucket=16, steps_per_sync=2,
                 kv_quant=True, seed=5), **kw}
    return PagedEngine(bd, pd, bt, pt, device=device, **kw)


def _pools(eng):
    """Every pool tensor of both caches, block axis second."""
    return [getattr(c, n) for c in (eng.state.draft_cache, eng.state.target_cache)
            for n in ("k_q", "k_s", "v_q", "v_s")]


def _scramble(eng, seed=11):
    """Fill the pools with the same garbage in every engine, so a write
    anywhere shows."""
    g = torch.Generator().manual_seed(seed)
    for t in _pools(eng):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
        else:
            t.copy_(torch.rand(t.shape, generator=g, dtype=torch.float32).to(t.dtype))


def _admit(eng, prompts=PROMPTS, new=6):
    rids = [eng.submit(p, new) for p in prompts]
    eng._admit()
    return rids


def _own_blocks(eng):
    return sorted(b for blocks in eng._row_blocks if blocks for b in blocks)


def _state(eng):
    st = eng.state
    out = {name: getattr(st, name) for name in ("tokens", "cur_len", "key", "active", "done",
                                                "target_len", "prefill_to", "accepted",
                                                "resamples", "bonus", "steps", "acc_rate_sum",
                                                "acc_len_hist")}
    for tag, c in (("draft", st.draft_cache), ("target", st.target_cache)):
        out[f"{tag}.block_tables"], out[f"{tag}.lengths"] = c.block_tables, c.lengths
    return out


@pytest.fixture
def admitted(pair):
    """(padded engine, unpadded engine, the garbage the pools held): the
    same three cold prompts admitted as one batch (3 rows padded to 4) and
    one at a time."""
    eng_p, eng_e = _engine(pair), _engine(pair)
    for e in (eng_p, eng_e):
        _scramble(e)
    before = [t.clone() for t in _pools(eng_p)]
    _admit(eng_p)
    for p in PROMPTS:
        _admit(eng_e, [p])
    return eng_p, eng_e, before


def test_padded_admission_writes_the_unpadded_pages_and_state(admitted):
    eng_p, eng_e, _ = admitted
    assert list(eng_p._prefill_graphs) == [(4, 32)] and list(eng_e._prefill_graphs) == [(1, 32)]
    assert eng_p._row_blocks == eng_e._row_blocks
    n = eng_p.allocator.num_blocks
    for a, b in zip(_pools(eng_p), _pools(eng_e)):
        torch.testing.assert_close(a[:, :n], b[:, :n], rtol=0, atol=0)  # the trash block aside
    ref = _state(eng_e)
    for name, got in _state(eng_p).items():
        torch.testing.assert_close(got, ref[name], rtol=0, atol=0, msg=name)
    assert (eng_p.prefill_eager, eng_p.prefill_replays) == (1, 0)
    assert (eng_e.prefill_eager, eng_e.prefill_replays) == (3, 0)


def test_padded_admission_touches_only_its_rows_blocks_and_the_trash_block(admitted):
    eng_p, _, before = admitted
    own = _own_blocks(eng_p)
    trash = eng_p.allocator.num_blocks
    other = [b for b in range(trash) if b not in own]
    assert own and other
    wrote_own = wrote_trash = False
    for got, was in zip(_pools(eng_p), before):
        torch.testing.assert_close(got[:, other], was[:, other], rtol=0, atol=0)
        wrote_own |= not torch.equal(got[:, own], was[:, own])
        wrote_trash |= not torch.equal(got[:, trash], was[:, trash])
    assert wrote_own and wrote_trash  # the pad row wrote the trash block


def test_padded_admission_decodes_as_the_unpadded(admitted):
    eng_p, eng_e, _ = admitted
    eng_p.run_until_idle(), eng_e.run_until_idle()
    assert sorted(eng_p.completions) == sorted(eng_e.completions) == [0, 1, 2]
    for rid in range(3):
        np.testing.assert_array_equal(eng_p.result(rid).output_ids, eng_e.result(rid).output_ids)


@pytest.mark.parametrize("k, k_pad", [(1, 1), (2, 2), (3, 4), (5, 8)])
def test_each_batch_pads_to_the_next_power_of_two(pair, k, k_pad):
    eng = _engine(pair, batch_rows=8, num_blocks=48)
    _admit(eng, [np.arange(3, 20 + i) for i in range(k)], new=2)
    assert list(eng._prefill_graphs) == [(k_pad, 32)] and eng.num_active == k


def test_admission_batches_follow_the_jax_padded_rule(pair, monkeypatch):
    """A mixed queue over buckets of 32, 64 and 128 at a budget of 384
    forms the batches the JAX engine forms: a padded batch times its
    bucket within the budget (64: 4 rows, not the 6 an unpadded count
    allows; 128: 2, not 3)."""
    import jax

    from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
    from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
    from llmspeculativesampling_tpu.models import llama as jl
    from llmspeculativesampling_tpu.serve.paged import PagedEngine as JEngine

    lens = [50] * 7 + [100] * 5 + [20] * 10 + [60, 120, 30, 64]
    prompts = [np.arange(3, 3 + n) for n in lens]
    kw = dict(batch_rows=40, num_blocks=160, page=32, max_pages_per_req=8, max_new_cap=16,
              gamma=3, eos_token_id=-1, prompt_bucket=32, prefill_token_budget=384,
              steps_per_sync=2)
    cfg = JCfg(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2,
               num_kv_heads=2, max_position=512, dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    je = JEngine(JBundle("llama", cfg, jl.forward), jp, JBundle("llama", cfg, jl.forward), jp,
                 **kw)
    te = _engine(pair, **kw)
    seen = {"jax": [], "port": []}
    for name in ("_dispatch_prefill", "_dispatch_extend", "_stage_admission"):
        monkeypatch.setattr(je, name, lambda part, bucket, _n=name: seen["jax"].append(
            (_n, bucket, len(part))))
        monkeypatch.setattr(te, name, lambda part, _n=name: seen["port"].append(
            (_n, part[0].prompt.shape[0], len(part))))
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, 4)
        eng._admit()
    assert seen["port"] == seen["jax"]
    assert ("_dispatch_prefill", 64, 4) in seen["port"]
    assert ("_dispatch_prefill", 128, 2) in seen["port"]
    assert ("_dispatch_prefill", 32, 8) in seen["port"]


def test_over_budget_and_prefix_hit_admissions_run_eagerly(pair, monkeypatch):
    """With replays allowed on the CPU and a capture that pretends to
    replay, a cold batch within the budget counts as replayed; a lone prompt
    over the budget and a prefix-cache hit run eagerly and count so."""
    def replays(entry, fn, dev, replay, pool=None):
        fn()
        return replay

    monkeypatch.setattr(device_loop, "run_once", replays)
    eng = _engine(pair, prefill_token_budget=48, prefix_cache=True, max_pages_per_req=8)
    eng._graph_prefill = True
    _admit(eng, [np.arange(3, 23)])             # bucket 32: within the budget
    assert (eng.prefill_replays, eng.prefill_eager) == (1, 0)
    _admit(eng, [np.arange(40, 97)])            # bucket 64 alone, over the budget of 48
    assert (eng.prefill_replays, eng.prefill_eager) == (1, 1)
    eng.run_until_idle()
    _admit(eng, [np.arange(40, 97)])            # the same prompt: its prefix pages are hits
    assert any(r is not None and r.cached_len > 0 for r in eng._row_req)
    assert (eng.prefill_replays, eng.prefill_eager) == (1, 2)
    assert list(eng._prefill_graphs) == [(1, 32), (1, 64)]  # a hit runs no prefill forward


def test_the_cpu_engine_pads_and_replays_nothing(pair):
    eng = _engine(pair)
    assert not eng._graph_prefill
    _admit(eng)
    eng.run_until_idle()
    assert (eng.prefill_replays, eng.prefill_eager) == (0, 1) and eng._prefill_pool is None
    assert [e.graph for e in eng._prefill_graphs.values()] == [None]


# ---------------------------------------------------------------- the card

def _card_pair(dev):
    return synthetic_opt_pair_int8_small_draft(
        hidden_size=256, ffn_dim=1024, num_layers=4, num_heads=2, vocab_size=512,
        draft_hidden=128, draft_ffn=512, draft_layers=2, max_position=256, device=dev)


def _card_run(pair, dev):
    """Admissions of 3 (padded to 4) and 1 rows, each shape twice; after
    the second of each, its rows' pool pages and the next chunk's tokens.
    Returns (those readings, prefill_replays, prefill_eager)."""
    eng = _engine(pair, device=dev, batch_rows=4, num_blocks=16, page=128, max_pages_per_req=2,
                  max_new_cap=32, prompt_bucket=64, steps_per_sync=4)
    rng = np.random.default_rng(7)
    got = []
    for k in (3, 1, 3, 1):
        prompts = [rng.integers(3, 500, size=int(n)) for n in rng.integers(40, 64, size=k)]
        _admit(eng, prompts, new=8)
        blocks = _own_blocks(eng)
        pages = [t[:, blocks].clone() for t in _pools(eng)]
        eng.step()
        tokens = eng.state.tokens.clone()
        eng.run_until_idle()
        got.append((pages, tokens))
        eng.completions.clear()
    torch.cuda.synchronize()
    return got, eng.prefill_replays, eng.prefill_eager


@pytest.mark.card
def test_card_replayed_admission_equals_the_eager_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: `python -m pytest tests/test_torch_admission_graph.py "
                    "--noconftest -m card` on a GPU machine")
    dev = torch.device("cuda", 0)
    pair = _card_pair(dev)
    replayed, n_replays, n_eager = _card_run(pair, dev)
    with device_loop.eager_steps():
        eager, e_replays, e_eager = _card_run(pair, dev)
    # the first admission of each shape runs eagerly, then is captured
    assert (n_replays, n_eager) == (2, 2) and (e_replays, e_eager) == (0, 4)
    for (pages, tokens), (pages_e, tokens_e) in zip(replayed, eager):
        for a, b in zip(pages, pages_e):
            assert torch.equal(a, b)
        assert torch.equal(tokens, tokens_e)
