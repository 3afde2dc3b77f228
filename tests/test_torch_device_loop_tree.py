"""The device loops of the port's tree engines (``engine/beam_tree.py``:
beam v1 and v2) and of BiLD (``engine/bild.py``) on the CPU, where
``engine/device_loop.py::run`` calls the same step eagerly that the card
replays as a CUDA graph.

The pair is JAX's ``synthetic_pair`` at vocab 128 (a 1-layer draft taken
from a 3-layer target, deeper layers damped by 0.5): close enough that
greedy v2 accepts 0, 1 or 2 of 3 levels and BiLD's checks keep some tokens
and roll others back; its int8 twin quantizes the target, head included.

* Greedy (top_k=1) ids and ``details`` equal JAX's device paths
  (``_beam_tree_device``, ``_bild_device``): beam v1 at 4 beams and gamma
  3, beam v2 at 4 beams with extra_sample_cnt 1 and 2, dense and int8, each
  to the budget and with one EOS id a mode (the 10th token of the dense
  run: one compile a case); BiLD at gamma 4 with a fallback that checks
  every token, one that never falls back (checks at gamma only) and a
  rollback threshold that rolls back, each also with an EOS.
* A finished state is a no-op: steps after an EOS and after a last step
  that overshoots the budget leave every field the finish reads bit for
  bit, for both new steps.
* BiLD's macro-step (gamma decodes, then the check they made due) gives
  JAX's body-by-body run token for token when the checks fire at different
  depths inside it (a sharpened draft under fixed noise), and a BiLD state
  reused by a second generation gives a fresh state's tokens.
* The device-position forms of ``read_positions``, ``write_positions``
  and ``compact_tree_paths`` equal their host-int forms.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from llmspeculativesampling_tpu.core.synthetic import synthetic_pair
from llmspeculativesampling_tpu.engine import beam_tree as jbt
from llmspeculativesampling_tpu.engine import bild as jbi
from llmspeculativesampling_tpu.quant import quantize_params as jquant
from llmspeculativesampling_tpu_torch.cache import kvcache as tkv
from llmspeculativesampling_tpu_torch.engine import beam_tree as tbt
from llmspeculativesampling_tpu_torch.engine import bild as tbi
from llmspeculativesampling_tpu_torch.engine import device_loop
from llmspeculativesampling_tpu_torch.engine.types import aligned_total, pad_prompt
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.ops import sampling as ts

from _torch_port import one_thread, patch_noise  # noqa: F401 (fixture)
from test_torch_device_loop import CPU, PROMPT
from test_torch_device_loop_algorithms import _run_then_step_more
from test_torch_tree_engine import _port

NEW = 18
TREE_KEYS = ("acc_len", "accepted_count", "target_call_times", "expect_cnt_list",
             "num_beams_list", "tokens_generated")
BILD_KEYS = ("acc_len", "accepted_count", "target_call_times", "approx_call_times",
             "tokens_generated")
TREE_CASES = {
    "v1": dict(gamma=3, num_beams=4),
    "v2_r1": dict(gamma=3, num_beams=4, extra_sample_cnt=1, expect_thres=0.7),
    "v2_r2": dict(gamma=3, num_beams=4, extra_sample_cnt=2, expect_thres=0.7),
}
BILD_CASES = {
    "every_token": dict(fallback_thres=1.1, rollback_thres=5.0),
    "at_gamma": dict(fallback_thres=0.0, rollback_thres=1e9),
    "rollback": dict(fallback_thres=0.0, rollback_thres=5.0),
}


def _synthetic(int8: bool, draft_head: float = 1.0):
    """(JAX draft, params, port draft, params), (the same for the target);
    ``draft_head`` scales the draft's head (a sharper draft)."""
    bd, pd, bt, pt = synthetic_pair(hidden_size=64, num_layers=3, draft_layers=1, num_heads=2,
                                    vocab_size=128, dtype="float32", damp=0.5)
    if int8:
        pt = jquant(pt, "llama", quantize_lm_head=True)
    if draft_head != 1.0:
        pd = dict(pd, lm_head=pd["lm_head"] * draft_head)
    return (bd, pd, *_port(bd, pd)), (bt, pt, *_port(bt, pt))


@pytest.fixture(scope="module")
def pairs():
    return {False: _synthetic(False), True: _synthetic(True)}


def _tree_run(pkg, case, pair, eos):
    (jbd, jpd, tbd, tpd), (jbt_, jpt, tbt_, tpt) = pair
    kw = dict(eos_token_id=eos, top_k=1, details=True, **TREE_CASES[case])
    mod = jbt if pkg == "jax" else tbt
    fn = mod.beam_speculative_generate if case == "v1" else mod.beam_speculative_v2_generate
    if pkg == "jax":
        out, d = fn(jbd, jpd, jbt_, jpt, PROMPT, NEW, key=jax.random.key(1), **kw)
        return np.asarray(out), d
    return fn(tbd, tpd, tbt_, tpt, PROMPT, NEW, device="cpu", **kw)


@pytest.fixture(scope="module")
def tree_eos(pairs):
    """One EOS id a mode: the 10th generated token of its dense run."""
    p = len(PROMPT)
    return {mode: int(_tree_run("torch", case, pairs[False], -1)[0][p + 9])
            for mode, case in (("v1", "v1"), ("v2", "v2_r1"))}


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("case", list(TREE_CASES))
def test_tree_greedy_equals_jax_device_path(case, int8, pairs, tree_eos):
    eos = tree_eos[case[:2]]
    for e in (-1, eos):
        jo, jd = _tree_run("jax", case, pairs[int8], e)
        to, td = _tree_run("torch", case, pairs[int8], e)
        np.testing.assert_array_equal(to, jo)
        assert sorted(td) == sorted(jd)
        for k in TREE_KEYS:
            assert td[k] == jd[k], (e, k, td[k], jd[k])
        if e == -1:
            assert td["tokens_generated"] >= NEW
    assert len(to) < len(PROMPT) + NEW and eos in to[len(PROMPT):].tolist()
    if case != "v1":  # a level accepted, and one rejected, along the way
        assert max(td["acc_len"]) > 0 and min(td["acc_len"]) < 3


def _bild_run(pkg, case, pair, eos, new=NEW):
    (jbd, jpd, tbd, tpd), (jbt_, jpt, tbt_, tpt) = pair
    kw = dict(gamma=4, eos_token_id=eos, top_k=1, details=True, **BILD_CASES[case])
    if pkg == "jax":
        out, d = jbi.bild_generate(jbd, jpd, jbt_, jpt, PROMPT, new, key=jax.random.key(1), **kw)
        return np.asarray(out), d
    return tbi.bild_generate(tbd, tpd, tbt_, tpt, PROMPT, new, device="cpu", **kw)


@pytest.mark.parametrize("case,int8", [(c, False) for c in BILD_CASES] + [("rollback", True)])
def test_bild_greedy_equals_jax_device_path(case, int8, pairs):
    p = len(PROMPT)
    eos = int(_bild_run("torch", case, pairs[int8], -1)[0][p + 9])
    for e in (-1, eos):
        jo, jd = _bild_run("jax", case, pairs[int8], e)
        to, td = _bild_run("torch", case, pairs[int8], e)
        np.testing.assert_array_equal(to, jo)
        assert sorted(td) == sorted(jd)
        for k in BILD_KEYS:
            assert td[k] == jd[k], (e, k, td[k], jd[k])
    assert to[-1] == eos and len(to) <= p + 10
    checks, small = td["target_call_times"], td["approx_call_times"]
    if case == "every_token":
        assert checks == small
    elif case == "at_gamma":  # every check after gamma small tokens, all kept
        assert set(td["acc_len"]) == {4} and small >= 4 * checks
    else:
        assert 0 in td["acc_len"] and max(td["acc_len"]) > 0


# ----------------------------------------------------- steps on the state
GAMMA, BEAMS = 2, 3


def _tree_parts(mode, tb, pu, eos, new, scfg):
    """(build, start, step) of a tree engine with the target drafting for
    itself (greedy: every level is accepted, a step commits gamma+1)."""
    padded, p_len = pad_prompt(PROMPT)
    max_total = aligned_total(padded.shape[1] + new + GAMMA + BEAMS * GAMMA + 2)
    r_slots = BEAMS if mode == "v1" else 1
    key = device_loop.stream_key(torch.Generator().manual_seed(0), CPU)
    return (functools.partial(tbt._tree_state, tb, tb, BEAMS, r_slots, GAMMA, max_total, new, CPU),
            functools.partial(tbt._tree_start, tb, pu, tb, pu, torch.as_tensor(padded).long(),
                              p_len, p_len + new, key, None),
            functools.partial(tbt._tree_step, mode, tb, pu, tb, pu, scfg, GAMMA, BEAMS, r_slots,
                              0.7, 1, eos))


def _bild_parts(tb, pu, eos, new, scfg):
    """(build, start, step) of BiLD with the target drafting for itself and
    nothing rolled back: a macro-step commits gamma+1."""
    padded, p_len = pad_prompt(PROMPT)
    max_total = aligned_total(padded.shape[1] + new + 2)
    key = device_loop.stream_key(torch.Generator().manual_seed(0), CPU)
    return (functools.partial(tbi._bild_state, tb, tb, max_total, new, CPU),
            functools.partial(tbi._bild_start, tb, pu, tb, pu, torch.as_tensor(padded).long(),
                              p_len, p_len + new, key, None),
            functools.partial(tbi._bild_step, tb, pu, tb, pu, scfg, GAMMA, 0.0, 1e9, eos))


def _snapshot(st) -> dict:
    """Every field but the caches (the finish reads no cache)."""
    return {f: getattr(st, f).clone() for f in st.__dataclass_fields__
            if f not in ("draft_cache", "target_cache")}


@pytest.mark.parametrize("end", ["budget", "eos"])
@pytest.mark.parametrize("kind", ["beam_v1", "beam_v2", "bild"])
def test_finished_state_is_a_no_op(kind, end, pairs):
    (_, _, tb, tp) = pairs[False][1]
    pu = tl.unstack_layers(tp)
    scfg = ts.SamplingConfig(1.0, 1, 0.0)
    p_len = len(PROMPT)
    new = 13 if kind != "bild" else 14  # the last step overshoots the budget

    def parts(eos):
        if kind == "bild":
            return _bild_parts(tb, pu, eos, new, scfg)
        return _tree_parts(kind[-2:], tb, pu, eos, new, scfg)

    st = _run_then_step_more(*parts(-1), snapshot=_snapshot)
    over = GAMMA if kind != "bild" else 1
    assert int(st.cur_len) == p_len + new + over and not bool(st.done)
    if end == "budget":
        return
    tokens = st.tokens[0] if kind == "bild" else st.row_tokens[0]
    eos = int(tokens[p_len + 4])
    st = _run_then_step_more(*parts(eos), snapshot=_snapshot)
    assert bool(st.done) and int(st.cur_len) < p_len + new
    if kind != "bild":
        assert int(st.best_len) > p_len and not bool(st.alive.any())


def test_bild_checks_at_varying_depths_equal_jax(monkeypatch):
    """A draft sharpened 16-fold (its largest probability 0.2-0.7 at top_k
    8) under fixed noise, fallback 0.3, rollback 3.0: the checks fire after
    1 to gamma decodes of a macro-step, and the tokens and counts equal
    JAX's run, whose body is one decode (and a check when one is due)."""
    patch_noise(monkeypatch)
    (jbd, jpd, tbd, tpd), (jbt_, jpt, tbt_, tpt) = _synthetic(False, draft_head=16.0)
    gamma, new = 4, 24
    kw = dict(gamma=gamma, fallback_thres=0.3, rollback_thres=3.0, eos_token_id=-1, top_k=8,
              top_p=0.9, details=True)
    jo, jd = jbi.bild_generate(jbd, jpd, jbt_, jpt, PROMPT, new, key=jax.random.key(0), **kw)
    padded, p_len = pad_prompt(PROMPT)
    pd, pt = tl.unstack_layers(tpd), tl.unstack_layers(tpt)
    scfg = ts.SamplingConfig(1.0, 8, 0.9)
    st = tbi._bild_state(tbd, tbt_, aligned_total(padded.shape[1] + new + 2), new, CPU)
    tbi._bild_start(tbd, pd, tbt_, pt, torch.as_tensor(padded).long(), p_len, p_len + new,
                    device_loop.stream_key(torch.Generator().manual_seed(0), CPU), None, st)
    depths = []
    with torch.no_grad():
        while not bool(st.stop):
            before = int(st.small_cnt)
            tbi._bild_step(tbd, pd, tbt_, pt, scfg, gamma, 0.3, 3.0, -1, st)
            depths.append(int(st.small_cnt) - before)
    assert {1, gamma} <= set(depths) and len(set(depths)) >= 3, depths
    np.testing.assert_array_equal(st.tokens[0, :int(st.cur_len)].numpy(), np.asarray(jo))
    assert st.hist[:int(st.check_cnt)].tolist() == jd["acc_len"]
    assert int(st.small_cnt) == jd["approx_call_times"] and 0 in jd["acc_len"]
    to, td = tbi.bild_generate(tbd, tpd, tbt_, tpt, PROMPT, new, device="cpu", **kw)
    np.testing.assert_array_equal(to, np.asarray(jo))
    for k in BILD_KEYS:
        assert td[k] == jd[k], k


def test_bild_reused_state_equals_a_fresh_one():
    """A check that keeps every token leaves the draft's k/v of the last
    small token unwritten, and the next decode attends to that position as
    it stands (JAX's ``_bild_device`` does the same on its fresh cache): a
    state reused by a second generation, as a captured entry is, must give
    the tokens of a fresh state. Sampled (top_k 8) with a sharpened draft,
    checks at gamma only, nothing rolled back; prompts that fill their
    64-position bucket, so those positions lie past the prefill."""
    (_, _, tbd, tpd), (_, _, tbt_, tpt) = _synthetic(False, draft_head=16.0)
    pd, pt = tl.unstack_layers(tpd), tl.unstack_layers(tpt)
    scfg = ts.SamplingConfig(1.0, 8, 0.9)
    gamma, new = 4, 20
    prompts = [[3 + (7 * i) % 100 for i in range(64)], [5 + (11 * i) % 120 for i in range(63)]]

    def run(st, prompt, seed):
        padded, p_len = pad_prompt(prompt)
        tbi._bild_start(tbd, pd, tbt_, pt, torch.as_tensor(padded).long(), p_len, p_len + new,
                        device_loop.stream_key(torch.Generator().manual_seed(seed), CPU), None,
                        st)
        with torch.no_grad():
            while not bool(st.stop):
                tbi._bild_step(tbd, pd, tbt_, pt, scfg, gamma, 0.0, 1e9, -1, st)
        return st.tokens[0, :int(st.cur_len)].clone(), st.small_cnt.clone()

    max_total = aligned_total(64 + new + 2)
    reused = tbi._bild_state(tbd, tbt_, max_total, new, CPU)
    run(reused, prompts[1], 1)
    got = run(reused, prompts[0], 2)
    want = run(tbi._bild_state(tbd, tbt_, max_total, new, CPU), prompts[0], 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------------------ device positions
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_device_position_forms_equal_host_forms(quant):
    g = torch.Generator().manual_seed(11)
    shape = (2, 3, 2, 32, 8)
    if quant:
        cache = tkv.QuantKVCache(torch.randint(-127, 128, shape, generator=g, dtype=torch.int8),
                                 torch.randint(-127, 128, shape, generator=g, dtype=torch.int8),
                                 torch.rand(shape[:-1], generator=g),
                                 torch.rand(shape[:-1], generator=g), 20)
    else:
        cache = tkv.KVCache(torch.randn(shape, generator=g), torch.randn(shape, generator=g), 20)

    def copy(c):
        return tkv.QuantKVCache(*(b.clone() for b in tkv.kv_buffers(c)), c.length) if quant \
            else tkv.KVCache(*(b.clone() for b in tkv.kv_buffers(c)), c.length)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tkv.kv_buffers(a), tkv.kv_buffers(b)))

    for start, size in ((0, 4), (9, 3), (30, 4)):  # the last window is clamped
        host = tkv.read_positions(cache, start, size)
        dev = tkv.read_positions(cache, torch.tensor(start), size)
        assert all(torch.equal(x, y) for x, y in zip(host, dev))
        parts = tkv.read_positions(cache, 3, size)
        a, b = copy(cache), copy(cache)
        tkv.write_positions(a, parts, start)
        tkv.write_positions(b, parts, torch.tensor(start, dtype=torch.int32))
        assert same(a, b)
        valid = torch.arange(size) % 2 == 0
        c = copy(cache)
        tkv.write_positions(c, parts, torch.tensor(start), valid=valid)
        st = min(start, 32 - size)
        for x, y, z in zip(tkv.kv_buffers(c), tkv.kv_buffers(a), tkv.kv_buffers(cache)):
            for j in range(size):
                want = y if bool(valid[j]) else z
                assert torch.equal(x[:, :, :, st + j], want[:, :, :, st + j])
    path_idx = torch.randint(0, 6, (3, 4), generator=g)
    path_valid = torch.arange(4)[None].expand(3, 4) < 2
    a, b = copy(cache), copy(cache)
    ha = tkv.compact_tree_paths(a, path_idx, path_valid, 10)
    hb = tkv.compact_tree_paths(b, path_idx, path_valid, torch.tensor(10, dtype=torch.int32))
    assert same(a, b) and ha.length == 12 and hb.lengths.tolist() == [12, 12, 12]
