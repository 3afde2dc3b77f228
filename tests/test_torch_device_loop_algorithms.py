"""The device loops of the port's winner-row engines (``engine/multi.py``,
``engine/beam_spec.py``, ``engine/random_beam.py``) and the two repaired
faults of the device loop, on the CPU, where ``engine/device_loop.py::run``
calls the same step eagerly that the card replays as a CUDA graph.

* Greedy (top_k=1) ids and ``details`` counts equal JAX's device paths
  (``_multi_device``, ``_beam_spec_device``, ``_random_beam_device``):
  multi at width 3 and gamma 1 and 3, multi-beam and MJSD at width 3 of 4
  beams, random beam at width 3 and 1 on a dense pair, and multi at gamma
  3, multi-beam and random beam at width 3 on an int8 pair (int8 weights,
  head included), each also with an EOS mid-generation (the 10th generated
  token's id).
* A finished state is a no-op: steps after an EOS, and after a last step
  that overshoots the budget (by gamma at the buffer's end for multi,
  multi-beam and MJSD), leave every field the finish reads bit for bit.
* The re-broadcast of one winner that copies only the window a step wrote
  (and the beam draft's reorders within it) gives the caches of JAX's full
  row take at every position below each row's length, step by step.
* ``sample_k_u`` and ``sample_k_topk_u`` draw without replacement, their
  first draw within TV 0.06 of p over 1,000 streams; ``randint_u`` is
  uniform on its range.
* ``verbose`` prints token text as JAX does under a stub tokenizer.
* A captured step's key follows the param leaves, and a dropped pair takes
  its entry with it (``device_loop.run`` with ``replay=True`` and no step,
  which the CPU can run: the entry is made and prefilled, nothing is
  captured).
"""

import functools
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from llmspeculativesampling_tpu.engine import beam_spec as jbs
from llmspeculativesampling_tpu.engine import multi as jm
from llmspeculativesampling_tpu.engine import random_beam as jrb
from llmspeculativesampling_tpu.engine import speculative as jspec
from llmspeculativesampling_tpu.utils.decoder import Decoder as JDecoder
from llmspeculativesampling_tpu_torch.cache import kvcache as tkv
from llmspeculativesampling_tpu_torch.engine import beam_draft as tbd
from llmspeculativesampling_tpu_torch.engine import beam_spec as tbs
from llmspeculativesampling_tpu_torch.engine import device_loop
from llmspeculativesampling_tpu_torch.engine import multi as tm
from llmspeculativesampling_tpu_torch.engine import random_beam as trb
from llmspeculativesampling_tpu_torch.engine import speculative as tspec
from llmspeculativesampling_tpu_torch.engine.types import aligned_total, pad_prompt
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.ops import sampling as ts
from llmspeculativesampling_tpu_torch.utils.decoder import Decoder as TDecoder

from _torch_port import one_thread, to_port  # noqa: F401 (fixture)
from test_torch_device_loop import CPU, PROMPT, _pair

WINNER_KEYS = ("acc_len", "accepted_count", "target_call_times", "tokens_generated")
RB_KEYS = ("target_call_times", "tokens_generated")
CASES = {
    "multi_g1": dict(gamma=1, width=3),
    "multi_g3": dict(gamma=3, width=3),
    "multi_beam": dict(gamma=3, width=3, num_beams=4, strategy="beam"),
    "mjsd": dict(gamma=3, width=3, num_beams=4, accept_thres=0.1),
    "random_beam_w3": dict(max_num_beams=3, min_num_beams=3),
    "random_beam_w1": dict(max_num_beams=1, min_num_beams=1),
}


@pytest.fixture(scope="module")
def pairs():
    return {False: _pair(False), True: _pair(True)}


def _both(case, pair, new, eos):
    """(JAX ids, JAX details, port ids, port details) of one case, greedy."""
    (jbd, jpd, tbd_, tpd), (jbt, jpt, tbt, tpt) = pair
    kw = dict(eos_token_id=eos, top_k=1, details=True, **CASES[case])
    if case.startswith("random_beam"):
        jo, jd = jrb.random_width_beam_generate(jbt, jpt, PROMPT, new, key=jax.random.key(1), **kw)
        to, td = trb.random_width_beam_generate(tbt, tpt, PROMPT, new, device="cpu", **kw)
    elif case == "mjsd":
        jo, jd = jbs.mjsd_generate(jbd, jpd, jbt, jpt, PROMPT, new, key=jax.random.key(1), **kw)
        to, td = tbs.mjsd_generate(tbd_, tpd, tbt, tpt, PROMPT, new, device="cpu", **kw)
    else:
        jo, jd = jm.multi_speculative_generate(jbd, jpd, jbt, jpt, PROMPT, new,
                                               key=jax.random.key(1), **kw)
        to, td = tm.multi_speculative_generate(tbd_, tpd, tbt, tpt, PROMPT, new, device="cpu", **kw)
    return np.asarray(jo), jd, to, td


@pytest.mark.parametrize("case,int8", [(c, False) for c in CASES] + [
    (c, True) for c in ("multi_g3", "multi_beam", "random_beam_w3")])
def test_greedy_equals_jax_device_path(case, int8, pairs):
    keys = RB_KEYS if case.startswith("random_beam") else WINNER_KEYS
    jo, jd, to, td = _both(case, pairs[int8], 18, -1)
    np.testing.assert_array_equal(to, jo)
    for k in keys:
        assert td[k] == jd[k], (k, td[k], jd[k])
    eos = int(jo[len(PROMPT) + 9])
    jo, jd, to, td = _both(case, pairs[int8], 18, eos)
    assert to[-1] == eos and len(to) <= len(PROMPT) + 10
    np.testing.assert_array_equal(to, jo)
    for k in keys:
        assert td[k] == jd[k], (k, td[k], jd[k])


# ----------------------------------------------------- steps on the state
GAMMA, NEW, WIDTH, BEAMS = 2, 61, 3, 4
LONG_PROMPT = [3 + (7 * i) % 100 for i in range(64)]


def _parts(kind, pu, tbt, eos, scfg, seed=0):
    """(build, start, step) of ``kind`` with the target drafting for itself
    (greedy: every draft is accepted, a step commits gamma+1)."""
    padded, p_len = pad_prompt(LONG_PROMPT)
    prompt_t = torch.as_tensor(padded, dtype=torch.long)
    total = p_len + NEW
    gen = torch.Generator().manual_seed(seed)
    if kind == "random_beam":
        max_total = aligned_total(padded.shape[1] + NEW + 1)
        return (functools.partial(trb._rb_state, tbt, 3, max_total, CPU),
                functools.partial(trb._rb_start, tbt, pu, prompt_t, p_len, total,
                                  device_loop.stream_key(gen, CPU)),
                functools.partial(trb._rb_step, tbt, pu, scfg, 2, 3, eos))
    max_total = aligned_total(padded.shape[1] + NEW + GAMMA + 1)
    assert max_total == total + GAMMA + 1
    rows = WIDTH if kind == "multi" else BEAMS
    key_rows = WIDTH if kind == "multi" else 1
    build = functools.partial(device_loop.winner_state, tbt, tbt, rows, WIDTH, GAMMA, key_rows,
                              max_total, NEW, False, CPU)
    start = functools.partial(device_loop.winner_start, tbt, pu, tbt, pu, prompt_t, p_len, total,
                              device_loop.stream_key(gen, CPU, rows=key_rows), None, None)
    if kind == "multi":
        step = functools.partial(tm._multi_step, tbt, pu, tbt, pu, scfg, GAMMA, WIDTH, eos)
    else:
        step = functools.partial(tbs._beam_spec_step, kind, tbt, pu, tbt, pu, scfg, GAMMA, WIDTH,
                                 BEAMS, 0.1, False, eos)
    return build, start, step


def _snapshot(st) -> dict:
    """Every field a finish reads (the caches are not among them)."""
    if isinstance(st, trb.RandomBeamState):
        names = ("row_tokens", "p_len", "cur_len", "total", "last_logits", "beam_scores", "key",
                 "best_tokens", "best_score", "best_len", "stop")
        return {n: getattr(st, n).clone() for n in names}
    n = int(st.cur_len)
    snap = {"tokens": st.tokens[0, :n].clone()}
    for name in ("cur_len", "total", "key", "done", "accepted", "steps", "rate_sum",
                 "acc_len_hist", "stop"):
        snap[name] = getattr(st, name).clone()
    return snap


def _run_then_step_more(build, start, step, extra: int = 3, snapshot=None):
    snapshot = snapshot or _snapshot
    with torch.no_grad():
        st = build()
        start(st)
        while not bool(st.stop):
            step(st)
        before = snapshot(st)
        for _ in range(extra):
            step(st)
    after = snapshot(st)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    return st


@pytest.mark.parametrize("end", ["budget", "eos"])
@pytest.mark.parametrize("kind", ["multi", "beam", "mjsd", "random_beam"])
def test_finished_state_is_a_no_op(kind, end, pairs):
    (_, _, _, _), (_, _, tbt, tpt) = pairs[False]
    pu = tl.unstack_layers(tpt)
    scfg = ts.SamplingConfig(1.0, 1, 0.0)
    p_len, total = len(LONG_PROMPT), len(LONG_PROMPT) + NEW
    st = _run_then_step_more(*_parts(kind, pu, tbt, -1, scfg))
    if end == "budget":
        if kind == "random_beam":
            assert int(st.cur_len) == total and float(st.beam_scores.max()) > -1e4
        else:
            assert int(st.cur_len) == total + GAMMA == st.tokens.shape[1] - 1
            assert int(st.steps) == 21 and not bool(st.done)
        return
    tokens = st.row_tokens[0] if kind == "random_beam" else st.tokens[0]
    eos = int(tokens[p_len + 10])
    st = _run_then_step_more(*_parts(kind, pu, tbt, eos, scfg))
    if kind == "random_beam":  # every greedy beam drew the EOS: each is a candidate, then dead
        assert int(st.best_len) <= p_len + 11 and float(st.beam_scores.max()) < -1e4
    else:
        assert bool(st.done) and int(st.cur_len) < total


def _full_take(cache, row_idx, start=None, size=0):
    del start, size
    tkv.select_rows_(cache, row_idx)


@pytest.mark.parametrize("kind", ["multi", "beam"])
def test_window_rebroadcast_equals_full_take(kind, pairs, monkeypatch):
    """Sampled (top_k 20, top_p 0.9) with a distinct draft, so winners and
    beam orders vary: after every step both states hold the same tokens,
    and every row of both caches the same k/v at each position below the
    length the next step rolls it back to (draft cur_len-2, target
    cur_len-1)."""
    (_, _, tbd_, tpd), (_, _, tbt, tpt) = pairs[False]
    pd, pt = tl.unstack_layers(tpd), tl.unstack_layers(tpt)
    scfg = ts.SamplingConfig(1.0, 20, 0.9)
    padded, p_len = pad_prompt(PROMPT)
    prompt_t = torch.as_tensor(padded, dtype=torch.long)
    new, gamma = 20, 3
    max_total = aligned_total(padded.shape[1] + new + gamma + 1)
    rows, key_rows = (WIDTH, WIDTH) if kind == "multi" else (BEAMS, 1)
    key = device_loop.stream_key(torch.Generator().manual_seed(3), CPU, rows=key_rows)
    if kind == "multi":
        step = functools.partial(tm._multi_step, tbd_, pd, tbt, pt, scfg, gamma, WIDTH, -1)
    else:
        step = functools.partial(tbs._beam_spec_step, "beam", tbd_, pd, tbt, pt, scfg, gamma,
                                 WIDTH, BEAMS, 0.0, False, -1)
    states = []
    for _ in range(2):
        st = device_loop.winner_state(tbd_, tbt, rows, WIDTH, gamma, key_rows, max_total, new,
                                      False, CPU)
        device_loop.winner_start(tbd_, pd, tbt, pt, prompt_t, p_len, p_len + new, key, None, None,
                                 st)
        states.append(st)
    window, full = states
    n_steps = 0
    with torch.no_grad():
        while not bool(window.stop):
            step(window)
            with monkeypatch.context() as m:
                for mod in (tm, tbs, tbd):
                    m.setattr(mod, "select_rows_", _full_take)
                step(full)
            n_steps += 1
            cur = int(window.cur_len)
            assert torch.equal(window.tokens[:, :cur], full.tokens[:, :cur])
            assert int(full.cur_len) == cur and bool(full.stop) == bool(window.stop)
            for a, b, n in ((window.draft_cache, full.draft_cache, cur - 2),
                            (window.target_cache, full.target_cache, cur - 1)):
                for x, y in zip(tkv.kv_buffers(a), tkv.kv_buffers(b)):
                    assert torch.equal(x[:, :, :, :n], y[:, :, :, :n])
    assert n_steps >= 4 and window.acc_len_hist[:n_steps].unique().numel() > 1


# ---------------------------------------------------------------- draws
def _streams(n_streams):
    return ts.row_keys(7, range(n_streams))


def test_draws_without_replacement_follow_p():
    n, v, k = 1000, 12, 4
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(v) * 0.7).astype(np.float32)
    probs = torch.from_numpy(p)
    u, _ = ts.row_uniform(_streams(n), v)
    ids = ts.sample_k_u(probs.expand(n, v), u, k)
    assert all(len(set(r)) == k for r in ids.tolist())
    tv = 0.5 * np.abs(np.bincount(ids[:, 0].numpy(), minlength=v) / n - p).sum()
    assert tv < 0.06, tv
    # candidate space: 8 candidates of a 40-token vocab, 3 draws
    cand = torch.from_numpy(rng.permutation(40)[:8].astype(np.int64))
    pk = rng.dirichlet(np.ones(8)).astype(np.float32)
    dist = ts.TopKDist(cand.expand(n, 8), torch.from_numpy(pk).expand(n, 8))
    u, _ = ts.row_uniform(_streams(n), ts.topk_draw_width(dist, 3))
    ids = ts.sample_k_topk_u(dist, u, 3)
    assert all(len(set(r)) == 3 and set(r) <= set(cand.tolist()) for r in ids.tolist())
    first = np.array([cand.tolist().index(i) for i in ids[:, 0].tolist()])
    tv = 0.5 * np.abs(np.bincount(first, minlength=8) / n - pk).sum()
    assert tv < 0.06, tv
    # more draws than candidates: the over-draws become the argmax
    short = ts.TopKDist(cand[:2].expand(n, 2), torch.tensor([0.3, 0.7]).expand(n, 2))
    u, _ = ts.row_uniform(_streams(n), ts.topk_draw_width(short, 4))
    ids = ts.sample_k_topk_u(short, u, 4)
    assert ids.shape == (n, 4) and set(ids[:, 2:].flatten().tolist()) == {int(cand[1])}


def test_width_draw_is_uniform():
    n, lo, hi = 1000, 2, 5
    u, _ = ts.row_uniform(_streams(n), 1)
    w = ts.randint_u(u[:, 0], lo, hi).numpy()
    assert w.min() == lo and w.max() == hi
    tv = 0.5 * np.abs(np.bincount(w - lo, minlength=hi - lo + 1) / n - 1 / (hi - lo + 1)).sum()
    assert tv < 0.06, tv
    edges = ts.randint_u(torch.tensor([1e-7, 0.2499, 0.25, 0.9999999]), lo, hi)
    assert edges.tolist() == [2, 2, 3, 5]


# ------------------------------------------------------- the two faults
class _StubTokenizer:
    def decode(self, ids, **kwargs):
        return "<T" + ",".join(str(int(i)) for i in ids) + ">"


def test_verbose_prints_text_as_jax(pairs, capsys, monkeypatch):
    (jbd, jpd, tbd_, tpd), (jbt, jpt, tbt, tpt) = pairs[False]
    for dec in (JDecoder(), TDecoder()):
        monkeypatch.setattr(dec, "tokenizer", _StubTokenizer())
    kw = dict(gamma=3, eos_token_id=-1, top_k=1, verbose=True)
    lines = []
    capsys.readouterr()
    jspec.speculative_generate(jbd, jpd, jbt, jpt, PROMPT, 14, key=jax.random.key(0), **kw)
    lines.append(capsys.readouterr().out)
    tspec.speculative_generate(tbd_, tpd, tbt, tpt, PROMPT, 14, device="cpu", **kw)
    lines.append(capsys.readouterr().out)
    heads = ("approx guess accepted", "target samples", "target resamples")
    jl, tl_ = ([ln for ln in out.splitlines() if ln.startswith(heads)] for out in lines)
    assert len(tl_) >= 14 and tl_ == jl
    assert all("<T" in ln for ln in tl_)


def _spec_parts(pair):
    (_, _, tbd_, tpd), (_, _, tbt, tpt) = pair
    padded, p_len = pad_prompt(PROMPT)
    max_total = aligned_total(padded.shape[1] + 8 + 3 + 1)
    build = functools.partial(tspec._spec_state, tbd_, tbt, 3, max_total, 8, False, CPU)
    start = functools.partial(tspec._spec_start, tbd_, tl.unstack_layers(tpd), tbt,
                              tl.unstack_layers(tpt), torch.as_tensor(padded, dtype=torch.long),
                              p_len, p_len + 8, device_loop.stream_key(torch.Generator(), CPU),
                              None, None)
    return build, start


def test_captured_step_follows_and_frees_its_params(pairs):
    (jbd, jpd, tbd_, _), (jbt, jpt, tbt, _) = pairs[False]
    pd, pt = to_port(jpd), to_port(jpt)
    key = ("spec", tbd_, tbt)
    k0 = device_loop.entry_key(key, (pd, pt))
    assert device_loop.entry_key(key, (pd, dict(pt))) == k0  # a new dict of the same leaves
    with torch.no_grad():
        pt["ln_final"].mul_(1.0)  # an in-place write: the same leaf
    assert device_loop.entry_key(key, (pd, pt)) == k0
    swapped = dict(pt, lm_head=pt["lm_head"] * 1.5)
    assert device_loop.entry_key(key, (pd, swapped)) != k0

    device_loop.release_graphs()
    try:
        build, start = _spec_parts(((jbd, jpd, tbd_, pd), (jbt, jpt, tbt, pt)))
        st = device_loop.run(key, (pd, pt), build, start, None, 0, replay=True)
        assert len(device_loop._ENTRIES) == 1 and int(st.cur_len) == len(PROMPT)
        leaf, state_tokens = weakref.ref(pt["lm_head"]), weakref.ref(st.tokens)
        del build, start, st, pd, pt, swapped
        gc.collect()
        assert leaf() is None and state_tokens() is None
        assert len(device_loop._ENTRIES) == 0
    finally:
        device_loop.release_graphs()
