"""Spec v2's device loop (``engine/speculative_v2.py`` on
``engine/device_loop.py::run``) on the CPU, where the loop calls the same
step eagerly that the card replays as a CUDA graph, against JAX's
``_spec_v2_device`` on tests/test_torch_device_loop.py's tiny pairs.

* Greedy (top_k=1) ids and ``details`` equal JAX's, dense and int8 (int8
  weights, head included), to the budget and with an EOS mid-generation
  (the 10th generated token's id), gamma 3.
* Under ``random_seed`` (one fixed accept uniform) and the same fixed
  Gumbel noise on both sides (``_torch_port.patch_noise``), at top_k 32,
  every accept decision equals JAX's: the same ids, acc_len and
  counts, acc_rate within 1e-5.
* A finished state is a no-op: steps after an EOS and after the budget
  leave every field the finish reads bit for bit.
* A state reused for another generation (another prompt and stream) gives
  what a fresh state gives.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from llmspeculativesampling_tpu.engine import speculative_v2 as jv2
from llmspeculativesampling_tpu_torch.engine import device_loop
from llmspeculativesampling_tpu_torch.engine import speculative_v2 as tv2
from llmspeculativesampling_tpu_torch.engine.types import aligned_total, pad_prompt
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.ops import sampling as ts

from _torch_port import one_thread, patch_noise  # noqa: F401 (fixture)
from test_torch_device_loop import CPU, PROMPT, _pair

GAMMA, NEW = 3, 18
KEYS = ("acc_len", "accepted_count", "target_call_times", "approx_call_times",
        "tokens_generated")


@pytest.fixture(scope="module")
def pairs():
    return {False: _pair(False), True: _pair(True)}


def _both(pair, eos, new=NEW, **kw):
    (jbd, jpd, tbd, tpd), (jbt, jpt, tbt, tpt) = pair
    kw = dict(gamma=GAMMA, eos_token_id=eos, details=True, **kw)
    jo, jd = jv2.speculative_generate_v2(jbd, jpd, jbt, jpt, PROMPT, new, key=jax.random.key(1),
                                         **kw)
    to, td = tv2.speculative_generate_v2(tbd, tpd, tbt, tpt, PROMPT, new, device="cpu", **kw)
    return np.asarray(jo), jd, to, td


@pytest.fixture(scope="module")
def greedy(pairs):
    """JAX's and the port's greedy runs, one JAX compile per (pair, EOS
    id): to the budget, then with the budget run's 10th generated token as
    EOS."""
    out = {}
    for int8, pair in pairs.items():
        budget = _both(pair, -1, top_k=1)
        eos = int(budget[0][len(PROMPT) + 9])
        out[int8] = {"budget": budget, "eos": _both(pair, eos, top_k=1) + (eos,)}
    return out


@pytest.mark.parametrize("end", ["budget", "eos"])
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_greedy_equals_jax(greedy, int8, end):
    jo, jd, to, td = greedy[int8][end][:4]
    np.testing.assert_array_equal(to, jo)
    assert sorted(td) == sorted(jd)
    for k in KEYS:
        assert td[k] == jd[k], (k, td[k], jd[k])
    assert td["acc_rate"] == pytest.approx(jd["acc_rate"], abs=1e-6)
    if end == "eos":
        assert to[-1] == greedy[int8]["eos"][4] and len(to) <= len(PROMPT) + 10
    else:
        assert len(PROMPT) + NEW <= len(to) <= len(PROMPT) + NEW + GAMMA


def test_fixed_accept_uniform_decisions_equal_jax(pairs, monkeypatch):
    """21 new tokens (a budget no other test compiles JAX's v2 with, so the
    patched noise is traced in), top_k 32 of the 128 ids, random_seed 0 (a
    uniform of 0.496): this pair's independent draft is then both accepted
    and rejected."""
    u0 = float(torch.rand((), generator=torch.Generator().manual_seed(0)))
    patch_noise(monkeypatch, uniform=u0)
    jo, jd, to, td = _both(pairs[False], -1, new=21, top_k=32, random_seed=0)
    np.testing.assert_array_equal(to, jo)
    for k in KEYS:
        assert td[k] == jd[k], (k, td[k], jd[k])
    assert td["acc_rate"] == pytest.approx(jd["acc_rate"], abs=1e-5)
    assert 0 < td["accepted_count"] < GAMMA * td["target_call_times"]  # accepts and rejects


# ----------------------------------------------------- steps on the state
LONG_PROMPT = [3 + (7 * i) % 100 for i in range(20)]


def _parts(pair, eos, prompt=LONG_PROMPT, seed=0, top_k=1, new=NEW):
    """(build, start, step) of a v2 generation on the port's side."""
    (_, _, tbd, tpd), (_, _, tbt, tpt) = pair
    pd, pt = tl.unstack_layers(tpd), tl.unstack_layers(tpt)
    scfg = ts.SamplingConfig(1.0, top_k, 0.0)
    padded, p_len = pad_prompt(prompt)
    max_total = aligned_total(padded.shape[1] + new + GAMMA + 1)
    key = device_loop.stream_key(torch.Generator().manual_seed(seed), CPU)
    return (functools.partial(device_loop.winner_state, tbd, tbt, 1, 1, GAMMA, 1, max_total, new,
                              False, CPU),
            functools.partial(tv2._v2_start, torch.as_tensor(padded, dtype=torch.long), p_len,
                              p_len + new, key, None),
            functools.partial(tv2._v2_step, tbd, pd, tbt, pt, scfg, GAMMA, eos))


def _snapshot(st) -> dict:
    """Every field a finish reads."""
    n = int(st.cur_len)
    snap = {"tokens": st.tokens[0, :n].clone()}
    for name in ("cur_len", "total", "key", "done", "accepted", "steps", "rate_sum",
                 "acc_len_hist", "stop"):
        snap[name] = getattr(st, name).clone()
    return snap


def _run(st, start, step, extra: int = 0) -> dict:
    with torch.no_grad():
        start(st)
        while not bool(st.stop):
            step(st)
        before = _snapshot(st)
        for _ in range(extra):
            step(st)
    return before


@pytest.mark.parametrize("end", ["budget", "eos"])
def test_finished_state_is_a_no_op(pairs, end):
    build, start, step = _parts(pairs[False], -1)
    st = build()
    before = _run(st, start, step)
    if end == "eos":
        eos = int(st.tokens[0, len(LONG_PROMPT) + 10])
        build, start, step = _parts(pairs[False], eos)
        st = build()
        before = _run(st, start, step)
        assert bool(st.done) and int(st.cur_len) < len(LONG_PROMPT) + NEW
    else:
        assert not bool(st.done) and int(st.cur_len) >= len(LONG_PROMPT) + NEW
    with torch.no_grad():
        for _ in range(3):
            step(st)
    after = _snapshot(st)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def test_reused_state_equals_a_fresh_one(pairs):
    """A state that ran one generation (sampled, top_k 8) runs another
    prompt and stream: every field the finish reads equals a fresh state's
    run, and so does a third run back on the first generation."""
    build, start_a, step = _parts(pairs[True], -1, top_k=8, seed=1)
    _, start_b, _ = _parts(pairs[True], -1, prompt=list(range(40, 52)), top_k=8, seed=2)
    st = build()
    first = _run(st, start_a, step)
    reused = _run(st, start_b, step)
    fresh = _run(build(), start_b, step)
    again = _run(st, start_a, step)
    for k in fresh:
        assert torch.equal(reused[k], fresh[k]), k
        assert torch.equal(again[k], first[k]), k
    assert int(first["steps"]) > 1 and not torch.equal(first["key"], fresh["key"])
