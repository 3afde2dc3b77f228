"""The device loop of the port's ``speculative_generate`` and
``autoregressive_generate`` (``engine/device_loop.py``), on the CPU, where
the runner calls the same step eagerly that the card replays as a CUDA
graph.

* Greedy (top_k=1) ids of the port's default speculative path equal JAX's
  default (``_spec_generate_device``) for a dense and an int8 pair at gamma
  1 and 4, with an EOS mid-generation too, and so do ``accepted_count``,
  ``resample_count``, ``target_sample_count``, ``acc_len`` and
  ``target_call_times``; AR greedy ids equal JAX's ``_ar_generate_device``
  path, also with an EOS mid-generation.
* The device loop and the stepwise host loop draw from the same counter
  stream: identical ids and details at top_k 20, top_p 0.9, for 3 seeds.
* A finished state is a no-op: steps after an EOS, and after a last step
  that overshoots the budget by gamma at the buffer's end, leave the
  committed tokens, the length, the counters and the histogram bit for
  bit, with no index error.
* ``random_seed`` makes the accept decisions JAX's ``fixed_r`` path makes
  (both samplers given the same Gumbel noise, ``_torch_port.patch_noise``).
* The counter stream samples the target's distribution: over 1,000 seeds
  the first generated token lies within TV 0.06 of p on a vocab-64 pair.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine import speculative as jspec
from llmspeculativesampling_tpu.engine.autoregressive import autoregressive_generate as j_ar
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.quant.core import quantize_params as jquant
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine import autoregressive as tar
from llmspeculativesampling_tpu_torch.engine import speculative as tspec
from llmspeculativesampling_tpu_torch.engine.device_loop import stream_key
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.engine.types import aligned_total, pad_prompt
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.ops.sampling import SamplingConfig

from _torch_port import one_thread, patch_noise, to_port  # noqa: F401 (fixture)

PROMPT = [3, 14, 15, 9, 26, 5]
EOS = 127
DETAIL_KEYS = ("accepted_count", "resample_count", "target_sample_count", "acc_len",
               "target_call_times")
CPU = torch.device("cpu")


def _pair(int8: bool):
    """Draft (1 layer) and target (2 layers) of tests/test_torch_engine.py:
    vocab 128, hidden 128, two heads of 64 (the flash path's steps)."""
    out = []
    for layers, seed in ((1, 10), (2, 25 if int8 else 20)):
        kw = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=layers,
                  num_heads=2, num_kv_heads=2, max_position=512, dtype="float32")
        p = jl.init_params(JCfg(**kw), jax.random.key(seed))
        if int8:
            p = jquant(p, "llama", quantize_lm_head=True)
        out.append((JBundle("llama", JCfg(**kw), jl.forward), p,
                    TBundle("llama", TCfg(**kw), tl.forward), to_port(p)))
    return out


@pytest.fixture(scope="module")
def pairs():
    return {False: _pair(False), True: _pair(True)}


def _spec_both(pair, new, gamma, eos, **kw):
    (jbd, jpd, tbd, tpd), (jbt, jpt, tbt, tpt) = pair
    jo, jd = jspec.speculative_generate(jbd, jpd, jbt, jpt, PROMPT, new, gamma=gamma,
                                        eos_token_id=eos, key=jax.random.key(1), details=True, **kw)
    to, td = tspec.speculative_generate(tbd, tpd, tbt, tpt, PROMPT, new, gamma=gamma,
                                        eos_token_id=eos, details=True, device="cpu", **kw)
    return np.asarray(jo), jd, to, td


@pytest.mark.parametrize("gamma", [1, 4])
@pytest.mark.parametrize("int8", [False, True])
def test_greedy_spec_equals_jax_device_path(int8, gamma, pairs):
    jo, jd, to, td = _spec_both(pairs[int8], 20, gamma, -1, top_k=1)
    np.testing.assert_array_equal(to, jo)
    for k in DETAIL_KEYS:
        assert td[k] == jd[k], (k, td[k], jd[k])
    # an EOS mid-generation: the 10th generated token's id
    eos = int(jo[len(PROMPT) + 9])
    jo, jd, to, td = _spec_both(pairs[int8], 20, gamma, eos, top_k=1)
    assert to[-1] == eos and len(to) <= len(PROMPT) + 10
    np.testing.assert_array_equal(to, jo)
    for k in DETAIL_KEYS:
        assert td[k] == jd[k], (k, td[k], jd[k])


@pytest.mark.parametrize("int8", [False, True])
def test_greedy_ar_equals_jax(int8, pairs):
    (_, _, _, _), (jbt, jpt, tbt, tpt) = pairs[int8]
    ja = np.asarray(j_ar(jbt, jpt, PROMPT, 24, eos_token_id=-1, top_k=1, key=jax.random.key(0)))
    ta = tar.autoregressive_generate(tbt, tpt, PROMPT, 24, eos_token_id=-1, top_k=1, device="cpu")
    np.testing.assert_array_equal(ta, ja)
    eos = int(ja[len(PROMPT) + 9])
    ja = np.asarray(j_ar(jbt, jpt, PROMPT, 24, eos_token_id=eos, top_k=1, key=jax.random.key(0)))
    ta = tar.autoregressive_generate(tbt, tpt, PROMPT, 24, eos_token_id=eos, top_k=1, device="cpu")
    assert ta[-1] == eos and len(ta) <= len(PROMPT) + 10
    np.testing.assert_array_equal(ta, ja)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_loop_equals_stepwise_loop(seed, pairs):
    (_, _, tbd, tpd), (_, _, tbt, tpt) = pairs[False]
    kw = dict(gamma=4, eos_token_id=EOS, top_k=20, top_p=0.9, details=True, device="cpu")
    a, da = tspec.speculative_generate(tbd, tpd, tbt, tpt, PROMPT, 24,
                                       generator=torch.Generator().manual_seed(seed), **kw)
    b, db = tspec.speculative_generate(tbd, tpd, tbt, tpt, PROMPT, 24, stepwise=True,
                                       generator=torch.Generator().manual_seed(seed), **kw)
    np.testing.assert_array_equal(a, b)
    assert db["phase_split_method"] == "measured" and da["phase_split_method"] == "calibrated"
    for k in ("acc_len", "acc_rate", "target_call_times", "approx_call_times", "tokens_generated"):
        assert da[k] == db[k], (k, da[k], db[k])


def _snapshot(st) -> dict:
    n = int(st.cur_len)
    snap = {"tokens": st.tokens[0, :n].clone(), "cur_len": st.cur_len.clone(),
            "done": st.done.clone(), "stop": st.stop.clone()}
    for name in ("accepted", "resamples", "bonus", "steps", "acc_rate_sum", "acc_len_hist"):
        if hasattr(st, name):
            snap[name] = getattr(st, name).clone()
    return snap


def _run_then_step_more(build, start, step, extra: int = 3):
    with torch.no_grad():
        st = build()
        start(st)
        while not bool(st.stop):
            step(st)
        before = _snapshot(st)
        for _ in range(extra):
            step(st)
    after = _snapshot(st)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    return st


@pytest.mark.parametrize("end", ["budget", "eos"])
def test_finished_state_is_a_no_op(end, pairs):
    """The target drafts for itself (greedy: every draft is accepted, each
    step commits gamma+1). A 64-token prompt, gamma 2 and 61 new tokens
    make the buffer aligned_total(64 + 61 + 3) = 128 = total + gamma + 1,
    and the last of 21 steps lands at total + gamma, its last position."""
    (_, _, _, _), (_, _, tbt, tpt) = pairs[False]
    gamma, new = 2, 61
    prompt = [3 + (7 * i) % 100 for i in range(64)]
    padded, p_len = pad_prompt(prompt)
    max_total, total = aligned_total(padded.shape[1] + new + gamma + 1), p_len + new
    assert max_total == total + gamma + 1
    pu = tl.unstack_layers(tpt)
    scfg = SamplingConfig(1.0, 1, 0.0)
    prompt_t = torch.as_tensor(padded, dtype=torch.long)
    key = stream_key(torch.Generator().manual_seed(0), CPU)

    def parts(eos):
        return (functools.partial(tspec._spec_state, tbt, tbt, gamma, max_total, new, False, CPU),
                functools.partial(tspec._spec_start, tbt, pu, tbt, pu, prompt_t, p_len, total, key,
                                  None, None),
                functools.partial(tspec._spec_step, tbt, pu, tbt, pu, scfg, gamma, eos))

    st = _run_then_step_more(*parts(-1))
    if end == "budget":
        assert int(st.cur_len) == total + gamma == max_total - 1
        assert int(st.steps) == 21 and int(st.resamples) == 0 and not bool(st.done)
        ar_eos = -1
    else:
        eos = int(st.tokens[0, p_len + 10])
        st = _run_then_step_more(*parts(eos))
        assert bool(st.done) and int(st.cur_len) < total
        ar_eos = eos
    # AR: steps after its last token (or its EOS) change nothing either
    ar_total = aligned_total(padded.shape[1] + new)
    _run_then_step_more(
        functools.partial(tar._ar_state, tbt, ar_total, tbt.cfg.vocab_size, CPU),
        functools.partial(tar._ar_start, tbt, pu, prompt_t, p_len, total, key, None),
        functools.partial(tar._ar_step, tbt, pu, scfg, ar_eos))


def test_random_seed_accepts_as_jax_fixed_r(monkeypatch, pairs):
    """The draft is the target with its head scaled by 1.5 (q a sharper p),
    and the fixed uniform (0.9531, seed 56) sits among the ratios p/q, so
    steps accept every draft, some and none."""
    (_, _, _, _), (jbt, jpt, tbt, tpt) = pairs[False]
    jq = dict(jpt, lm_head=jpt["lm_head"] * 1.5)
    pair = [(jbt, jq, tbt, to_port(jq)), (jbt, jpt, tbt, tpt)]
    r0 = float(torch.rand((), generator=torch.Generator().manual_seed(56)))
    patch_noise(monkeypatch, uniform=r0)
    jo, jd, to, td = _spec_both(pair, 18, 3, -1, top_k=20, top_p=0.9, random_seed=56)
    np.testing.assert_array_equal(to, jo)
    for k in DETAIL_KEYS:
        assert td[k] == jd[k], (k, td[k], jd[k])
    assert 0 < td["resample_count"] < td["target_call_times"], td["acc_len"]


def test_counter_stream_samples_the_target():
    """A vocab-64 target whose head is scaled so that p is peaked (its
    sampling noise in TV over 1,000 draws is near 0.015), drafted by the
    same model with a flatter head, so drafts are both accepted and
    resampled."""
    kw = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=1,
              num_kv_heads=1, max_position=128, dtype="float32")
    cfg = TCfg(**kw)
    pt = tl.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    pd = dict(pt, lm_head=pt["lm_head"] * 30.0)
    pt["lm_head"] = pt["lm_head"] * 120.0
    b = TBundle("llama", cfg, tl.forward)
    logits, _ = b.forward(pt, cfg, torch.tensor([PROMPT]), b.make_cache(1, 64, device="cpu"))
    p = torch.softmax(logits[0, -1], -1).numpy()
    n = 1000
    counts, accepted = np.zeros(64), 0
    for seed in range(n):
        out, d = tspec.speculative_generate(
            b, pd, b, pt, PROMPT, 1, gamma=2, eos_token_id=-1, details=True, device="cpu",
            generator=torch.Generator().manual_seed(seed))
        counts[out[len(PROMPT)]] += 1
        accepted += d["acc_len"][0] > 0
    tv = 0.5 * np.abs(counts / n - p).sum()
    assert 0.1 * n < accepted < 0.9 * n, accepted
    assert tv < 0.06, tv
