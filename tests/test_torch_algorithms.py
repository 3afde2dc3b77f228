"""The port's cache-less speculative sampler (``engine/speculative_v2.py``),
BiLD (``engine/bild.py``), random-width beam sampling
(``engine/random_beam.py``) and the phase split's full-buffer mode
(``engine/phases.py``) against the JAX package on converted weights, on
the CPU.

* Greedy (top_k=1), at the JAX tests' settings
  (``tests/test_algorithms.py:28-80``, ``tests/test_beam_algorithms.py``
  :126-145): the port's ids equal JAX's one for one, and the target's
  greedy path where the engine reduces to it (v2, BiLD always falling
  back, random beam at one beam). BiLD never rolling back keeps the small
  model's greedy tokens.
* v2's forwards over the live prefix give the logits of JAX's full-buffer
  fresh-cache forward at the gamma+1 verify rows, within 1e-4 of the
  largest logit (fp32; the tolerance of ``tests/test_torch_llama.py``).
* Whole runs at top_k 8 and at the dense path, with the Gumbel noise of
  both packages replaced by the same fixed values
  (``_torch_port.patch_noise``) and, for v2, one fixed accept uniform:
  the same ids and the same ``details`` counts (v2's acc_rate within
  1e-5).
* The ``details`` key sets equal JAX's; BiLD's acc_rate is NaN in both.
"""

import math

import numpy as np
import jax
import pytest
import torch

from llmspeculativesampling_tpu.engine import bild as jbi
from llmspeculativesampling_tpu.engine import random_beam as jrb
from llmspeculativesampling_tpu.engine import speculative_v2 as jv2
from llmspeculativesampling_tpu_torch.engine import bild as tbi
from llmspeculativesampling_tpu_torch.engine import phases as tph
from llmspeculativesampling_tpu_torch.engine import random_beam as trb
from llmspeculativesampling_tpu_torch.engine import speculative_v2 as tv2
from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate as t_ar

from _torch_port import one_thread, patch_noise, rel_err  # noqa: F401 (fixture)
from test_speculative import EOS, PROMPT
from test_torch_tree_engine import models  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def greedy_ar(models):
    _, (_, _, tbt_, tpt) = models
    return t_ar(tbt_, tpt, PROMPT, 16, eos_token_id=EOS, top_k=1, device="cpu")


# ------------------------------------------------------------------- v2
@pytest.mark.parametrize("same", [False, True], ids=["distinct", "draft_is_target"])
def test_v2_greedy_equals_jax_and_ar(models, greedy_ar, same):
    (bd, pd, bt, pt), (tbd, tpd, tbt_, tpt) = models
    if same:
        bd, pd, tbd, tpd = bt, pt, tbt_, tpt
    kw = dict(gamma=3, eos_token_id=EOS, top_k=1, details=True)
    jo, jd = jv2.speculative_generate_v2(bd, pd, bt, pt, PROMPT, 16, key=jax.random.key(1), **kw)
    to, td = tv2.speculative_generate_v2(tbd, tpd, tbt_, tpt, PROMPT, 16, device="cpu", **kw)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(to[:len(greedy_ar)], greedy_ar)
    assert sorted(td) == sorted(jd)
    assert td["acc_len"] == jd["acc_len"]
    if same:
        assert min(td["acc_len"]) == 3


def test_v2_identical_models_full_accept(models):
    _, (_, _, tbt_, tpt) = models
    _, d = tv2.speculative_generate_v2(tbt_, tpt, tbt_, tpt, PROMPT, 12, gamma=3, eos_token_id=EOS,
                                       top_k=10, details=True, device="cpu",
                                       generator=torch.Generator().manual_seed(2))
    assert d["accepted_count"] == 3 * d["target_call_times"]
    assert d["acc_rate"] == pytest.approx(1.0)


def test_v2_live_prefix_logits_equal_full_buffer(models):
    """The rows a round reads (cur_len-1 .. cur_len+gamma-1) from a forward
    over the live prefix through a used cache rolled back to 0 equal JAX's
    forward over the whole static buffer through a fresh cache."""
    (_, _, bt, pt), (_, _, tbt_, tpt) = models
    gamma, max_total = 3, 128
    rng = np.random.default_rng(0)
    buf = np.zeros((1, max_total), np.int32)
    cur_len = len(PROMPT) + 5
    buf[0, :cur_len + gamma] = rng.integers(0, 64, cur_len + gamma)
    ref, _ = bt.forward(pt, bt.cfg, jax.numpy.asarray(buf), bt.make_cache(1, max_total))
    ref = np.asarray(ref)[0, cur_len - 1:cur_len + gamma]
    cache = tbt_.make_cache(1, max_total, device="cpu")
    tokens = torch.as_tensor(buf, dtype=torch.long)
    tv2.prefix_logits(tbt_, tpt, torch.flip(tokens, [1]), max_total, cache)  # dirty every position
    for n in (cur_len + gamma, cur_len + gamma - 1):  # a verify, then a draft forward
        got = tv2.prefix_logits(tbt_, tpt, tokens, n, cache)[0, cur_len - 1:n]
        assert rel_err(got, ref[:n - cur_len + 1]) < 1e-4


# ----------------------------------------------------------------- BiLD
def test_bild_always_fallback_equals_target_greedy(models):
    """fallback_thres 1.1 checks after every small token and rollback_thres
    0 rejects each: the output is the target's greedy path
    (``tests/test_algorithms.py:47-58``)."""
    (bd, pd, bt, pt), (tbd, tpd, tbt_, tpt) = models
    ar = t_ar(tbt_, tpt, PROMPT, 12, eos_token_id=EOS, top_k=1, device="cpu")
    kw = dict(gamma=5, fallback_thres=1.1, rollback_thres=0.0, eos_token_id=EOS, top_k=1,
              details=True)
    jo, jd = jbi.bild_generate(bd, pd, bt, pt, PROMPT, 12, key=jax.random.key(1), **kw)
    to, td = tbi.bild_generate(tbd, tpd, tbt_, tpt, PROMPT, 12, device="cpu", **kw)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(to[:len(ar)], ar)
    assert sorted(td) == sorted(jd)
    assert math.isnan(td["acc_rate"]) and math.isnan(jd["acc_rate"])
    for k in ("acc_len", "accepted_count", "target_call_times", "approx_call_times"):
        assert td[k] == jd[k], k


def test_bild_never_rollback_keeps_small_tokens(models):
    """rollback_thres huge accepts every unchecked token: the small model
    drives, with a target token every gamma tokens
    (``tests/test_algorithms.py:61-73``)."""
    (bd, pd, bt, pt), (tbd, tpd, tbt_, tpt) = models
    small = t_ar(tbd, tpd, PROMPT, 12, eos_token_id=EOS, top_k=1, device="cpu")
    kw = dict(gamma=4, fallback_thres=0.0, rollback_thres=1e9, eos_token_id=EOS, top_k=1,
              details=True)
    jo, jd = jbi.bild_generate(bd, pd, bt, pt, PROMPT, 12, key=jax.random.key(1), **kw)
    to, td = tbi.bild_generate(tbd, tpd, tbt_, tpt, PROMPT, 12, device="cpu", **kw)
    np.testing.assert_array_equal(to, jo)
    p = len(PROMPT)
    np.testing.assert_array_equal(to[p:p + 3], small[p:p + 3])
    assert td["target_call_times"] < td["approx_call_times"]
    assert td["acc_len"] == jd["acc_len"]


# ---------------------------------------------------------- random beam
def test_random_beam_single_width_greedy_equals_jax_and_ar(models):
    (_, _, bt, pt), (_, _, tbt_, tpt) = models
    ar = t_ar(tbt_, tpt, PROMPT, 12, eos_token_id=EOS, top_k=1, device="cpu")
    kw = dict(max_num_beams=1, min_num_beams=1, eos_token_id=EOS, top_k=1, details=True)
    jo, jd = jrb.random_width_beam_generate(bt, pt, PROMPT, 12, key=jax.random.key(1), **kw)
    to, td = trb.random_width_beam_generate(tbt_, tpt, PROMPT, 12, device="cpu", **kw)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(to[:len(ar)], ar)
    assert sorted(td) == sorted(jd)
    assert td["target_call_times"] == jd["target_call_times"]


@pytest.mark.parametrize("top_k", [8, 0], ids=["sparse", "dense"])
def test_random_beam_multi_width_runs(models, top_k):
    _, (_, _, tbt_, tpt) = models
    for seed in range(3):
        out = trb.random_width_beam_generate(tbt_, tpt, PROMPT, 12, max_num_beams=4,
                                             min_num_beams=2, eos_token_id=EOS, top_k=top_k,
                                             generator=torch.Generator().manual_seed(seed),
                                             device="cpu")
        np.testing.assert_array_equal(out[:len(PROMPT)], PROMPT)
        assert len(PROMPT) < len(out) <= len(PROMPT) + 13
        assert out.min() >= 0 and out.max() < 64


# ------------------------------------------- whole runs under fixed noise
@pytest.mark.parametrize("top_k", [8, 0], ids=["sparse", "dense"])
@pytest.mark.parametrize("engine", ["v2", "bild", "random_beam"])
def test_runs_match_jax_under_fixed_noise(models, monkeypatch, engine, top_k):
    """Every draw deterministic and equal on both sides; 19 new tokens (a
    budget no other test compiles the JAX engines with, so no other test
    reuses these traces), top_p 0.9. BiLD at gamma 4 steps both with and
    without a check, and rolls back; random beam's width is fixed at 3 (its
    width draw is the one draw the noise does not fix)."""
    (bd, pd, bt, pt), (tbd, tpd, tbt_, tpt) = models
    u0 = float(torch.rand((), generator=torch.Generator().manual_seed(5)))
    patch_noise(monkeypatch, uniform=u0)
    kw = dict(eos_token_id=-1, top_k=top_k, top_p=0.9, details=True)
    if engine == "v2":
        jo, jd = jv2.speculative_generate_v2(bd, pd, bt, pt, PROMPT, 19, gamma=3, random_seed=5,
                                             key=jax.random.key(0), **kw)
        to, td = tv2.speculative_generate_v2(tbd, tpd, tbt_, tpt, PROMPT, 19, gamma=3,
                                             random_seed=5, device="cpu", **kw)
        assert td["acc_rate"] == pytest.approx(jd["acc_rate"], abs=1e-5)
        counts = ("acc_len", "accepted_count", "target_call_times")
    elif engine == "bild":
        # this pair's draft is flat (its largest probability under 0.15 at
        # top_k 8, 0.04 dense): thresholds under that mix both kinds of step
        kw.update(gamma=4, fallback_thres=0.1 if top_k else 0.02,
                  rollback_thres=3.0 if top_k else 4.0)
        jo, jd = jbi.bild_generate(bd, pd, bt, pt, PROMPT, 19, key=jax.random.key(0), **kw)
        to, td = tbi.bild_generate(tbd, tpd, tbt_, tpt, PROMPT, 19, device="cpu", **kw)
        counts = ("acc_len", "accepted_count", "target_call_times", "approx_call_times")
        assert td["approx_call_times"] > td["target_call_times"] >= 2
    else:
        kw.update(max_num_beams=3, min_num_beams=3)
        jo, jd = jrb.random_width_beam_generate(bt, pt, PROMPT, 19, key=jax.random.key(0), **kw)
        to, td = trb.random_width_beam_generate(tbt_, tpt, PROMPT, 19, device="cpu", **kw)
        counts = ("tokens_generated", "target_call_times")
    np.testing.assert_array_equal(to, jo)
    assert sorted(td) == sorted(jd)
    for k in counts:
        assert td[k] == jd[k], k


# --------------------------------------------------------------- phases
def test_phase_calibration_full_mode(models):
    """``draft_mode='full'`` (v2's split) is its own calibration: gamma
    full-buffer draft forwards, a full-buffer verify."""
    _, (tbd, tpd, tbt_, tpt) = models
    kw = dict(draft_rows=1, verify_rows=1, gamma=3, verify_tokens=4, max_total=64, device="cpu")
    loop = tph.calibrate_phase_times(tbd, tpd, tbt_, tpt, **kw)
    full = tph.calibrate_phase_times(tbd, tpd, tbt_, tpt, draft_mode="full", **kw)
    assert loop != full and all(t > 0 for t in loop + full)
    d = tph.fill_phase_split({}, 10.0, 5, tbd, tpd, tbt_, tpt, draft_mode="full", **kw)
    assert d["approx_time"] == pytest.approx(5 * full[0])
    assert d["target_time"] == pytest.approx(5 * full[1])
