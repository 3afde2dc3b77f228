"""The port's multi-candidate and tree/beam engines (``engine/multi.py``,
``engine/beam_draft.py``, ``engine/beam_tree.py``) against the JAX engines
on converted weights, on the CPU.

* Greedy (top_k=1): p and q are one-hot, so every engine is deterministic
  and the port must give JAX's ids one for one, and the port's own
  autoregressive ids where the engine reduces to the target's greedy path
  (multi iid, v2, v1 with the draft equal to the target). v2 with the
  draft equal to the target accepts every level, so its runs also go
  through the tree compaction and the draft-cache rebuild every step.
* The ``details`` key sets equal JAX's.
* multi's 'beam' / 'acc_beam' strategies run the beam-draft engine
  (``tests/test_torch_beam_spec.py`` holds it against JAX); the package
  exports every engine name and alias of the JAX package.
* The acceptance statistics of v2 and multi on a pair whose draft is
  close to its target match JAX's within a few standard errors.
* v1's always-accept quirk (the reference's ``p/(q+1e-5) > r - 1``): every
  step advances all gamma levels and acc_rate is exactly 1.
* First-token distributions against the oracles of
  ``tests/test_distribution_parity.py``: multi iid at gamma=1 against the
  reference's accept rule (here in closed form), v2 at num_beams=1 against
  the target, v1 at num_beams=1 against the draft. N = 1600 draws a
  engine (JAX uses 20,000): over the 8-token support of these models the
  total variation of an exact sampler's histogram is 0.026 on average at
  this N, with a standard deviation of 0.008 and a 99.9th percentile of
  0.054 (multinomial simulation), so a correct engine stays well under
  TV_TOL; v1's draws lie 0.77 from the target's distribution.
"""

import numpy as np
import jax
import pytest
import torch

from llmspeculativesampling_tpu.core.synthetic import synthetic_pair
from llmspeculativesampling_tpu.engine import beam_tree as jbt
from llmspeculativesampling_tpu.engine import multi as jm
from llmspeculativesampling_tpu.engine.types import pad_prompt
from llmspeculativesampling_tpu.ops.sampling import SamplingConfig as JSCfg, norm_logits as j_norm
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine import beam_spec as tbs
from llmspeculativesampling_tpu_torch.engine import beam_tree as tbt
from llmspeculativesampling_tpu_torch.engine import multi as tm
from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate as t_ar
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import llama as tl

from _torch_port import one_thread, to_port  # noqa: F401 (fixture)
from test_speculative import EOS, PROMPT, make_bundle

TOPK = 8
N_DRAWS = 1600
TV_TOL = 0.07


def _port(jb, jp):
    cfg = TCfg(**{f: getattr(jb.cfg, f) for f in TCfg.__dataclass_fields__})
    return TBundle("llama", cfg, tl.forward), to_port(jp)


@pytest.fixture(scope="module")
def models():
    """(JAX draft, params, JAX target, params) and the port's copies: the
    draft has 1 layer, the target 2 (vocab 64, hidden 32)."""
    bd, pd = make_bundle(1, seed=10)
    bt, pt = make_bundle(2, seed=20)
    return (bd, pd, bt, pt), (*_port(bd, pd), *_port(bt, pt))


@pytest.fixture(scope="module")
def greedy_ar(models):
    _, (_, _, tbt_, tpt) = models
    return t_ar(tbt_, tpt, PROMPT, 16, eos_token_id=EOS, top_k=1, device="cpu")


def test_multi_greedy_equals_jax_and_ar(models, greedy_ar):
    (bd, pd, bt, pt), (tbd, tpd, tbt_, tpt) = models
    jo, jd = jm.multi_speculative_generate(bd, pd, bt, pt, PROMPT, 16, gamma=3, width=4,
                                           eos_token_id=EOS, top_k=1, key=jax.random.key(1),
                                           details=True)
    to, td = tm.multi_speculative_generate(tbd, tpd, tbt_, tpt, PROMPT, 16, gamma=3, width=4,
                                           eos_token_id=EOS, top_k=1, details=True, device="cpu")
    np.testing.assert_array_equal(to, jo)
    assert sorted(td) == sorted(jd)
    assert td["acc_len"] == jd["acc_len"]
    for width in (1, 4):
        out = tm.multi_speculative_generate(tbd, tpd, tbt_, tpt, PROMPT, 16, gamma=3, width=width,
                                            eos_token_id=EOS, top_k=1, device="cpu")
        np.testing.assert_array_equal(out[:len(greedy_ar)], greedy_ar)


def test_multi_strategies_outside_iid_raise(models):
    """'diverse' raises, as in the reference; 'beam' and 'acc_beam' run
    the beam-draft engine with num_beams = max(4, width), as JAX's
    dispatch does."""
    _, (tbd, tpd, tbt_, tpt) = models
    with pytest.raises(NotImplementedError):
        tm.multi_speculative_generate(tbd, tpd, tbt_, tpt, PROMPT, 4, strategy="diverse",
                                      eos_token_id=EOS, device="cpu")
    kw = dict(gamma=3, width=2, eos_token_id=EOS, top_k=8, top_p=0.9, device="cpu")
    ref = tbs.multi_beam_generate(tbd, tpd, tbt_, tpt, PROMPT, 8, num_beams=4,
                                  generator=torch.Generator().manual_seed(3), **kw)
    for strategy in ("beam", "acc_beam"):
        out = tm.multi_speculative_generate(tbd, tpd, tbt_, tpt, PROMPT, 8, strategy=strategy,
                                            generator=torch.Generator().manual_seed(3), **kw)
        np.testing.assert_array_equal(out, ref)


def test_engine_names_match_jax():
    """Every engine name and reference alias the JAX package exports, the
    port exports too."""
    import llmspeculativesampling_tpu as jpkg
    import llmspeculativesampling_tpu_torch as tpkg

    assert set(jpkg.__all__) <= set(tpkg.__all__)
    for name in jpkg.__all__:
        assert callable(getattr(tpkg, name)), name


@pytest.mark.parametrize("same", [False, True], ids=["distinct", "draft_is_target"])
def test_v2_greedy_equals_jax_and_ar(models, greedy_ar, same):
    (bd, pd, bt, pt), (tbd, tpd, tbt_, tpt) = models
    if same:
        bd, pd, tbd, tpd = bt, pt, tbt_, tpt
    kw = dict(gamma=3, num_beams=4, extra_sample_cnt=1, expect_thres=0.7, min_num_beams=1,
              eos_token_id=EOS, top_k=1, details=True)
    jo, jd = jbt.beam_speculative_v2_generate(bd, pd, bt, pt, PROMPT, 16, key=jax.random.key(1),
                                              **kw)
    to, td = tbt.beam_speculative_v2_generate(tbd, tpd, tbt_, tpt, PROMPT, 16, device="cpu", **kw)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(to[:len(greedy_ar)], greedy_ar)
    assert sorted(td) == sorted(jd)
    for k in ("acc_len", "expect_cnt_list", "num_beams_list", "accepted_count"):
        assert td[k] == jd[k], k
    if same:
        assert min(td["acc_len"]) == 3  # every level accepted: compaction ran each step
    kw.update(extra_sample_cnt=2, details=False)
    out = tbt.beam_speculative_v2_generate(tbd, tpd, tbt_, tpt, PROMPT, 16, device="cpu", **kw)
    np.testing.assert_array_equal(out[:len(greedy_ar)], greedy_ar)


def test_v1_greedy_equals_jax(models, greedy_ar):
    """v1 commits the draft's tokens (always accept), so at greedy it equals
    JAX's run, and the target's greedy path when the draft is the target."""
    (bd, pd, bt, pt), (tbd, tpd, tbt_, tpt) = models
    kw = dict(gamma=3, num_beams=4, min_num_beams=1, eos_token_id=EOS, top_k=1, details=True)
    jo, jd = jbt.beam_speculative_generate(bd, pd, bt, pt, PROMPT, 16, key=jax.random.key(1), **kw)
    to, td = tbt.beam_speculative_generate(tbd, tpd, tbt_, tpt, PROMPT, 16, device="cpu", **kw)
    np.testing.assert_array_equal(to, jo)
    assert sorted(td) == sorted(jd)
    assert td["acc_len"] == jd["acc_len"] and td["num_beams_list"] == jd["num_beams_list"]
    kw["details"] = False
    out = tbt.beam_speculative_generate(tbt_, tpt, tbt_, tpt, PROMPT, 16, device="cpu", **kw)
    np.testing.assert_array_equal(out[:len(greedy_ar)], greedy_ar)


def test_v1_always_accept_properties(models):
    _, (tbd, tpd, tbt_, tpt) = models
    out, d = tbt.beam_speculative_generate(
        tbd, tpd, tbt_, tpt, PROMPT, 24, gamma=3, num_beams=4, min_num_beams=1,
        eos_token_id=EOS, top_k=10, top_p=0.9, details=True, device="cpu",
        generator=torch.Generator().manual_seed(7))
    assert d["target_call_times"] >= 2, "the run must be multi-round"
    assert all(n == 3 for n in d["acc_len"]), d["acc_len"]
    assert d["accepted_count"] == 3 * d["target_call_times"]
    assert d["acc_rate"] == pytest.approx(1.0)
    assert len(out) > len(PROMPT) and out.min() >= 0 and out.max() < 64


def test_acceptance_profiles_match_jax():
    """A pair whose draft is close to its target (JAX ``synthetic_pair``:
    the draft is the target's first layer, deeper layers damped), top_k 20,
    top_p 0.9, 24 tokens, 12 seeds on each side. The engines sample with
    other random bits, so their statistics are compared: v2's mean
    accepted levels a step (4 beams; across seeds its standard deviation
    is about 0.4-0.6, so the two means differ by 0.2 or so at one standard
    error) within 0.5, and multi's acc_rate (standard deviation about 0.04)
    within 0.05."""
    bd, pd, bt, pt = synthetic_pair(hidden_size=64, num_layers=3, draft_layers=1, num_heads=2,
                                    vocab_size=128, dtype="float32", damp=0.3)
    (tbd, tpd), (tbt_, tpt) = _port(bd, pd), _port(bt, pt)
    kw = dict(eos_token_id=-1, top_k=20, top_p=0.9, details=True)
    v2 = dict(gamma=3, num_beams=4, extra_sample_cnt=1, expect_thres=0.7, **kw)
    stats = {k: ([], []) for k in ("v2_acc_len", "multi_acc_rate")}
    for seed in range(12):
        _, jd = jbt.beam_speculative_v2_generate(bd, pd, bt, pt, PROMPT, 24,
                                                 key=jax.random.key(100 + seed), **v2)
        _, td = tbt.beam_speculative_v2_generate(tbd, tpd, tbt_, tpt, PROMPT, 24, device="cpu",
                                                 generator=torch.Generator().manual_seed(seed), **v2)
        stats["v2_acc_len"][0].append(np.mean(jd["acc_len"]))
        stats["v2_acc_len"][1].append(np.mean(td["acc_len"]))
        _, jd = jm.multi_speculative_generate(bd, pd, bt, pt, PROMPT, 24, gamma=3, width=4,
                                              key=jax.random.key(100 + seed), **kw)
        _, td = tm.multi_speculative_generate(tbd, tpd, tbt_, tpt, PROMPT, 24, gamma=3, width=4,
                                              device="cpu",
                                              generator=torch.Generator().manual_seed(seed), **kw)
        stats["multi_acc_rate"][0].append(jd["acc_rate"])
        stats["multi_acc_rate"][1].append(td["acc_rate"])
    for name, tol in (("v2_acc_len", 0.5), ("multi_acc_rate", 0.05)):
        j, t = stats[name]
        assert abs(np.mean(t) - np.mean(j)) < tol, (name, np.mean(t), np.mean(j))


# ------------------------------------------------------- first-token TV
@pytest.fixture(scope="module")
def dists(models):
    """Warped first-position draft (q) and target (p) distributions (JAX)."""
    (bd, pd, bt, pt), _ = models
    scfg = JSCfg(1.0, TOPK, 0.0)
    padded, p_len = pad_prompt(PROMPT)
    ql, _ = bd.forward(pd, bd.cfg, padded, bd.make_cache(1, 64))
    pl, _ = bt.forward(pt, bt.cfg, padded, bt.make_cache(1, 64))
    return (np.asarray(j_norm(ql[:, p_len - 1], scfg), np.float64)[0],
            np.asarray(j_norm(pl[:, p_len - 1], scfg), np.float64)[0])


def _tv(draws, ref):
    hist = np.bincount(np.asarray(draws), minlength=len(ref)) / len(draws)
    return 0.5 * np.abs(hist - ref).sum()


def _first_tokens(run):
    g = torch.Generator().manual_seed(11)
    return [int(run(g)[len(PROMPT)]) for _ in range(N_DRAWS)]


def test_multi_iid_first_token_matches_oracle(models, dists):
    """gamma=1, width 3: each candidate x ~ q is accepted with a(x) =
    min(1, p/q); the first accepted one wins, else the residual
    max_fn(p - q) is drawn: P(t) = q a (1 + b + b^2) + b^3 resid, with
    b = 1 - sum q a."""
    _, (tbd, tpd, tbt_, tpt) = models
    q, p = dists
    width = 3
    draws = _first_tokens(lambda g: tm.multi_speculative_generate(
        tbd, tpd, tbt_, tpt, PROMPT, 1, gamma=1, width=width, eos_token_id=-1, top_k=TOPK,
        generator=g, device="cpu"))
    a = np.minimum(np.divide(p, q, out=np.zeros_like(p), where=q > 0), 1.0)
    beta = 1.0 - (q * a).sum()
    resid = np.maximum(p - q, 0.0)
    resid /= resid.sum()
    oracle = q * a * sum(beta ** i for i in range(width)) + beta ** width * resid
    tv = _tv(draws, oracle)
    assert tv < TV_TOL, f"multi iid vs oracle TV {tv:.4f}"


def test_v2_one_beam_first_token_matches_target(models, dists):
    """At num_beams=1 the dynamic-width walk is plain speculative
    sampling: the first token is target-distributed."""
    _, (tbd, tpd, tbt_, tpt) = models
    _, p = dists
    draws = _first_tokens(lambda g: tbt.beam_speculative_v2_generate(
        tbd, tpd, tbt_, tpt, PROMPT, 1, gamma=2, num_beams=1, extra_sample_cnt=1,
        eos_token_id=-1, top_k=TOPK, generator=g, device="cpu"))
    tv = _tv(draws, p)
    assert tv < TV_TOL, f"beam_v2(b=1) vs target TV {tv:.4f}"


def test_v1_one_beam_first_token_matches_draft(models, dists):
    """v1 always accepts, so its first token at num_beams=1 is
    draft-distributed (the reference's semantics)."""
    _, (tbd, tpd, tbt_, tpt) = models
    q, _ = dists
    draws = _first_tokens(lambda g: tbt.beam_speculative_generate(
        tbd, tpd, tbt_, tpt, PROMPT, 1, gamma=2, num_beams=1, eos_token_id=-1, top_k=TOPK,
        generator=g, device="cpu"))
    tv = _tv(draws, q)
    assert tv < TV_TOL, f"beam_v1(b=1) vs draft TV {tv:.4f}"
