"""The port's engines (``engine/*``) against the JAX engines on converted
weights, plus the port's boundaries.

* ``accept_phase``: identical decisions for the same p/q stacks and fixed
  uniforms (``fixed_r``), sparse and dense.
* Whole slice at top_k=1: p and q are one-hot, so AR and speculative
  decoding are deterministic; the port must give JAX's tokens one for one,
  for a dense fp32 pair and an int8-weight pair.
* The ``details`` key sets equal JAX's (fused, stepwise, AR).
* Acceptance profile at top_k=20, top_p=0.9: acc_rate is the mean of
  min(1, p/q) over the drafted tokens, a function of the contexts the two
  engines sample with different random bits; over 6 runs of 40 tokens each
  mean has a standard error near 0.02, so the two means must agree within
  0.08.
* The package imports neither ``jax`` nor ``llmspeculativesampling_tpu``,
  and its entry points refuse to fall back to the CPU silently.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine import speculative as jspec
from llmspeculativesampling_tpu.engine.autoregressive import autoregressive_generate as j_ar
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.ops import sampling as js
from llmspeculativesampling_tpu.quant.core import quantize_params as jquant
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine import speculative as tspec
from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate as t_ar
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.ops import sampling as ts

from _torch_port import to_port

PROMPT = [3, 14, 15, 9, 26, 5]
EOS = 127
ROOT = Path(__file__).resolve().parents[1]


def _pair(int8=False):
    """Draft (1 layer) and target (2 layers): vocab 128, hidden 128, two
    heads of 64, so the port's decode/verify steps take the flash path. The
    int8 target's seed gives greedy top-2 gaps of 2.5% of the largest logit."""
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
def dense_pair():
    return _pair()


def _stacks(seed, k, gamma=4, vocab=40, close=True):
    rng = np.random.default_rng(seed)
    ql = rng.standard_normal((gamma, vocab)).astype(np.float32) * 2
    pl = np.concatenate([ql, rng.standard_normal((1, vocab)).astype(np.float32)])
    pl = pl + rng.standard_normal(pl.shape).astype(np.float32) * (0.3 if close else 3.0)
    return ql, pl


@pytest.mark.parametrize("top_k", [20, 0])
@pytest.mark.parametrize("seed", range(4))
def test_accept_phase_decisions_match_jax(seed, top_k):
    gamma = 4
    ql, pl = _stacks(seed, top_k, gamma, close=seed % 2 == 0)
    jcfg, tcfg = js.SamplingConfig(1.0, top_k, 0.9), ts.SamplingConfig(1.0, top_k, 0.9)
    jq, jp = js.dist_norm(jnp.asarray(ql), jcfg), js.dist_norm(jnp.asarray(pl), jcfg)
    tq, tp = ts.dist_norm(torch.from_numpy(ql), tcfg), ts.dist_norm(torch.from_numpy(pl), tcfg)
    drafts = np.asarray([int(np.argmax(ql[i])) if i % 2 else int(np.argsort(ql[i])[-2])
                         for i in range(gamma)], np.int32)
    for r in (0.05, 0.5, 0.95):
        fixed = np.full(gamma, r, np.float32)
        jt = jnp.zeros((1, 32), jnp.int32)
        tt = torch.zeros((1, 32), dtype=torch.long)
        j_out = jspec.accept_phase(jcfg, gamma, EOS, jt, jnp.asarray(10), jq, jnp.asarray(drafts),
                                   jp, jax.random.key(0), jnp.asarray(fixed))
        t_out = tspec.accept_phase(tcfg, gamma, EOS, tt, 10, tq, torch.from_numpy(drafts).long(),
                                   tp, torch.Generator().manual_seed(0), torch.from_numpy(fixed))
        _, j_len, _, j_n, j_all, j_rate, _ = j_out
        _, t_len, t_t, t_n, t_all, t_rate = t_out
        assert int(t_n) == int(j_n) and int(t_len) == int(j_len) and bool(t_all) == bool(j_all)
        np.testing.assert_allclose(float(t_rate), float(j_rate), rtol=1e-6)
        assert int(t_out[0][0, int(t_len) - 1]) == int(t_t)


def _gen_both(pair, new, gamma, top_k, **kw):
    (jbd, jpd, tbd, tpd), (jbt, jpt, tbt, tpt) = pair
    j_a = j_ar(jbt, jpt, PROMPT, new, eos_token_id=EOS, top_k=top_k, key=jax.random.key(0), **kw)
    t_a = t_ar(tbt, tpt, PROMPT, new, eos_token_id=EOS, top_k=top_k, device="cpu", **kw)
    j_s = jspec.speculative_generate(jbd, jpd, jbt, jpt, PROMPT, new, gamma=gamma, eos_token_id=EOS,
                                     top_k=top_k, key=jax.random.key(1), **kw)
    t_s = tspec.speculative_generate(tbd, tpd, tbt, tpt, PROMPT, new, gamma=gamma, eos_token_id=EOS,
                                     top_k=top_k, device="cpu", **kw)
    return j_a, t_a, j_s, t_s


@pytest.mark.parametrize("int8", [False, True])
def test_greedy_tokens_equal_jax(int8, dense_pair):
    pair = _pair(int8=True) if int8 else dense_pair
    j_a, t_a, j_s, t_s = _gen_both(pair, 20, 4, top_k=1)
    if int8:
        # the precondition of token equality: at every greedy step the
        # top-2 logit gap is wider than the 5e-3 (relative) int8 forward
        # tolerance of tests/test_torch_llama.py
        (_, _, tbt, tpt) = pair[1]
        seq = torch.as_tensor(np.asarray(j_a), dtype=torch.long)[None]
        logits, _ = tbt.forward(tpt, tbt.cfg, seq, tbt.make_cache(1, 64, device="cpu"))
        top2 = logits[0, len(PROMPT) - 1:-1].topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 5e-3 * float(logits.abs().max())
    np.testing.assert_array_equal(t_a, j_a)
    np.testing.assert_array_equal(t_s, j_s)
    np.testing.assert_array_equal(t_s[: len(t_a)], t_a)
    for gamma in (1, 3):
        (jbd, jpd, tbd, tpd), (jbt, jpt, tbt, tpt) = pair
        out = tspec.speculative_generate(tbd, tpd, tbt, tpt, PROMPT, 20, gamma=gamma,
                                         eos_token_id=EOS, top_k=1, device="cpu")
        np.testing.assert_array_equal(out[: len(t_a)], t_a)


def test_details_keys_equal_jax(dense_pair):
    (jbd, jpd, tbd, tpd), (jbt, jpt, tbt, tpt) = dense_pair
    kw = dict(gamma=3, eos_token_id=-1, top_k=10, top_p=0.9, details=True)
    for stepwise in (False, True):
        _, jd = jspec.speculative_generate(jbd, jpd, jbt, jpt, PROMPT, 8, key=jax.random.key(1),
                                           stepwise=stepwise, **kw)
        _, td = tspec.speculative_generate(tbd, tpd, tbt, tpt, PROMPT, 8, device="cpu",
                                           stepwise=stepwise, **kw)
        assert set(td) == set(jd), set(td) ^ set(jd)
        assert all(v is not None for v in td.values())
        assert td["target_call_times"] == len(td["acc_len"])
    _, jd = j_ar(jbt, jpt, PROMPT, 8, eos_token_id=-1, details=True)
    _, td = t_ar(tbt, tpt, PROMPT, 8, eos_token_id=-1, details=True, device="cpu")
    assert set(td) == set(jd)


def test_acceptance_profile_matches_jax(dense_pair):
    (jbd, jpd, tbd, tpd), (jbt, jpt, tbt, tpt) = dense_pair
    kw = dict(gamma=4, eos_token_id=-1, top_k=20, top_p=0.9, details=True)
    j_rates, t_rates = [], []
    for seed in range(6):
        _, jd = jspec.speculative_generate(jbd, jpd, jbt, jpt, PROMPT, 40,
                                           key=jax.random.key(100 + seed), **kw)
        _, td = tspec.speculative_generate(tbd, tpd, tbt, tpt, PROMPT, 40, device="cpu",
                                           generator=torch.Generator().manual_seed(seed), **kw)
        j_rates.append(jd["acc_rate"])
        t_rates.append(td["acc_rate"])
    assert abs(np.mean(t_rates) - np.mean(j_rates)) < 0.08, (t_rates, j_rates)


def test_identical_models_accept_everything(dense_pair):
    _, (_, _, tbt, tpt) = dense_pair
    out, d = tspec.speculative_generate(tbt, tpt, tbt, tpt, PROMPT, 16, gamma=4, eos_token_id=-1,
                                        top_k=20, top_p=0.9, details=True, device="cpu")
    assert d["resample_count"] == 0 and d["accepted_count"] == 4 * d["target_call_times"]
    assert d["acc_rate"] > 0.999 and len(out) >= len(PROMPT) + 16


def test_random_seed_reuses_one_uniform(dense_pair):
    (_, _, tbd, tpd), (_, _, tbt, tpt) = dense_pair
    kw = dict(gamma=3, eos_token_id=-1, top_k=20, details=True, device="cpu", random_seed=7)
    a, da = tspec.speculative_generate(tbd, tpd, tbt, tpt, PROMPT, 12,
                                       generator=torch.Generator().manual_seed(0), **kw)
    b, db = tspec.speculative_generate(tbd, tpd, tbt, tpt, PROMPT, 12,
                                       generator=torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(a, b)
    assert da["acc_len"] == db["acc_len"]


def test_package_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, llmspeculativesampling_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'llmspeculativesampling_tpu.'))"
        " or m == 'llmspeculativesampling_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    for path in list((ROOT / "llmspeculativesampling_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert not words[1].startswith(("jax", "llmspeculativesampling_tpu.")), (path, line)
                assert words[1] != "llmspeculativesampling_tpu", (path, line)


def test_default_device_without_cuda_raises(monkeypatch, dense_pair):
    from llmspeculativesampling_tpu_torch.core import synthetic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _, tbd, tpd), (_, _, tbt, tpt) = dense_pair
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tspec.speculative_generate(tbd, tpd, tbt, tpt, PROMPT, 4, eos_token_id=EOS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ar(tbt, tpt, PROMPT, 4, eos_token_id=EOS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic.synthetic_pair_int8_small_draft(hidden_size=256, num_layers=2, num_heads=2,
                                                  draft_hidden=128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbt.make_cache(1, 64)


def test_synthetic_small_draft_pair_embeds_the_draft():
    """At damp=0 the deep target layers add nothing, so target logits equal
    draft logits up to bf16 rounding (the construction of core/synthetic.py)."""
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8_small_draft

    bd, pd, bt, pt = synthetic_pair_int8_small_draft(
        hidden_size=256, intermediate_size=512, num_layers=3, num_heads=2, vocab_size=256,
        draft_hidden=128, draft_intermediate=256, damp=0.0, device="cpu")
    assert pt["layers"]["wq"]["q"].dtype == torch.int8 and bd.cfg.num_heads == 1
    toks = torch.arange(10, 30).reshape(1, 20)
    ld, _ = bd.forward(pd, bd.cfg, toks, bd.make_cache(1, 64, device="cpu"))
    lt, _ = bt.forward(pt, bt.cfg, toks, bt.make_cache(1, 64, device="cpu"))
    assert float((ld - lt).abs().max() / ld.abs().max()) < 3e-2
    assert float((ld.argmax(-1) == lt.argmax(-1)).float().mean()) > 0.9
