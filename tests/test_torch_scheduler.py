"""The port's slotted continuous-batching engine
(``serve/scheduler.py::ContinuousBatchingEngine``) against the JAX engine,
the ports of tests/test_scheduler.py, the per-row device lengths of the
contiguous cache under it (``cache/kvcache.py``, the models' attention
dispatch), and the subpackage exports of both packages.

* At top_k=1 both engines are deterministic (one-hot p and q), so the port
  must give JAX's output ids token for token; the pair's fp32 logits agree
  to 2e-4 (tests/test_torch_paged.py), far inside the greedy top-2 gaps.
* A forward through a cache with per-row device lengths must give, row by
  row, the logits of a B=1 forward through the host-int cache at that
  row's length: fp32, 1e-5 relative to the largest logit.
"""

import dataclasses
import importlib
import inspect

import numpy as np
import jax
import pytest
import torch

from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.serve.scheduler import ContinuousBatchingEngine as JEngine
from llmspeculativesampling_tpu_torch.cache.kvcache import install_rows, kv_buffers, rollback_rows
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.core.config import OPTConfig as TOCfg
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.models import opt as to
from llmspeculativesampling_tpu_torch.serve import scheduler as tsched
from llmspeculativesampling_tpu_torch.serve.scheduler import ContinuousBatchingEngine

from _torch_port import one_thread, rel_err, to_port  # noqa: F401 (fixture)

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
          num_kv_heads=4, max_position=512, dtype="float32")
# tests/test_scheduler.py's engine settings
ENGINE = dict(num_slots=3, max_total_len=256, max_new_cap=64, gamma=3, eos_token_id=-1,
              top_k=10, top_p=0.9)
DETAILS = {"ttft_s", "latency_s", "acc_len", "acc_rate", "target_call_times",
           "approx_call_times", "accepted_count", "resample_count", "target_sample_count",
           "tokens_generated"}


@pytest.fixture(scope="module")
def pair():
    """tests/test_scheduler.py's pair: a 2-layer target and its first layer
    as the draft, as JAX and as converted port params."""
    pt = jl.init_params(JCfg(**KW), jax.random.key(0))
    pd = {"embed": pt["embed"], "ln_final": pt["ln_final"], "lm_head": pt["lm_head"],
          "layers": jax.tree.map(lambda x: x[:1], pt["layers"])}
    return pd, pt, to_port(pd), to_port(pt)


def _bundles(kv_quant=False, flash="auto"):
    cfg = TCfg(**{**KW, "flash": flash})
    return (TBundle("llama", dataclasses.replace(cfg, num_layers=1), tl.forward),
            TBundle("llama", cfg, tl.forward, kv_quant=kv_quant))


def _engine(pair, kv_quant=False, flash="auto", **kw):
    _, _, tpd, tpt = pair
    bd, bt = _bundles(kv_quant, flash)
    return ContinuousBatchingEngine(bd, tpd, bt, tpt, device="cpu", **{**ENGINE, **kw})


# ------------------------------------------------------------------ vs JAX

# three prompts of 12/20/16 tokens and a fourth that waits for a free slot
# of the three; a fifth is submitted after the first chunk (mid-flight)
PROMPTS = [list(range(5, 5 + n)) for n in (12, 20, 16)] + [list(range(40, 54))]
NEWS = [12, 7, 16, 9]
LATE = (list(range(60, 78)), 10)


def _greedy_run(eng):
    rids = [eng.submit(p, n) for p, n in zip(PROMPTS, NEWS)]
    eng.step()
    rids.append(eng.submit(*LATE))
    eng.run_until_idle()
    return [eng.result(r) for r in rids]


@pytest.fixture(scope="module")
def jax_greedy(pair):
    """The JAX engine's completions at top_k=1, dense and int8-KV target."""
    jpd, jpt, _, _ = pair
    out = {}
    for kv_quant in (False, True):
        cfg = JCfg(**KW)
        je = JEngine(JBundle("llama", JCfg(**{**KW, "num_layers": 1}), jl.forward), jpd,
                     JBundle("llama", cfg, jl.forward, kv_quant=kv_quant), jpt,
                     **{**ENGINE, "top_k": 1, "steps_per_sync": 2})
        out[kv_quant] = _greedy_run(je)
    return out


@pytest.mark.parametrize("flash", ["on", "off"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_ids_equal_jax(pair, jax_greedy, kv_quant, flash):
    """Five requests over three slots, one waiting for a slot and one
    admitted mid-flight; ``flash="on"`` takes B2's plain version with
    per-row lengths, ``"off"`` the einsum path with per-row masks."""
    te = _engine(pair, kv_quant, flash, top_k=1, steps_per_sync=2)
    for jc, tc in zip(jax_greedy[kv_quant], _greedy_run(te)):
        np.testing.assert_array_equal(tc.output_ids, np.asarray(jc.output_ids))
        assert tc.details["acc_len"] == jc.details["acc_len"]
        assert set(tc.details) == set(jc.details) == DETAILS
    assert te.num_active == 0 and not te._pending


def test_signature_matches_jax():
    """JAX's constructor parameters and defaults, plus ``device``."""
    jp = inspect.signature(JEngine.__init__).parameters
    tp = inspect.signature(ContinuousBatchingEngine.__init__).parameters
    assert list(tp) == list(jp) + ["device"]
    assert all(tp[k].default == jp[k].default for k in jp)


# ------------------------------------------------------------ model level

def _row_length_case(bundle, params, lens, s_new, seed):
    """Prefill B=1 host-int caches to ``lens``, copy them into one B-row
    cache with per-row device lengths, run one ``s_new``-token forward
    through both. Returns (batched logits, [B=1 logits], batched cache,
    [B=1 caches])."""
    b, cfg = len(lens), bundle.cfg
    rng = np.random.default_rng(seed)
    s_max = 64
    singles = []
    big = rollback_rows(bundle.make_cache(b, s_max, device="cpu"),
                        torch.tensor(lens, dtype=torch.int32))
    for i, n in enumerate(lens):
        c = bundle.make_cache(1, s_max, device="cpu")
        if n:
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)))
            _, c = bundle.forward(params, cfg, toks, c)
        install_rows(big, torch.tensor([i]), c)
        singles.append(c)
    new = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s_new)))
    logits, big = bundle.forward(params, cfg, new, big)
    outs = []
    for i, c in enumerate(singles):
        lo, singles[i] = bundle.forward(params, cfg, new[i:i + 1], c)
        outs.append(lo)
    return logits, outs, big, singles


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("flash", ["on", "off"])
def test_row_length_forward_matches_single_rows(kv_quant, flash):
    """Llama, a verify-sized block (9) and a decode step (1) at per-row
    lengths 0, 5, 17, 30: each row's logits and cache equal a B=1 forward
    through the host-int cache; the lengths advance on the device."""
    cfg = TCfg(**{**KW, "flash": flash})
    params = tl.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    bundle = TBundle("llama", cfg, tl.forward, kv_quant=kv_quant)
    lens = [0, 5, 17, 30]
    for s_new in (9, 1):
        logits, outs, big, singles = _row_length_case(bundle, params, lens, s_new, seed=s_new)
        for i in range(len(lens)):
            assert rel_err(logits[i:i + 1], outs[i]) < 1e-5
            for a, s in zip(kv_buffers(big), kv_buffers(singles[i])):
                np.testing.assert_allclose(a[:, i:i + 1, :, :lens[i] + s_new].numpy(),
                                           s[:, :, :, :lens[i] + s_new].numpy(), atol=1e-6)
        assert big.lengths.tolist() == [n + s_new for n in lens]
        assert big.length == 0  # the host length is not used


def test_row_length_forward_opt():
    """One OPT forward (learned positions from the device lengths, the
    einsum path past B2's 32 new tokens) matches B=1 host-int forwards."""
    cfg = TOCfg(vocab_size=128, hidden_size=64, ffn_dim=128, num_layers=2, num_heads=4,
                max_position=128, dtype="float32")
    params = to.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    bundle = TBundle("opt", cfg, to.forward)
    for s_new in (5, 33):
        logits, outs, _, _ = _row_length_case(bundle, params, [3, 0, 12], s_new, seed=7)
        for i, lo in enumerate(outs):
            assert rel_err(logits[i:i + 1], lo) < 1e-5


# ---------------------------------------- tests/test_scheduler.py, ported

def test_single_request_completes_with_budget(pair):
    eng = _engine(pair)
    rid = eng.submit(list(range(5, 25)), max_new_tokens=16)
    eng.run_until_idle()
    c = eng.result(rid)
    gen = len(c.output_ids) - c.prompt_len
    assert 16 <= gen <= 16 + eng.gamma  # 1..gamma+1 tokens a step
    assert (c.output_ids >= 0).all() and (c.output_ids < 128).all()
    assert c.details["target_call_times"] >= 4
    assert sum(c.details["acc_len"]) == c.details["accepted_count"]
    assert 0.0 <= c.details["acc_rate"] <= 1.0
    assert set(c.details) == DETAILS


def test_many_requests_reuse_slots(pair):
    eng = _engine(pair, num_slots=2)
    rng = np.random.default_rng(0)
    wants = (8, 12, 5, 9, 7)
    rids = [eng.submit(rng.integers(2, 120, size=rng.integers(4, 30)).tolist(), n) for n in wants]
    eng.run_until_idle()
    assert eng.num_active == 0 and not eng._pending
    for rid, want in zip(rids, wants):
        c = eng.result(rid)
        assert want <= len(c.output_ids) - c.prompt_len <= want + eng.gamma


def test_staggered_admission_mid_flight(pair):
    eng = _engine(pair, num_slots=2)
    r1 = eng.submit(list(range(3, 23)), max_new_tokens=20)
    eng.step()  # r1 in flight
    r2 = eng.submit(list(range(40, 52)), max_new_tokens=6)
    eng.run_until_idle()
    c1, c2 = eng.result(r1), eng.result(r2)
    assert np.array_equal(c1.output_ids[:20], np.arange(3, 23))
    assert np.array_equal(c2.output_ids[:12], np.arange(40, 52))
    assert 6 <= len(c2.output_ids) - 12 <= 6 + eng.gamma


def test_quantized_kv_target_scheduler(pair):
    eng = _engine(pair, kv_quant=True)
    assert eng.state.target_cache.k_q.dtype == torch.int8
    rid = eng.submit(list(range(10, 30)), max_new_tokens=10)
    eng.run_until_idle()
    c = eng.result(rid)
    assert 10 <= len(c.output_ids) - c.prompt_len <= 10 + eng.gamma


def test_eos_stops_generation(pair):
    """The most frequent token of a run without EOS becomes the EOS of a
    second run with the same seed and rid (so the same stream): that run
    ends at the first place the first run sampled it."""
    eng = _engine(pair)
    rid = eng.submit(list(range(5, 25)), max_new_tokens=32)
    eng.run_until_idle()
    gen = eng.result(rid).output_ids[20:]
    eos = int(np.bincount(gen).argmax())
    eng2 = _engine(pair, eos_token_id=eos)
    rid2 = eng2.submit(list(range(5, 25)), max_new_tokens=32)
    eng2.run_until_idle()
    gen2 = eng2.result(rid2).output_ids[20:]
    hits = np.nonzero(gen2 == eos)[0]
    assert hits.size and hits[0] == len(gen2) - 1
    assert len(gen2) == int(np.nonzero(gen == eos)[0][0]) + 1


def test_validation_errors(pair):
    eng = _engine(pair, max_total_len=64)
    with pytest.raises(ValueError, match="at least 2"):
        eng.submit([1], max_new_tokens=4)
    with pytest.raises(ValueError, match="max_total_len"):
        eng.submit(list(range(2, 60)), max_new_tokens=64)


def test_chunked_sync_outputs_match_per_step_sync(pair):
    """steps_per_sync must not change results: a finished slot freezes
    mid-chunk (the keep gate)."""
    outs = {}
    for sps in (1, 3):
        eng = _engine(pair, steps_per_sync=sps, seed=7)
        rids = [eng.submit(list(range(5, 25)), max_new_tokens=9),
                eng.submit(list(range(30, 55)), max_new_tokens=14)]
        eng.run_until_idle()
        outs[sps] = [eng.result(r).output_ids for r in rids]
    for a, b in zip(outs[1], outs[3]):
        np.testing.assert_array_equal(a, b)


def test_batched_prefill_matches_sequential_admission(pair, monkeypatch):
    """A burst of three (one prefill of K=4 with a dropped padding row)
    gives the ids of a trickle (one K=1 prefill each): per-request streams
    keyed by (seed, rid), slots independent of one another."""
    sizes = []
    prefill = tsched._prefill_slots

    def spy(params_d, params_t, state, slots, prompts, *a, **k):
        sizes.append((slots.shape[0], prompts.shape[0]))
        return prefill(params_d, params_t, state, slots, prompts, *a, **k)

    monkeypatch.setattr(tsched, "_prefill_slots", spy)
    prompts = [list(range(5, 5 + n)) for n in (12, 20, 16)]
    eng_a = _engine(pair, num_slots=4, max_new_cap=16, seed=11)
    rids_a = [eng_a.submit(p, max_new_tokens=8) for p in prompts]
    eng_a.run_until_idle()
    assert sizes == [(3, 4)]
    eng_b = _engine(pair, num_slots=4, max_new_cap=16, seed=11)
    rids_b = []
    for p in prompts:
        rids_b.append(eng_b.submit(p, max_new_tokens=8))
        eng_b.step()
    eng_b.run_until_idle()
    assert sizes[1:] == [(1, 1)] * 3
    for a, b in zip(rids_a, rids_b):
        np.testing.assert_array_equal(eng_a.result(a).output_ids, eng_b.result(b).output_ids)


def test_repeat_run_is_deterministic(pair):
    """tests/test_scheduler.py's flash-path test: the batched step through
    B2 (its plain version on the CPU) drains, respects every budget and
    repeats itself exactly."""
    def run():
        eng = _engine(pair, flash="on", num_slots=2, max_new_cap=32, seed=7)
        rids = [eng.submit(list(range(5, 5 + n)), max_new_tokens=8) for n in (12, 20, 16)]
        eng.run_until_idle()
        return [eng.result(r).output_ids for r in rids]

    out_a, out_b = run(), run()
    for a, b, n in zip(out_a, out_b, (12, 20, 16)):
        np.testing.assert_array_equal(a, b)
        assert 8 <= len(a) - n <= 8 + 3 + 1
        assert (a >= 0).all() and (a < 128).all()


# --------------------------------------------------------------- the rest

def test_partial_result_is_monotone(pair):
    eng = _engine(pair, steps_per_sync=1)
    rid = eng.submit(list(range(5, 25)), max_new_tokens=20)
    assert eng.partial_result(rid) is None  # queued, not on a slot
    seen = []
    while eng.step():
        part = eng.partial_result(rid)
        if part is None:
            break
        seen.append(part)
    assert len(seen) >= 2
    for a, b in zip(seen, seen[1:]):
        assert len(b) >= len(a) and np.array_equal(b[:len(a)], a)
    c = eng.result(rid)
    assert np.array_equal(c.output_ids[:len(seen[-1])], seen[-1])
    assert eng.partial_result(rid) is None  # harvested


def test_stale_metadata_never_harvests_a_new_occupant(pair):
    """Metadata recorded under a slot's previous occupant (done there)
    must not complete the request that took the slot since."""
    eng = _engine(pair, num_slots=1, steps_per_sync=8)
    r1 = eng.submit(list(range(5, 15)), max_new_tokens=3)
    eng._admit()
    gens = tuple(eng._slot_gen)
    pack = eng._dispatch_chunk()
    eng._collect(pack, gens)
    stale = dict(eng._last_harvest)
    assert stale["done"][0] and eng.result(r1) is not None
    r2 = eng.submit(list(range(30, 40)), max_new_tokens=6)
    eng._admit()
    assert eng._slot_req[0].rid == r2
    eng._harvest(stale["done"], stale["cur_len"], gens)
    assert eng._slot_req[0].rid == r2 and r2 not in eng.completions
    eng.run_until_idle()
    c2 = eng.result(r2)
    assert np.array_equal(c2.output_ids[:10], np.arange(30, 40))
    assert len(c2.output_ids) - 10 >= 6


def test_warmup_keeps_the_rid_sequence(pair):
    eng = _engine(pair, num_slots=2)
    eng.submit(list(range(5, 15)), 4)
    eng.run_until_idle()
    eng.completions.clear()
    eng.warmup(prompt_len=8)
    assert eng._next_rid == 1 and not eng.completions and eng.num_active == 0
    assert eng.submit(list(range(5, 15)), 4) == 1


def test_mesh_and_device():
    """A data-parallel ``mesh=`` axis must divide the slots (JAX asserts
    it), and then each rank holds its share; the engine runs on the card
    unless the caller asks for the CPU."""
    from llmspeculativesampling_tpu_torch.parallel.sharding import Mesh

    bd, bt = _bundles()
    cfg = bt.cfg
    p = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    dp2 = Mesh(np.arange(2).reshape(2, 1), 0)
    with pytest.raises(ValueError, match="num_slots=3 must divide over dp=2"):
        ContinuousBatchingEngine(bd, p, bt, p, num_slots=3, mesh=dp2, device="cpu")
    eng = ContinuousBatchingEngine(bd, p, bt, p, num_slots=4, max_total_len=64, mesh=dp2,
                                   device="cpu")
    assert eng.state.tokens.shape[0] == 2 and eng.state.target_cache.k.shape[1] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousBatchingEngine(bd, p, bt, p)
    eng = ContinuousBatchingEngine(bd, p, bt, p, num_slots=2, max_total_len=64, device="cpu")
    assert eng.state.tokens.device.type == "cpu"
    assert eng.state.target_cache.lengths.dtype == torch.int32


# ------------------------------------------------------------------ exports

@pytest.mark.parametrize("sub", ["ops", "cache", "quant", "kernels", "engine", "serve",
                                 "evalx", "train", "utils", "parallel"])
def test_subpackage_exports_match_jax(sub):
    """Every name the JAX subpackage exports imports from the port's."""
    jmod = importlib.import_module(f"llmspeculativesampling_tpu.{sub}")
    tmod = importlib.import_module(f"llmspeculativesampling_tpu_torch.{sub}")
    missing = [n for n in jmod.__all__ if not hasattr(tmod, n)]
    assert not missing, missing
    assert set(jmod.__all__) <= set(tmod.__all__)
    if sub == "kernels":  # the function, as JAX's kernels.int8_matmul is
        assert callable(tmod.int8_matmul) and not inspect.ismodule(tmod.int8_matmul)


def test_every_module_imports_without_jax():
    """Each module of the port imports in a fresh interpreter in which
    ``jax``, ``optax`` and the JAX package cannot be imported at all."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'optax', 'llmspeculativesampling_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import llmspeculativesampling_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules = sum(1 for path in (root / "llmspeculativesampling_tpu_torch").rglob("*.py")
                    if path.name != "__init__.py" or path.parent.name != "llmspeculativesampling_tpu_torch")
    assert int(res.stdout.strip()) == n_modules
