"""The rank-side cases of ``tests/test_torch_parallel.py`` and
``tests/test_torch_multihost.py``, run on gloo ranks by
``llmspeculativesampling_tpu_torch.parallel.launch``. This module imports
torch and the port only (every rank imports it), takes numpy in and gives
numpy back; the test files hold the JAX side."""

import os
import time

import numpy as np
import torch

from llmspeculativesampling_tpu_torch.core.config import LlamaConfig, OPTConfig
from llmspeculativesampling_tpu_torch.core.convert import params_from_numpy
from llmspeculativesampling_tpu_torch.engine import (
    ModelBundle,
    autoregressive_generate,
    beam_speculative_generate,
    beam_speculative_v2_generate,
    bild_generate,
    mjsd_generate,
    multi_beam_generate,
    multi_speculative_generate,
    random_width_beam_generate,
    speculative_generate,
    speculative_generate_v2,
)
from llmspeculativesampling_tpu_torch.models import llama, opt
from llmspeculativesampling_tpu_torch.ops.sampling import (
    SamplingConfig,
    norm_logits_topk,
    norm_logits_topk_tp,
)
from llmspeculativesampling_tpu_torch.parallel import comm
from llmspeculativesampling_tpu_torch.parallel.sharding import make_mesh, param_specs, shard_params
from llmspeculativesampling_tpu_torch.serve.multihost import (
    MultiHostDriver,
    PagedMultiHostDriver,
    WorkerLostError,
)
from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine
from llmspeculativesampling_tpu_torch.serve.scheduler import ContinuousBatchingEngine

LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=8,
             num_kv_heads=8, max_position=128, dtype="float32")
OPT = dict(vocab_size=128, hidden_size=64, ffn_dim=128, num_layers=2, num_heads=8,
           max_position=2048, dtype="float32")
PROMPT = list(range(5, 17))


def bundle(family: str, cfg_kw: dict, kv_quant: bool = False) -> ModelBundle:
    if family == "llama":
        return ModelBundle("llama", LlamaConfig(**cfg_kw), llama.forward, kv_quant=kv_quant)
    return ModelBundle("opt", OPTConfig(**cfg_kw), opt.forward, kv_quant=kv_quant)


def draft_of(family: str, pt: dict) -> dict:
    """A one-layer draft from the target's first layer (the JAX tests' pair)."""
    keep = ("embed", "ln_final", "lm_head") if family == "llama" else (
        "embed", "embed_pos", "ln_final_w", "ln_final_b")
    pd = {k: pt[k] for k in keep if k in pt}
    pd["layers"] = {k: ({kk: vv[:1] for kk, vv in v.items()} if isinstance(v, dict) else v[:1])
                    for k, v in pt["layers"].items()}
    return pd


def tiny_pair(family: str = "llama", seed: int = 0):
    """(bundle_d, params_d, bundle_t, params_t) of seeded fp32 weights."""
    kw = LLAMA if family == "llama" else OPT
    bt = bundle(family, kw)
    mod = llama if family == "llama" else opt
    pt = mod.init_params(bt.cfg, torch.Generator().manual_seed(seed), device="cpu")
    return bundle(family, {**kw, "num_layers": 1}), draft_of(family, pt), bt, pt


def _shard(b: ModelBundle, p: dict, mesh) -> dict:
    return shard_params(p, param_specs(b.family, b.cfg), mesh)


# ------------------------------------------------------------- forward parity

def forward_case(cases: dict) -> dict:
    """Each case ``name -> (family, cfg_kw, params (numpy), tokens [B, S],
    kv_quant, decode steps)``: the tp=2 forward (a prefill, then greedy
    decode steps through the cache), logits gathered to the full vocab."""
    mesh = make_mesh(1, 2)
    out = {}
    for name, (family, cfg_kw, params_np, tokens, kv_quant, steps) in cases.items():
        b = bundle(family, cfg_kw, kv_quant)
        p = _shard(b, params_from_numpy(params_np, device="cpu"), mesh)
        b = b.for_params(p)
        toks = torch.as_tensor(tokens, dtype=torch.long)
        cache = b.make_cache(toks.shape[0], 64, device="cpu")
        logits, cache = b.forward(p, b.cfg, toks, cache)
        seq = [logits.numpy()]
        for _ in range(steps):
            logits, cache = b.forward(p, b.cfg, logits[:, -1:].argmax(-1), cache)
            seq.append(logits.numpy())
        out[name] = {"logits": seq, "cache_heads": int(cache.k.shape[2] if hasattr(cache, "k")
                                                      else cache.k_q.shape[2])}
    return out


def topk_case(logits: np.ndarray, top_k: int, top_p: float, temperature: float) -> dict:
    """``norm_logits_topk_tp`` on this rank's vocab slice against
    ``norm_logits_topk`` on the whole row, and what the collective moved."""
    mesh = make_mesh(1, 2)
    full = torch.as_tensor(logits)
    cfg = SamplingConfig(temperature, top_k, top_p)
    comm.reset_counts()
    tp = norm_logits_topk_tp(comm.vocab_slice(full, mesh),
                             SamplingConfig(temperature, top_k, top_p, tp_mesh=mesh))
    moved = {op: list(c) for op, c in comm.COUNTS.items()}
    ref = norm_logits_topk(full, cfg)
    return {"idx": tp.idx.numpy(), "probs": tp.probs.numpy(), "ref_idx": ref.idx.numpy(),
            "ref_probs": ref.probs.numpy(), "moved": moved}


# ------------------------------------------------------------------- engines

def _engine_runs(bd, pd, bt, pt, mesh):
    kw = dict(eos_token_id=-1, temperature=1.0, top_k=10, top_p=0.9, device="cpu")

    def g(seed):
        return torch.Generator().manual_seed(seed)

    return {
        "speculative": lambda d, t, m: speculative_generate(
            bd, d, bt, t, PROMPT, 8, gamma=3, generator=g(1), tp_mesh=m, **kw),
        "autoregressive": lambda d, t, m: autoregressive_generate(
            bt, t, PROMPT, 8, generator=g(2), tp_mesh=m, **kw),
        "speculative_v2": lambda d, t, m: speculative_generate_v2(
            bd, d, bt, t, PROMPT, 6, gamma=2, generator=g(3), tp_mesh=m, **kw),
        "multi": lambda d, t, m: multi_speculative_generate(
            bd, d, bt, t, PROMPT, 6, gamma=2, width=2, generator=g(4), tp_mesh=m, **kw),
        "multi_beam": lambda d, t, m: multi_beam_generate(
            bd, d, bt, t, PROMPT, 6, gamma=2, width=2, num_beams=2, generator=g(5), tp_mesh=m,
            **kw),
        "mjsd": lambda d, t, m: mjsd_generate(
            bd, d, bt, t, PROMPT, 6, gamma=2, width=2, num_beams=2, accept_thres=0.1,
            generator=g(6), tp_mesh=m, **kw),
        "bild": lambda d, t, m: bild_generate(
            bd, d, bt, t, PROMPT, 6, gamma=3, generator=g(7), tp_mesh=m, **kw),
        "beam_v2": lambda d, t, m: beam_speculative_v2_generate(
            bd, d, bt, t, PROMPT, 6, gamma=2, num_beams=2, generator=g(8), tp_mesh=m, **kw),
        "beam_v1": lambda d, t, m: beam_speculative_generate(
            bd, d, bt, t, PROMPT, 6, gamma=2, width=2, num_beams=2, generator=g(9), tp_mesh=m,
            **kw),
        "random_beam": lambda d, t, m: random_width_beam_generate(
            bt, t, PROMPT, 6, max_num_beams=2, generator=g(10), tp_mesh=m, **kw),
    }


def engines_case(pt_np: dict, greedy_tokens: int) -> dict:
    """Every entry point three ways: the whole tree, the tp=2 shards with
    ``tp_mesh=None`` (gathered logits) and with ``tp_mesh`` (the distributed
    top-k); and greedy spec and AR on the shards with ``tp_mesh``."""
    mesh = make_mesh(1, 2)
    bt = bundle("llama", LLAMA)
    bd = bundle("llama", {**LLAMA, "num_layers": 1})
    pt = params_from_numpy(pt_np, device="cpu")
    pd = draft_of("llama", pt)
    pt_sh, pd_sh = _shard(bt, pt, mesh), _shard(bd, pd, mesh)
    out = {}
    for name, fn in _engine_runs(bd, pd, bt, pt, mesh).items():
        comm.reset_counts()
        whole = fn(pd, pt, None)
        assert not comm.COUNTS, name  # the whole tree sums nothing over tp
        out[name] = [whole, fn(pd_sh, pt_sh, None), fn(pd_sh, pt_sh, mesh)]
        assert comm.COUNTS["all_reduce"][0] > 0, name
    kw = dict(eos_token_id=-1, top_k=1, device="cpu", tp_mesh=mesh)
    out["greedy_spec"] = speculative_generate(bd, pd_sh, bt, pt_sh, PROMPT, greedy_tokens, gamma=3,
                                              **kw)
    out["greedy_ar"] = autoregressive_generate(bt, pt_sh, PROMPT, greedy_tokens, **kw)
    return out


# ------------------------------------------------------------------- serving

SERVE_PROMPTS = [list(range(5, 15)), list(range(30, 42)), list(range(60, 68))]


def serving_engine(kind: str, family: str, mesh=None, seed: int = 0):
    """The slotted (``kind="slots"``) or paged engine over a tiny pair."""
    bd, pd, bt, pt = tiny_pair(family, seed)
    common = dict(gamma=2, eos_token_id=-1, temperature=1.0, top_k=10, top_p=0.9, seed=3,
                  prompt_bucket=16, steps_per_sync=2, mesh=mesh, device="cpu")
    if kind == "slots":
        return ContinuousBatchingEngine(bd, pd, bt, pt, num_slots=4, max_total_len=128,
                                        max_new_cap=16, **common)
    return PagedEngine(bd, pd, bt, pt, batch_rows=2, num_blocks=16, page=32, max_new_cap=16,
                       **common)


def serve_all(kind: str, family: str, mesh=None, new_tokens: int = 6) -> list:
    eng = serving_engine(kind, family, mesh)
    rids = [eng.submit(p, new_tokens) for p in SERVE_PROMPTS]
    eng.run_until_idle()
    return [eng.result(r).output_ids for r in rids]


def serving_case() -> dict:
    """Both serving engines with ``mesh=`` (tp=2), Llama and OPT."""
    mesh = make_mesh(1, 2)
    return {(kind, family): serve_all(kind, family, mesh)
            for kind in ("slots", "paged") for family in ("llama", "opt")}


# ------------------------------------------------------------ lockstep drivers

ROUNDS = 6
DRIVER_PROMPTS = [list(range(5, 15)), list(range(30, 42))]


def slot_driver(mesh=None):
    eng = serving_engine("slots", "llama", mesh)
    return MultiHostDriver(eng, prompt_cap=64)


def paged_driver(mesh=None, heartbeat_timeout_s=None):
    eng = serving_engine("paged", "llama", mesh)
    return PagedMultiHostDriver(eng, prompt_cap=32, batch_cap=2,
                                heartbeat_timeout_s=heartbeat_timeout_s)


def lockstep_case(mode: str) -> dict:
    """``slots`` / ``slots_tp``: a MultiHostDriver for ``ROUNDS`` rounds over a
    replicated / tp=2 slot engine; ``paged_tp``: a PagedMultiHostDriver
    drained over a tp=2 paged engine. Every rank returns its token rows and
    the completions it holds."""
    mesh = make_mesh(1, 2) if mode.endswith("_tp") else None
    if mode.startswith("slots"):
        drv = slot_driver(mesh)
        rids = [drv.submit(p, 8) for p in DRIVER_PROMPTS] if drv.is_primary else []
        for _ in range(ROUNDS):
            drv.round()
        rids = rids or sorted(drv.engine.completions)
        return {"rows": drv.engine.state.tokens.numpy(),
                "completions": {r: drv.result(r).output_ids for r in rids}}
    drv = paged_driver(mesh)
    n = len(SERVE_PROMPTS)
    rids = [drv.submit(p, 6) for p in SERVE_PROMPTS] if drv.is_primary else list(range(n))
    rounds = drv.run_until_idle()
    return {"rounds": rounds, "rows": drv.engine.state.tokens.numpy(),
            "completions": {r: drv.result(r).output_ids for r in rids}}


KILL_AFTER_ROUNDS = 2
KILL_PROMPTS = DRIVER_PROMPTS + [list(range(50, 61)), list(range(70, 79)), list(range(90, 101)),
                                 list(range(110, 119))]
HEARTBEAT_S = 20.0


def kill_case() -> dict:
    """The kill drill: rank 1 dies after ``KILL_AFTER_ROUNDS`` rounds; rank 0
    must see a WorkerLostError within the heartbeat, recover every
    outstanding request and finish them on a fresh engine."""
    drv = paged_driver(heartbeat_timeout_s=HEARTBEAT_S)
    rank = torch.distributed.get_rank()
    rids = [drv.submit(p, 16) for p in KILL_PROMPTS] if drv.is_primary else []
    rounds, detect_s = 0, None
    try:
        while rounds < 200:
            t_round = time.perf_counter()
            drv.round()
            rounds += 1
            if rank == 1 and rounds >= KILL_AFTER_ROUNDS:
                os._exit(17)
    except WorkerLostError:
        detect_s = time.perf_counter() - t_round
    out = {"rounds": rounds, "detect_s": detect_s}
    # the unfailed part of the run, and what recovery hands back
    pre = {r: drv.result(r) for r in rids}
    submit_times = {rid: t0 for rid, _, _, t0 in drv._queue}
    recovered = drv.recover_requests()
    out["recovered"] = [(r.rid, r.carry is not None, r.submit_time, submit_times.get(r.rid))
                        for r in recovered]
    fresh = serving_engine("paged", "llama")
    for req in recovered:
        fresh.submit_request(req)
    fresh.run_until_idle()
    out["completions"] = {r: (pre[r] or fresh.result(r)).output_ids for r in rids}
    out["pre_done"] = sorted(r for r in rids if pre[r] is not None)
    return out
