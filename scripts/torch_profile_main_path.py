#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's paths, on one GPU.

    python3 scripts/torch_profile_main_path.py

Builds the 13B-shaped int8 target and the 768-wide int8 draft on the card
(seed 0) and prints, for the single-stream path with chip_smoke.py's
settings (64-token prompt, 128 new tokens, gamma=24, top_k=20, top_p=0.9)
and for the paged serving path with its uniform mix (16 rows, int8 pools of
32 blocks of 128, gamma=8, steps_per_sync=8, 24 requests of 64 + 48):

* for one forward of each kind (single stream: target verify over gamma+1
  tokens, target AR decode of 1 token, draft decode of 1 token, at a
  128-position prefix; serving: target verify of 16 rows x 9 tokens and
  draft decode of 16 rows x 1 token through the paged int8 pool, at a
  100-position prefix): the host time per forward (back-to-back forwards
  ending in a synchronize, so it is the larger of the host's enqueue time
  and the device's time), the device busy time (the sum of the CUDA kernel
  times in a torch.profiler trace: one stream, no overlap) split by kernel,
  and the number of kernels launched;
* for one whole AR and one whole speculative generation, and one whole run
  of the serving mix through ``PagedEngine``: tok/s on the host clock
  (untraced, after a warm-up run), the device busy time from a traced run
  of the same seed, and the device's idle share 1 - busy/wall.

All host-clock numbers are taken before the first trace.

Every line carries the card's name and power limit. It imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import card_line  # noqa: E402

S_MAX = 256  # aligned_total(64 + 128 + 25), as the engines allocate
PREFIX = 128
GAMMA = 24
ROWS, SERVE_GAMMA, SERVE_PREFIX = 16, 8, 100


def log(*a):
    print(*a, flush=True)


def kind_of(name: str) -> str:
    if "w8a16" in name or "splitk_reduce" in name:
        return "int8_matmul"
    if "flash_decode" in name:  # one template; B3 instantiates the Paged layout
        return "paged_flash_decode" if "Paged" in name else "flash_decode"
    return "other"


def device_busy(prof):
    """(total ms, {kind: ms}, kernel count, {kernel name: ms}) of the
    device-side events of a trace."""
    by_kind, by_name = defaultdict(float), defaultdict(float)
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        by_kind[kind_of(e.name)] += ms
        by_name[e.name] += ms
        n += 1
    return sum(by_kind.values()), dict(by_kind), n, dict(by_name)


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_busy(prof)


def forward_setup(bundle, params, s_new):
    """A forward of ``s_new`` tokens at a ``PREFIX``-position cache, as a
    closure: the returned cache is dropped, so every call writes at PREFIX."""
    from llmspeculativesampling_tpu_torch.cache.kvcache import rollback

    gen = torch.Generator(device="cuda").manual_seed(7)
    cache = bundle.make_cache(1, S_MAX, device="cuda")
    prompt = torch.randint(100, 31000, (1, 64), generator=gen, device="cuda")
    _, cache = bundle.forward(params, bundle.cfg, prompt, cache)
    cache = rollback(cache, PREFIX)
    step = torch.randint(100, 31000, (1, s_new), generator=gen, device="cuda")
    return lambda: bundle.forward(params, bundle.cfg, step, cache)


def paged_forward_setup(bundle, params, s_new):
    """A forward of ``s_new`` tokens for each of ROWS rows at a
    SERVE_PREFIX-position paged int8 cache (one page a row), as a closure."""
    from llmspeculativesampling_tpu_torch.cache.paged import init_paged_cache, rollback_rows

    c = bundle.cfg
    gen = torch.Generator(device="cuda").manual_seed(8)
    cache = init_paged_cache(c.num_layers, ROWS, c.num_kv_heads, 128, c.head_dim, ROWS, 1,
                             c.torch_dtype, quant=True, device="cuda")
    cache.block_tables[:, 0] = torch.arange(ROWS, dtype=torch.int32, device="cuda")
    prompt = torch.randint(100, 31000, (ROWS, 64), generator=gen, device="cuda")
    _, cache = bundle.forward(params, c, prompt, cache, paged_prefill=True)
    cache = rollback_rows(cache, torch.full((ROWS,), SERVE_PREFIX, device="cuda"))
    step = torch.randint(100, 31000, (ROWS, s_new), generator=gen, device="cuda")
    return lambda: bundle.forward(params, c, step, cache)


def host_ms(run, reps=20):
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_main_path: CUDA is not available", file=sys.stderr)
        return 1
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8_small_draft
    from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate
    from llmspeculativesampling_tpu_torch.engine.speculative import speculative_generate
    from llmspeculativesampling_tpu_torch.models.llama import unstack_layers
    from llmspeculativesampling_tpu_torch.serve import paged as serve_paged

    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    bd, pd, bt, pt = synthetic_pair_int8_small_draft(device="cuda")
    pd, pt = unstack_layers(pd), unstack_layers(pt)
    forwards = {
        "target_verify": forward_setup(bt, pt, GAMMA + 1),
        "target_decode": forward_setup(bt, pt, 1),
        "draft_decode": forward_setup(bd, pd, 1),
        "serve_target_verify": paged_forward_setup(bt, pt, SERVE_GAMMA + 1),
        "serve_draft_decode": paged_forward_setup(bd, pd, 1),
    }
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, device="cuda")

    def ar():
        g = torch.Generator(device="cuda").manual_seed(1)
        return len(autoregressive_generate(bt, pt, prompt, 128, generator=g, **kw)) - 64

    def spec():
        g = torch.Generator(device="cuda").manual_seed(1)
        return len(speculative_generate(bd, pd, bt, pt, prompt, 128, gamma=GAMMA, generator=g,
                                        **kw)) - 64

    engine = serve_paged.PagedEngine(
        bd, pd, bt, pt, batch_rows=ROWS, num_blocks=32, page=128, max_pages_per_req=1,
        max_new_cap=48, gamma=SERVE_GAMMA, eos_token_id=2, top_k=20, top_p=0.9,
        prompt_bucket=64, steps_per_sync=8, kv_quant=True, device="cuda")
    serve_prompts = [np.random.default_rng(0).integers(100, 31000, 64) for _ in range(24)]
    step_fn, n_steps = serve_paged._paged_spec_step, [0]

    def counted_step(*a, **k):
        n_steps[0] += 1
        return step_fn(*a, **k)

    serve_paged._paged_spec_step = counted_step

    def serve():  # the same rids each run: the same random streams
        n_steps[0] = 0
        for rid, p in enumerate(serve_prompts):
            engine.submit_with_rid(rid, p, 48)
        engine.run_until_idle()
        return sum(engine.result(r).details["tokens_generated"] for r in range(len(serve_prompts)))

    # every host-clock number first: after a trace the profiler's device
    # hooks stay attached and slow later launches (AR measured after the
    # traces ran at two thirds of the rate it runs at before them)
    out = {"card": card, "forward": {}, "generate": {}}
    for name, run in forwards.items():
        out["forward"][name] = {"host_ms": host_ms(run)}
    for name, run in (("ar", ar), ("spec", spec), ("serve_uniform", serve)):
        run()  # warm-up (allocator, phase calibration)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_new = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["generate"][name] = {"tokens": n_new, "wall_ms": wall * 1e3, "tok_s": n_new / wall}
        if name == "serve_uniform":
            out["generate"][name]["batched_steps"] = n_steps[0]

    for name, run in forwards.items():
        r = out["forward"][name]
        busy, kinds, n, _ = traced(run)
        r.update(device_busy_ms=busy, kernels=n, by_kind=kinds)
        prefix = SERVE_PREFIX if name.startswith("serve") else PREFIX
        log(f"[forward] {name} (prefix {prefix}): host_ms {r['host_ms']:.3f} "
            f"device_busy_ms {busy:.3f} ({', '.join(f'{k} {v:.3f}' for k, v in sorted(kinds.items()))}) "
            f"kernels {n} ({card})")
    for name, run in (("ar", ar), ("spec", spec), ("serve_uniform", serve)):
        r = out["generate"][name]
        busy, kinds, n, names = traced(run)
        r.update(device_busy_ms=busy, idle_share=1 - busy / r["wall_ms"], kernels=n, by_kind=kinds)
        if name == "serve_uniform":
            log(f"[generate] serve_uniform: {r['batched_steps']} batched steps (untraced run), "
                f"{n_steps[0]} in the traced run; host ms per step "
                f"{r['wall_ms'] / r['batched_steps']:.1f} ({card})")
        log(f"[generate] {name}: {r['tokens']} tokens in {r['wall_ms']:.1f} ms = {r['tok_s']:.2f} tok/s; "
            f"device_busy_ms {busy:.1f} ({', '.join(f'{k} {v:.1f}' for k, v in sorted(kinds.items()))}), "
            f"idle share {r['idle_share']:.3f}, kernels {n} ({card})")
        for kname, ms in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
            log(f"[generate]   {ms:9.2f} ms  {kname[:110]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
