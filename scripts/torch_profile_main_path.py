#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path, on one GPU.

    python3 scripts/torch_profile_main_path.py

Builds the 13B-shaped int8 target and the 768-wide int8 draft on the card
(seed 0) and, with chip_smoke.py's settings (64-token prompt, 128 new
tokens, gamma=24, top_k=20, top_p=0.9), prints:

* for one forward of each kind on the main path (target verify over
  gamma+1 tokens, target AR decode of 1 token, draft decode of 1 token, all
  at a 128-position prefix): the host time per forward (back-to-back
  forwards ending in a synchronize, so it is the larger of the host's
  enqueue time and the device's time), the device busy time (the sum of
  the CUDA kernel times in a torch.profiler trace: one stream, no overlap)
  split by kernel, and the number of kernels launched;
* for one whole AR and one whole speculative generation: tok/s on the host
  clock (untraced, after a warm-up run), the device busy time from a
  traced run of the same seed, and the device's idle share 1 - busy/wall.

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


def log(*a):
    print(*a, flush=True)


def kind_of(name: str) -> str:
    if "w8a16" in name or "splitk_reduce" in name:
        return "int8_matmul"
    if "flash_decode" in name:
        return "flash_decode"
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

    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    bd, pd, bt, pt = synthetic_pair_int8_small_draft(device="cuda")
    pd, pt = unstack_layers(pd), unstack_layers(pt)
    forwards = {
        "target_verify": forward_setup(bt, pt, GAMMA + 1),
        "target_decode": forward_setup(bt, pt, 1),
        "draft_decode": forward_setup(bd, pd, 1),
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

    # every host-clock number first: after a trace the profiler's device
    # hooks stay attached and slow later launches (AR measured after the
    # traces ran at two thirds of the rate it runs at before them)
    out = {"card": card, "forward": {}, "generate": {}}
    for name, run in forwards.items():
        out["forward"][name] = {"host_ms": host_ms(run)}
    for name, run in (("ar", ar), ("spec", spec)):
        run()  # warm-up (allocator, phase calibration)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_new = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["generate"][name] = {"tokens": n_new, "wall_ms": wall * 1e3, "tok_s": n_new / wall}

    for name, run in forwards.items():
        r = out["forward"][name]
        busy, kinds, n, _ = traced(run)
        r.update(device_busy_ms=busy, kernels=n, by_kind=kinds)
        log(f"[forward] {name} (prefix {PREFIX}): host_ms {r['host_ms']:.3f} "
            f"device_busy_ms {busy:.3f} ({', '.join(f'{k} {v:.3f}' for k, v in sorted(kinds.items()))}) "
            f"kernels {n} ({card})")
    for name, run in (("ar", ar), ("spec", spec)):
        r = out["generate"][name]
        busy, kinds, n, names = traced(run)
        r.update(device_busy_ms=busy, idle_share=1 - busy / r["wall_ms"], kernels=n, by_kind=kinds)
        log(f"[generate] {name}: {r['tokens']} tokens in {r['wall_ms']:.1f} ms = {r['tok_s']:.2f} tok/s; "
            f"device_busy_ms {busy:.1f} ({', '.join(f'{k} {v:.1f}' for k, v in sorted(kinds.items()))}), "
            f"idle share {r['idle_share']:.3f}, kernels {n} ({card})")
        for kname, ms in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
            log(f"[generate]   {ms:9.2f} ms  {kname[:110]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
