#!/usr/bin/env python3
"""Where the time goes in the paged engine's memory management, on one GPU.

    python3 scripts/torch_profile_paging.py [--runs 0 3 ...]

Builds the 13B-shaped int8 target and the 768-wide int8 draft on the card
(seed 0) and drives ``PagedEngine`` directly, as chip_smoke.py does, with
scripts/bench_paged.py's 13B settings (16 rows, int8 pools of 32 blocks of
128, gamma 8, steps_per_sync 8) through these mixes:

* shared_prefix (24 x 576-token prompts sharing a 512-token system
  prompt, 48 new tokens) with the prefix cache and without it;
* longgen (24 x (64, 256)) on demand at overcommit 1.0 and 2.0;
* mixed (24 short + 6 long) on demand and reserving each worst case.

For each (``--runs`` picks them by index): tok/s on the host clock (one
untraced run after a warm-up), the host time of each admission dispatch (a
miss's prefill, a hit's extend windows: enqueued, not waited for), of each
chunk's dispatch (its replayed steps, the host waiting one step behind) and
of each chunk's metadata read and harvest (one chunk behind, under
``run_until_idle``'s pipeline), the preemptions and the peak of active rows; then, from
a run of a fresh engine with the same rids traced for its CUDA kernels only
(host-side events of a run this long take longer to collect than the run),
the device busy time (the sum of the kernel times) split by kernel and the
device's idle share 1 - busy/wall.

Every line carries the card's name and power limit. It imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import _mix_prompts, _serving_engine, card_line  # noqa: E402
from torch_profile_main_path import device_busy, log  # noqa: E402

RUNS = [("shared_prefix", dict(prefix_cache=True)), ("shared_prefix", dict(prefix_cache=False)),
        ("longgen", dict(overcommit=1.0)), ("longgen", dict(overcommit=2.0)),
        ("mixed", dict()), ("mixed", dict(on_demand=False))]


def traced(fn):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_busy(prof)


def make_run(kind, pair, kw):
    """A fresh engine for the mix, warmed up with two requests at its first
    prompt length, and a closure that submits the mix (request i under rid
    i) and drains it, returning the tokens generated. Each admission
    dispatch and chunk is timed on the host clock."""
    reqs, prompts = _mix_prompts(kind)
    engine = _serving_engine(pair, reqs, **kw)
    warm = np.random.default_rng(5).integers(100, 31000, reqs[0][0])
    for rid in (10_000, 10_001):
        engine.submit_with_rid(rid, warm, 8)
        engine.run_until_idle()
    engine.completions.clear()
    times = {"prefill": [], "extend": [], "chunk": [], "harvest": []}

    def timed(name, fn):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    engine._dispatch_prefill = timed("prefill", engine._dispatch_prefill)
    engine._dispatch_extend = timed("extend", engine._dispatch_extend)
    engine._start_chunk = timed("chunk", engine._start_chunk)  # the chunk's steps enqueued
    engine._finish_chunk = timed("harvest", engine._finish_chunk)  # a chunk's read and harvest
    active = []
    prepare = engine._prepare_chunk

    def prepare_chunk():
        prepare()
        active.append(engine.num_active)

    engine._prepare_chunk = prepare_chunk

    def go():
        for v in times.values():
            v.clear()
        active.clear()
        p0 = engine.preemptions
        for i, (p, (_, mn)) in enumerate(zip(prompts, reqs)):
            engine.submit_with_rid(i, p, mn)
        engine.run_until_idle()
        comps = [engine.result(i) for i in range(len(reqs))]
        return (sum(c.details["tokens_generated"] for c in comps), engine.preemptions - p0,
                max(active))

    return go, times


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_paging: CUDA is not available", file=sys.stderr)
        return 1
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8_small_draft

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, nargs="*", default=list(range(len(RUNS))))
    runs = [RUNS[i] for i in ap.parse_args().runs]
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    pair = synthetic_pair_int8_small_draft(device="cuda")
    # every host-clock number first: after a trace the profiler's hooks
    # stay attached and slow later launches
    out = {"card": card, "runs": []}
    for kind, kw in runs:
        go, times = make_run(kind, pair, kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, preempted, peak = go()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        r = dict(kind=kind, kw=kw, tokens=tokens, wall_ms=wall, tok_s=tokens / wall * 1e3,
                 preemptions=preempted, peak_active=peak,
                 host_ms={k: dict(n=len(v), sum=float(np.sum(v)), mean=float(np.mean(v)) if v
                                  else None) for k, v in times.items()})
        out["runs"].append(r)
        h = r["host_ms"]
        adm = ", ".join(f"{k} {v['n']} x {v['mean']:.1f} = {v['sum']:.0f} ms"
                        for k, v in h.items() if v["n"])
        log(f"[paging] {kind} {kw}: {tokens} tokens in {wall:.1f} ms = {r['tok_s']:.2f} tok/s; "
            f"preemptions {preempted}, peak active rows {peak}; host: {adm} ({card})")
        del go
        torch.cuda.empty_cache()
    for r in out["runs"]:
        go, _ = make_run(r["kind"], pair, r["kw"])
        busy, kinds, n, names = traced(go)
        r.update(device_busy_ms=busy, idle_share=1 - busy / r["wall_ms"], kernels=n,
                 by_kind=kinds)
        log(f"[paging] {r['kind']} {r['kw']}, traced: device_busy_ms {busy:.1f} "
            f"({', '.join(f'{k} {v:.1f}' for k, v in sorted(kinds.items()))}), idle share "
            f"{r['idle_share']:.3f} of the untraced run's wall, kernels {n} ({card})")
        for kname, ms in sorted(names.items(), key=lambda kv: -kv[1])[:4]:
            log(f"[paging]   {ms:9.2f} ms  {kname[:110]}")
        del go
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
