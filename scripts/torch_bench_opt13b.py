#!/usr/bin/env python3
"""The OPT path of the PyTorch/CUDA port on one GPU: the port's counterpart
of ``scripts/bench_opt13b.py``.

    python3 scripts/torch_bench_opt13b.py [--max_new 128] [--gammas 8,16,24]

Builds ``synthetic_opt_pair_int8_small_draft`` on the card (OPT-13B int8
target: 5120 hidden, ffn 20480, 40 layers, vocab 50272, tied bf16 head;
an independent 640-wide 2-layer draft; seed 3) and prints:

* for one forward of each kind (single stream: target verify of gamma+1 =
  9 tokens and target decode of 1 at a 128-position prefix, draft decode
  of 1; serving: target verify of 16 rows x 9 and draft decode of 16 rows
  x 1 through a paged int8 pool at a 100-position prefix): the host ms per
  forward (back-to-back forwards ending in a synchronize), the device-busy
  ms (the sum of CUDA kernel times in a ``torch.profiler`` trace) split into
  B1, B2 / B3, the dense tied head (cuBLAS) and other kernels, and the
  kernels launched;
* AR and speculative decoding at each gamma (64-token prompt, top_k 20,
  top_p 0.9, eos 2): median tok/s of 3 timed runs after a warm-up, with
  acc_rate and mean acc_len;
* paged serving of bench_opt13b's uniform mix scaled to the Llama cell's
  engine (16 rows, 32 int8 blocks of 128, gamma 8, steps_per_sync 8; 24
  requests of 64 + 48 submitted at once): aggregate tok/s;
* the device's idle share (1 - busy / wall) of one AR run, one spec run
  at the first gamma and one serving run, from traced repeats.

Host-clock numbers come before any trace. Every line carries the card's
name and power limit (nvidia-smi). It imports nothing of JAX and nothing
of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_profile_main_path as prof  # noqa: E402
from chip_smoke import card_line  # noqa: E402

ROWS, SERVE_GAMMA, BLOCKS, PAGE = 16, 8, 32, 128


def log(*a):
    print(*a, flush=True)


def kind_of(name: str) -> str:
    """B1, B2, B3, the dense head (the forward's one cuBLAS product: CUDA
    12.8's cuBLAS names its Hopper GEMMs ``nvjet_*``) or other."""
    low = name.lower()
    if "w8a16" in low or "splitk_reduce" in low:
        return "int8_matmul"
    if "flash_decode" in low:
        return "paged_flash_decode" if "paged" in low else "flash_decode"
    if any(t in low for t in ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas")):
        return "dense_head"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max_new", type=int, default=128)
    ap.add_argument("--gammas", default="8,16,24")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench_opt13b: CUDA is not available", file=sys.stderr)
        return 1
    from llmspeculativesampling_tpu_torch import (
        autoregressive_generate, speculative_generate, synthetic_opt_pair_int8_small_draft)
    from llmspeculativesampling_tpu_torch.models.llama import unstack_layers
    from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

    prof.kind_of = kind_of  # the trace split of torch_profile_main_path, with the dense head
    gammas = [int(g) for g in args.gammas.split(",")]
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    bd, pd, bt, pt = synthetic_opt_pair_int8_small_draft(device="cuda")
    pd, pt = unstack_layers(pd), unstack_layers(pt)
    torch.cuda.synchronize()
    log(f"[pair] OPT-13B int8 + 640x2 draft born in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({card})")
    forwards = {
        "target_verify": prof.forward_setup(bt, pt, gammas[0] + 1),
        "target_decode": prof.forward_setup(bt, pt, 1),
        "draft_decode": prof.forward_setup(bd, pd, 1),
        "serve_target_verify": prof.paged_forward_setup(bt, pt, SERVE_GAMMA + 1),
        "serve_draft_decode": prof.paged_forward_setup(bd, pd, 1),
    }
    prompt = list(np.random.default_rng(0).integers(100, 50000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, device="cuda")

    def gen(k):
        return torch.Generator(device="cuda").manual_seed(k)

    def ar(k=1):
        return autoregressive_generate(bt, pt, prompt, args.max_new, generator=gen(k),
                                       details=True, **kw)

    def spec(gamma, k=1):
        return speculative_generate(bd, pd, bt, pt, prompt, args.max_new, gamma=gamma,
                                    generator=gen(k), details=True, **kw)

    engine = PagedEngine(
        bd, pd, bt, pt, batch_rows=ROWS, num_blocks=BLOCKS, page=PAGE, max_pages_per_req=1,
        max_new_cap=48, gamma=SERVE_GAMMA, eos_token_id=2, top_k=20, top_p=0.9, prompt_bucket=64,
        steps_per_sync=8, kv_quant=True, device="cuda")
    serve_prompts = [np.random.default_rng(i).integers(100, 50000, 64) for i in range(24)]

    def serve():  # the same rids each run: the same random streams
        for rid, p in enumerate(serve_prompts):
            engine.submit_with_rid(rid, p, 48)
        engine.run_until_idle()
        return sum(engine.result(r).details["tokens_generated"] for r in range(len(serve_prompts)))

    out = {"card": card, "forward": {}, "generate": {}}
    for name, run in forwards.items():
        out["forward"][name] = {"host_ms": prof.host_ms(run)}

    # generation, host clock: a warm-up, then reps timed runs
    def timed_runs(fn):
        fn(0)
        rates, ds = [], []
        for k in range(1, args.reps + 1):
            _, d = fn(k)
            rates.append(d["tokens_per_s"])
            ds.append(d)
        return rates, ds

    rates, _ = timed_runs(lambda k: ar(k))
    out["generate"]["ar"] = {"tok_s": float(np.median(rates)), "spread": [min(rates), max(rates)]}
    log(f"[generate] AR: {np.median(rates):.2f} tok/s median ({1e3 / np.median(rates):.2f} ms a "
        f"token, spread {min(rates):.2f}-{max(rates):.2f}) ({card})")
    for gamma in gammas:
        rates, ds = timed_runs(lambda k, g=gamma: spec(g, k))
        acc = float(np.mean([d["acc_rate"] for d in ds]))
        acc_len = float(np.mean([np.mean(d["acc_len"]) for d in ds]))
        med = float(np.median(rates))
        out["generate"][f"spec_gamma{gamma}"] = {
            "tok_s": med, "spread": [min(rates), max(rates)], "acc_rate": acc, "acc_len": acc_len,
            "steps": [d["target_call_times"] for d in ds]}
        log(f"[generate] spec gamma={gamma}: {med:.2f} tok/s median "
            f"({med / out['generate']['ar']['tok_s']:.2f}x AR), acc_rate {acc:.4f}, mean acc_len "
            f"{acc_len:.3f}, spread {min(rates):.2f}-{max(rates):.2f}, steps "
            f"{out['generate'][f'spec_gamma{gamma}']['steps']} ({card})")
    serve()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_tok = serve()
    wall = time.perf_counter() - t0
    out["generate"]["serve_uniform"] = {"tokens": n_tok, "wall_ms": wall * 1e3, "tok_s": n_tok / wall}
    log(f"[generate] paged serving, uniform 24 x (64 + 48), 16 rows, int8 pool: {n_tok} tokens in "
        f"{wall * 1e3:.1f} ms = {n_tok / wall:.2f} tok/s aggregate ({card})")

    # device time: traces after every host-clock number
    for name, run in forwards.items():
        r = out["forward"][name]
        busy, kinds, n, names = prof.traced(run)
        r.update(device_busy_ms=busy, kernels=n, by_kind=kinds)
        log(f"[forward] {name}: host_ms {r['host_ms']:.3f} device_busy_ms {busy:.3f} "
            f"({', '.join(f'{k} {v:.3f}' for k, v in sorted(kinds.items()))}) kernels {n} ({card})")
        for kname, ms in sorted(names.items(), key=lambda kv: -kv[1])[:4]:
            log(f"[forward]   {ms:9.3f} ms  {kname[:110]}")
    for name, run in (("ar", lambda: len(ar()[0]) - 64),
                      (f"spec_gamma{gammas[0]}", lambda: len(spec(gammas[0])[0]) - 64),
                      ("serve_uniform", serve)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_new = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy, kinds, n, names = prof.traced(run)
        r = out["generate"].setdefault(name, {})
        r.update(trace_wall_ms=wall_ms, trace_tokens=n_new, device_busy_ms=busy,
                 idle_share=1 - busy / wall_ms, kernels=n, by_kind=kinds)
        log(f"[idle] {name}: {n_new} tokens in {wall_ms:.1f} ms (untraced), device_busy_ms "
            f"{busy:.1f} ({', '.join(f'{k} {v:.1f}' for k, v in sorted(kinds.items()))}), idle "
            f"share {r['idle_share']:.3f}, kernels {n} ({card})")
        for kname, ms in sorted(names.items(), key=lambda kv: -kv[1])[:5]:
            log(f"[idle]   {ms:9.2f} ms  {kname[:110]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "torch_bench_opt13b.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
