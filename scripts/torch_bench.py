#!/usr/bin/env python3
"""Speculative against autoregressive decoding of the PyTorch/CUDA port on
one GPU: the port's counterpart of ``bench.py``.

    python3 scripts/torch_bench.py [--config 13b-int8|1.1b-int8]

Prints bench.py's one JSON line for the port:
  {"metric": "spec_decode_tokens_per_s", "value": N, "unit": "tok/s",
   "vs_baseline": speedup over autoregressive decoding, ...}

``value`` is the median of 5 timed runs after one warm-up (``spec_spread``
and ``ar_spread`` give n_reps, min, median, max); ``dispatch_rtt_ms`` is the
median wall time of one launch of a tiny CUDA op plus the synchronizing
read of its result, before and after the runs, so a slow host shows beside
the throughput. Settings are bench.py's: a 64-token prompt from
``default_rng(0)``, 128 new tokens, top_k 20, top_p 0.9, eos 2.

Configs:
* ``13b-int8`` (the default): ``synthetic_pair_int8_small_draft``, a
  Llama-2-13B-geometry int8 target with an independent 768-wide 2-layer
  int8 draft, gamma 24; then the acceptance sweep: the pair rebuilt at
  damp 0.008, 0.018 and 0.035 (the old pair freed first), gamma 8, 16 and
  24 at each (one untimed run, one timed), the best gamma's acc_rate and
  tok/s, and ``realistic``, the point nearest acc_rate 0.75;
* ``1.1b-int8``: bench.py's ``build_models``: a 2048-wide 16-layer target
  whose layers past the second are damped by 0.02, the draft its first two
  layers, both int8 with an int8 head; gamma 8, no sweep.

A config that does not fit raises: nothing falls back to a smaller one.
The line carries the card's name and power limit (nvidia-smi) under
``device``. It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import card_line  # noqa: E402
from llmspeculativesampling_tpu_torch.core.synthetic import (  # noqa: E402
    synthetic_pair,
    synthetic_pair_int8_small_draft,
)
from llmspeculativesampling_tpu_torch.engine.autoregressive import (  # noqa: E402
    autoregressive_generate,
)
from llmspeculativesampling_tpu_torch.engine.speculative import speculative_generate  # noqa: E402
from llmspeculativesampling_tpu_torch.quant.core import quantize_params  # noqa: E402

N_REPS = 5
GAMMA = {"13b-int8": 24, "1.1b-int8": 8}
MAX_NEW = 128
SWEEP_DAMPS = (0.008, 0.018, 0.035)
SWEEP_GAMMAS = (8, 16, 24)


def build_models(device="cuda"):
    """bench.py's 1.1B-shaped int8 pair: the target's layers from the third
    on damped by 0.02 (``wo``, ``w_down``), the draft its first two layers
    (sharing embed, final norm and head), both quantized with the head."""
    bd, pd, bt, pt = synthetic_pair("llama", hidden_size=2048, num_layers=16, draft_layers=2,
                                    num_heads=16, vocab_size=32000, max_position=2048,
                                    dtype="bfloat16", damp=0.02, seed=1, device=device)
    return (bd, quantize_params(pd, "llama", quantize_lm_head=True),
            bt, quantize_params(pt, "llama", quantize_lm_head=True))


def dispatch_rtt_ms(n: int = 8) -> float:
    """Median wall ms of one tiny CUDA launch plus the read of its result."""
    x = torch.zeros((), dtype=torch.int32, device="cuda")
    int(x + 1)
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        int(x + 1)
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls) * 1e3)


def _spread(vals):
    return {
        "n_reps": len(vals),
        "min": round(float(np.min(vals)), 2),
        "median": round(float(np.median(vals)), 2),
        "max": round(float(np.max(vals)), 2),
    }


def _gen(k: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(k)


def acceptance_sweep(ar_median, prompt, gen_kw):
    """At each damp: the pair rebuilt, each gamma run twice (the first pays
    any warm-up), the timed run of the fastest gamma reported."""
    rows = []
    for damp in SWEEP_DAMPS:
        bd, pd, bt, pt = synthetic_pair_int8_small_draft(damp=damp, device="cuda")
        best = None
        for gamma in SWEEP_GAMMAS:
            for k in (1, 2):
                _, d = speculative_generate(bd, pd, bt, pt, prompt, MAX_NEW, gamma=gamma,
                                            generator=_gen(k), **gen_kw)
            if best is None or d["tokens_per_s"] > best[1]["tokens_per_s"]:
                best = (gamma, d)
        gamma, d = best
        rows.append({
            "damp": damp,
            "acc_rate": round(d["acc_rate"], 4),
            "best_gamma": gamma,
            "tokens_per_s": round(d["tokens_per_s"], 2),
            "vs_ar": round(d["tokens_per_s"] / ar_median, 3) if ar_median else None,
        })
        del bd, pd, bt, pt
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="13b-int8", choices=sorted(GAMMA))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench: CUDA is not available; this bench runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if args.config == "13b-int8":
        bd, pd, bt, pt = synthetic_pair_int8_small_draft(device="cuda")
    else:
        bd, pd, bt, pt = build_models()
    torch.cuda.synchronize()
    gamma = GAMMA[args.config]
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    gen_kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, details=True,
                  device="cuda")

    rtt_before = dispatch_rtt_ms()
    ar_rates = []
    for k in range(1, N_REPS + 2):  # k=1 warms up, untimed
        _, d = autoregressive_generate(bt, pt, prompt, MAX_NEW, generator=_gen(k), **gen_kw)
        if k > 1:
            ar_rates.append(d["tokens_per_s"])
    ar_median = float(np.median(ar_rates))
    sp_rates, details = [], []
    for k in range(1, N_REPS + 2):
        _, d = speculative_generate(bd, pd, bt, pt, prompt, MAX_NEW, gamma=gamma,
                                    generator=_gen(k), **gen_kw)
        if k > 1:
            sp_rates.append(d["tokens_per_s"])
            details.append(d)
    sp_median = float(np.median(sp_rates))
    d_med = min(details, key=lambda d: abs(d["tokens_per_s"] - sp_median))
    del bd, pd, bt, pt
    gc.collect()
    torch.cuda.empty_cache()

    acc_sweep, realistic = [], None
    if args.config == "13b-int8":
        acc_sweep = acceptance_sweep(ar_median, prompt, gen_kw)
        realistic = min(acc_sweep, key=lambda r: abs(r["acc_rate"] - 0.75))

    print(json.dumps({
        "metric": "spec_decode_tokens_per_s",
        "value": round(sp_median, 2),
        "unit": "tok/s",
        "vs_baseline": round(sp_median / ar_median, 3),
        "ar_tokens_per_s": round(ar_median, 2),
        "spec_spread": _spread(sp_rates),
        "ar_spread": _spread(ar_rates),
        "dispatch_rtt_ms": {
            "before": round(rtt_before, 3),
            "after": round(dispatch_rtt_ms(), 3),
        },
        "acc_rate": round(d_med["acc_rate"], 4),
        "mean_acc_len": round(float(np.mean(d_med["acc_len"])), 3),
        "gamma": gamma,
        "weights": "int8",
        "config": args.config,
        "acc_sweep": acc_sweep,
        "realistic": realistic,
        "device": card_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
