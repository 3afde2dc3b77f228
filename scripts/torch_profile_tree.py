#!/usr/bin/env python3
"""Where the time goes on the port's tree/beam path, on one GPU.

    python3 scripts/torch_profile_tree.py

Builds the 13B-shaped int8 target and the 768-wide int8 draft on the card
(seed 0) and, with chip_smoke.py's tree/beam settings (scripts/bench_beam.py
--thirteen_b: 64-token prompt, 64 new tokens, gamma 4, 4 beams or
candidates, top_k 20, top_p 0.9), prints:

* for one forward of each kind at a 96-position prefix (a mid-run length):
  the target tree verify of beam v2 (1 row x 17 tokens under an ancestor
  mask) and of beam v1 (4 rows x 17), multi's target verify (4 rows x 5
  tokens) and the beam draft step (4 rows x 1 token): host ms per forward,
  device-busy ms split by kernel (B1, B2, other) and the kernel count, as
  scripts/torch_profile_main_path.py measures them;
* the same for the remaining algorithms' forwards: BiLD's check window (1
  row x 11 tokens), random beam's decode (4 rows x 1) and the cache-less
  v2's whole-prefix forwards (target 1 x 100, draft 1 x 97, from an empty
  cache);
* for one whole generation of multi iid, beam v1, beam v2 and of the
  remaining algorithms (multi's beam strategy at width 4, MJSD at width =
  num_beams = 4, BiLD at gamma 10 / fallback 0.6 / rollback 5.0, v2, random
  beam at 4 beams): tok/s on the host clock (untraced, after a warm-up
  run), the device-busy time of a traced run of the same seed, and the
  device's idle share 1 - busy/wall.

All host-clock numbers are taken before the first trace. Every line carries
the card's name and power limit. It imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
from chip_smoke import card_line  # noqa: E402
from torch_profile_main_path import host_ms, log, traced  # noqa: E402

S_MAX, PREFIX, GAMMA, BEAMS, NEW = 256, 96, 4, 4, 64


def forward_setup(bundle, params, rows, s_new, tree):
    """A forward of ``rows`` x ``s_new`` tokens at a PREFIX-position cache
    (``tree``: positions and the ancestor mask of random parents, as
    ``tree_verify`` passes them), as a closure that rewrites the same
    positions each call."""
    from llmspeculativesampling_tpu_torch.cache.kvcache import rollback
    from llmspeculativesampling_tpu_torch.engine.beam_tree import ancestor_matrix

    gen = torch.Generator(device="cuda").manual_seed(7)
    cache = bundle.make_cache(rows, S_MAX, device="cuda")
    prompt = torch.randint(100, 31000, (rows, PREFIX), generator=gen, device="cuda")
    _, cache = bundle.forward(params, bundle.cfg, prompt, cache)
    cache = rollback(cache, PREFIX)
    step = torch.randint(100, 31000, (rows, s_new), generator=gen, device="cuda")
    kw = {}
    if tree:
        n = s_new - 1
        parents = torch.randint(0, BEAMS, (GAMMA, BEAMS), generator=gen, device="cuda")
        block = torch.zeros((s_new, s_new), dtype=torch.bool, device="cuda")
        block[:, 0] = True
        block[1:, 1:] = ancestor_matrix(parents, GAMMA, BEAMS)
        level = torch.arange(GAMMA, device="cuda").repeat_interleave(BEAMS)
        pos = torch.cat([torch.full((1,), PREFIX, device="cuda"), PREFIX + 1 + level])
        kw = dict(positions=pos[None].expand(rows, n + 1),
                  tree_mask=block[None].expand(rows, s_new, s_new))
    return lambda: bundle.forward(params, bundle.cfg, step, cache, **kw)


def prefix_setup(bundle, params, n):
    """v2's forward: ``n`` tokens from an empty cache, through the engine's
    own helper."""
    from llmspeculativesampling_tpu_torch.engine.speculative_v2 import prefix_logits

    gen = torch.Generator(device="cuda").manual_seed(8)
    tokens = torch.randint(100, 31000, (1, S_MAX), generator=gen, device="cuda")
    cache = bundle.make_cache(1, S_MAX, device="cuda")
    return lambda: prefix_logits(bundle, params, tokens, n, cache)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_tree: CUDA is not available", file=sys.stderr)
        return 1
    from llmspeculativesampling_tpu_torch import (
        bild_generate, mjsd_generate, random_width_beam_generate, speculative_generate_v2)
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8_small_draft
    from llmspeculativesampling_tpu_torch.engine.beam_tree import (
        beam_speculative_generate, beam_speculative_v2_generate)
    from llmspeculativesampling_tpu_torch.engine.multi import multi_speculative_generate
    from llmspeculativesampling_tpu_torch.models.llama import unstack_layers

    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    bd, pd, bt, pt = synthetic_pair_int8_small_draft(device="cuda")
    pd, pt = unstack_layers(pd), unstack_layers(pt)
    tokens = GAMMA * BEAMS + 1
    forwards = {
        "v2_tree_verify_1x17": forward_setup(bt, pt, 1, tokens, True),
        "v1_tree_verify_4x17": forward_setup(bt, pt, BEAMS, tokens, True),
        "multi_verify_4x5": forward_setup(bt, pt, BEAMS, GAMMA + 1, False),
        "beam_draft_4x1": forward_setup(bd, pd, BEAMS, 1, False),
        "bild_check_1x11": forward_setup(bt, pt, 1, 11, False),
        "random_beam_decode_4x1": forward_setup(bt, pt, BEAMS, 1, False),
        "v2_target_prefix_1x100": prefix_setup(bt, pt, PREFIX + GAMMA),
        "v2_draft_prefix_1x97": prefix_setup(bd, pd, PREFIX + 1),
    }
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, device="cuda", details=True)

    def gen():
        return torch.Generator(device="cuda").manual_seed(1)

    engines = {
        "multi": lambda: multi_speculative_generate(bd, pd, bt, pt, prompt, NEW, gamma=GAMMA,
                                                    width=BEAMS, generator=gen(), **kw),
        "beam_v1": lambda: beam_speculative_generate(bd, pd, bt, pt, prompt, NEW, gamma=GAMMA,
                                                     num_beams=BEAMS, generator=gen(), **kw),
        "beam_v2": lambda: beam_speculative_v2_generate(
            bd, pd, bt, pt, prompt, NEW, gamma=GAMMA, num_beams=BEAMS, extra_sample_cnt=1,
            expect_thres=0.7, generator=gen(), **kw),
        "multi_beam": lambda: multi_speculative_generate(
            bd, pd, bt, pt, prompt, NEW, gamma=GAMMA, width=BEAMS, strategy="beam",
            generator=gen(), **kw),
        "mjsd": lambda: mjsd_generate(bd, pd, bt, pt, prompt, NEW, gamma=GAMMA, width=BEAMS,
                                      num_beams=BEAMS, accept_thres=0.1, generator=gen(), **kw),
        "bild": lambda: bild_generate(bd, pd, bt, pt, prompt, NEW, gamma=10, fallback_thres=0.6,
                                      rollback_thres=5.0, generator=gen(), **kw),
        "spec_v2": lambda: speculative_generate_v2(bd, pd, bt, pt, prompt, NEW, gamma=GAMMA,
                                                   generator=gen(), **kw),
        "random_beam": lambda: random_width_beam_generate(bt, pt, prompt, NEW,
                                                          max_num_beams=BEAMS, generator=gen(),
                                                          **kw),
    }
    # host-clock numbers first: a trace slows later launches
    out = {"card": card, "forward": {}, "generate": {}}
    for name, run in forwards.items():
        out["forward"][name] = {"host_ms": host_ms(run)}
    for name, run in engines.items():
        run()  # warm-up (allocator, phase calibration)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, d = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["generate"][name] = {"tokens": d["tokens_generated"], "wall_ms": wall * 1e3,
                                 "tok_s": d["tokens_generated"] / wall,
                                 "steps": d["target_call_times"],
                                 "mean_acc_len": (float(np.mean(d["acc_len"])) if d.get("acc_len")
                                                  else float("nan"))}

    for name, run in forwards.items():
        r = out["forward"][name]
        busy, kinds, n, _ = traced(run)
        r.update(device_busy_ms=busy, kernels=n, by_kind=kinds)
        log(f"[forward] {name} (prefix {PREFIX}): host_ms {r['host_ms']:.3f} device_busy_ms "
            f"{busy:.3f} ({', '.join(f'{k} {v:.3f}' for k, v in sorted(kinds.items()))}) "
            f"kernels {n} ({card})")
    for name, run in engines.items():
        r = out["generate"][name]
        busy, kinds, n, names = traced(run)
        r.update(device_busy_ms=busy, idle_share=1 - busy / r["wall_ms"], kernels=n, by_kind=kinds)
        log(f"[generate] {name}: {r['tokens']} tokens in {r['wall_ms']:.1f} ms = "
            f"{r['tok_s']:.2f} tok/s, {r['steps']} steps (mean acc_len {r['mean_acc_len']:.3f}), "
            f"host ms per step {r['wall_ms'] / r['steps']:.1f}; device_busy_ms {busy:.1f} "
            f"({', '.join(f'{k} {v:.1f}' for k, v in sorted(kinds.items()))}), idle share "
            f"{r['idle_share']:.3f}, kernels {n} ({card})")
        for kname, ms in sorted(names.items(), key=lambda kv: -kv[1])[:5]:
            log(f"[generate]   {ms:9.2f} ms  {kname[:110]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
