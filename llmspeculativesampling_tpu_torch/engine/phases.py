"""Calibrated phase-time split
(counterpart of ``llmspeculativesampling_tpu/engine/phases.py``).

The non-stepwise engines fill the reference's
``approx_time``/``target_time``/``other_time`` keys from a one-time
calibration at the engine's exact shapes: the gamma-step draft loop (or,
for the cache-less v2 engine, gamma full-buffer forwards) and one verify
forward, each timed warm (best of 3) and cached per configuration, then
multiplied by the step count. Times end in ``torch.cuda.synchronize()``
on the card; on the CPU they are plain wall time.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from ..core.config import synchronize
from ..models.llama import unstack_layers

# (bundles, shapes, device) -> (t_draft_phase, t_verify_forward) seconds
_CAL: Dict[tuple, Tuple[float, float]] = {}


def _best_of(fn, device, reps: int = 3) -> float:
    fn()
    synchronize(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _prefill_sim(bundle, params, rows, max_total, device):
    cache = bundle.make_cache(rows, max_total, device=device)
    toks = torch.ones((rows, 8), dtype=torch.long, device=device)
    _, cache = bundle.forward(params, bundle.cfg, toks, cache)
    return cache


def _draft_loop(bundle, params, cache, gamma, device):
    """gamma sequential single-token forwards: the draft phase's shape."""
    tok = torch.ones((cache.batch, 1), dtype=torch.long, device=device)
    for _ in range(gamma):
        logits, cache = bundle.forward(params, bundle.cfg, tok, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    return tok


def _verify_forward(bundle, params, cache, tokens, device):
    toks = torch.ones((cache.batch, tokens), dtype=torch.long, device=device)
    logits, _ = bundle.forward(params, bundle.cfg, toks, cache)
    return logits[:, -1].sum()


def calibrate_phase_times(
    bundle_d, params_d, bundle_t, params_t, *,
    draft_rows: int, verify_rows: int, gamma: int, verify_tokens: int,
    max_total: int, device, draft_mode: str = "loop",
) -> Tuple[float, float]:
    """(t_draft_phase, t_verify_forward) in seconds, warm, cached per
    configuration.

    ``draft_mode='loop'``: gamma sequential cached single-token forwards
    (every cached engine). ``draft_mode='full'``: gamma full-buffer
    forwards, the cache-less v2 engine's draft shape; its verify is then
    one full-buffer forward too."""
    device = torch.device(device)
    ck = (bundle_d, bundle_t, draft_rows, verify_rows, gamma, verify_tokens, max_total,
          str(device), draft_mode)
    hit = _CAL.get(ck)
    if hit is not None:
        return hit
    params_d, params_t = unstack_layers(params_d), unstack_layers(params_t)
    dc = _prefill_sim(bundle_d, params_d, draft_rows, max_total, device)
    tc = _prefill_sim(bundle_t, params_t, verify_rows, max_total, device)
    if draft_mode == "full":
        full = max_total - 8  # the prefill sim already holds 8 positions
        t_draft = gamma * _best_of(lambda: _verify_forward(bundle_d, params_d, dc, full, device),
                                   device)
        t_verify = _best_of(lambda: _verify_forward(bundle_t, params_t, tc, full, device), device)
    else:
        t_draft = _best_of(lambda: _draft_loop(bundle_d, params_d, dc, gamma, device), device)
        t_verify = _best_of(lambda: _verify_forward(bundle_t, params_t, tc, verify_tokens, device),
                            device)
    _CAL[ck] = (t_draft, t_verify)
    return _CAL[ck]


def fill_phase_split(
    d: dict, wall: float, steps: int,
    bundle_d, params_d, bundle_t, params_t, *,
    draft_rows: int, verify_rows: int, gamma: int, verify_tokens: int,
    max_total: int, device, draft_mode: str = "loop",
) -> dict:
    """Fill the phase keys into ``d`` from the calibrated per-dispatch
    times x ``steps`` (rescaled into ``wall`` when they exceed it)."""
    t_draft, t_verify = calibrate_phase_times(
        bundle_d, params_d, bundle_t, params_t,
        draft_rows=draft_rows, verify_rows=verify_rows, gamma=gamma,
        verify_tokens=verify_tokens, max_total=max_total, device=device,
        draft_mode=draft_mode,
    )
    approx = steps * t_draft
    target = steps * t_verify
    used = approx + target
    if used > wall > 0:
        approx *= wall / used
        target *= wall / used
    d["approx_time"] = approx
    d["target_time"] = target
    d["other_time"] = max(wall - approx - target, 0.0)
    d["target_model_time"] = target
    d["target_pre_cache_time"] = 0.0
    d["target_post_prob_time"] = 0.0
    d["phase_split_method"] = "calibrated"
    return d
