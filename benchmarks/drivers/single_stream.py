"""Driver ``single_stream``: one request at a time, back to back, through the
port's ``speculative_generate`` in its device loop (a replayed CUDA graph
a step).

Set-up builds the pair on the card and runs one generation for every prompt
bucket and decoding mode (sampled, greedy) of the mix, so every step the
window replays is captured before it opens. The window starts requests
until ``seconds`` have passed and ends when the last of them finishes:
``decode_tok_s`` is their new tokens over that time. A traced run traces
whole requests from the window's start until ``trace_seconds`` have passed;
the counts for the metric readers cover those requests.
"""

from __future__ import annotations

import gc
import time
from collections import Counter

import numpy as np
import torch

from llmspeculativesampling_tpu_torch import speculative_generate
from llmspeculativesampling_tpu_torch.engine import device_loop

from .. import families, traffic
from .common import (
    ROLES,
    Answer,
    AttentionTally,
    Outcome,
    log,
    memory_peak,
    step_starts,
    sync,
    tally_steps,
    w8a16_counts,
)


def _generate(b, pair, eng: dict, prompt, greedy: bool, seed: int, device):
    sampling = (dict(temperature=1.0, top_k=1, top_p=0.0) if greedy else
                dict(temperature=eng["temperature"], top_k=eng["top_k"], top_p=eng["top_p"]))
    return speculative_generate(
        b["draft"], pair["draft"], b["target"], pair["target"], prompt, eng["max_new_tokens"],
        gamma=eng["gamma"], eos_token_id=eng["eos_token_id"],
        generator=torch.Generator(device=device).manual_seed(seed), details=True,
        device=device, **sampling)


def _warm_up(b, pair, eng, mix, device) -> None:
    """One generation for each (prompt bucket, mode) the mix uses."""
    seen = set()
    for req in traffic.first_block(mix, 0):
        key = (traffic.bucket_of(len(req.prompt)), req.greedy)
        if key not in seen:
            seen.add(key)
            _generate(b, pair, eng, req.prompt, req.greedy, 0, device)
    sync(device)


def _counts(records: list, wall: float, gamma: int) -> dict:
    """The metric readers' counts over ``records`` (requests) in ``wall``
    seconds."""
    w8 = w8a16_counts()
    attn = {role: AttentionTally() for role in ROLES}
    needed = Counter()
    steps = new = 0
    for r in records:
        # the prompt's forward, then each step's gamma draft forwards (a
        # re-feed of two tokens, then single ones) and one target forward
        for role in ROLES:
            w8[role]["exact"][r["p_len"]] += 1
            needed[role] += r["p_len"] + r["steps"] * (gamma + 1)
        w8["draft"]["exact"][2] += r["steps"]
        w8["draft"]["exact"][1] += r["steps"] * (gamma - 1)
        w8["target"]["exact"][gamma + 1] += r["steps"]
        tally_steps(attn, step_starts(r["p_len"], r["acc_len"]), gamma)
        steps += r["steps"]
        new += r["new"]
    return {
        "segment_s": wall, "requests": len(records), "steps": steps, "new_tokens": new,
        "w8a16": {role: {"exact": dict(v["exact"]), "pooled": v["pooled"]}
                  for role, v in w8.items()},
        "attention": {role: vars(t) for role, t in attn.items()},
        "attention_family": "b2", "kv_dtype": "bfloat16",
        "needed_tokens": dict(needed),
    }


def run(cell, tracer, spans) -> Outcome:
    device, w, eng = cell.device, cell.workload, cell.workload["engine"]
    mix = w["traffic"]
    t = time.perf_counter()
    fam = families.family(cell.config, cell.base)
    pair = fam.build(cell.config, cell.seed, device)
    sync(device)
    log(f"weights {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    b = fam.bundles(pair, kv_quant=False)
    _warm_up(b, pair, eng, mix, device)
    tracer.warm()
    log(f"warm-up {time.perf_counter() - t:.3f} s")

    gen = traffic.requests(mix, cell.seed)
    sampled = {k: eng[k] for k in ("temperature", "top_k", "top_p")}
    records, answers, failed, error = [], [], 0, None
    traced = None
    tracer.start()
    t0 = time.perf_counter()
    while True:
        req = next(gen)
        try:
            with spans.span("speculative_generate"):
                out, d = _generate(b, pair, eng, req.prompt, req.greedy, req.seed, device)
        except RuntimeError as e:  # the program failed the request
            failed, error = 1, f"request {req.index}: {e}"
            break
        p_len = len(req.prompt)
        records.append({"p_len": p_len, "new": len(out) - p_len, "steps": d["target_call_times"],
                        "acc_len": d["acc_len"]})
        answers.append(Answer(req.prompt, np.asarray(out[p_len:], np.int64),
                              None if req.greedy else sampled))
        now = time.perf_counter()
        if traced is None and cell.trace and now - t0 >= w["trace_seconds"]:
            traced = _counts(records, now - t0, eng["gamma"])
            tracer.stop()
        if now - t0 >= cell.seconds:
            break
    t1 = time.perf_counter()
    if traced is None and cell.trace:
        traced = _counts(records, t1 - t0, eng["gamma"])
        tracer.stop()
    peak = memory_peak(device)
    device_loop.release_graphs()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    new = sum(r["new"] for r in records)
    return Outcome(
        window_start=t0,
        end_to_end={"decode_tok_s": new / (t1 - t0)},
        counts=traced or _counts(records, t1 - t0, eng["gamma"]),
        answers=answers, attempted=len(records) + failed, failed=failed,
        memory_peak_bytes=peak, pair=pair, error=error)
