"""Speculative sampling
(counterpart of ``llmspeculativesampling_tpu/engine/speculative.py``).

Draft gamma tokens with the small model, verify them with ONE target
forward over gamma+1 tokens, accept draft i iff r_i <= p_i(x_i)/q_i(x_i),
resample ``max_fn(p - q)`` at the first reject or take a bonus target
sample when all are accepted; EOS truncation and the same ``details``
schema as the JAX engine.

"Rollback" moves no data: each step re-derives both caches' lengths from
``cur_len`` (draft: cur_len-2, target: cur_len-1) and rewrites the last
positions in place (k/v of a position depend only on tokens at positions
<= it, which are final).

As in JAX, the default runs the whole generation on the device
(``engine/device_loop.py``): the state lives in static buffers (both caches
with per-row device lengths), one step (:func:`_spec_step`: draft, verify,
accept, a masked commit) is a function of tensors only, and on the card it
is captured once into a CUDA graph and replayed until the state says stop,
with no host read between steps but the pipelined stop flag.
``stepwise=True`` (or ``verbose``) runs the same step from a host loop that
synchronizes between its phases and reads the device after every step: the
counterpart of JAX's ``_spec_generate_stepwise``. Under ``tp_mesh`` the step
runs eagerly with one read a step (a gloo collective cannot be captured).

Every draw comes from the counter-based stream of ``ops/sampling.py``
(``row_keys``/``row_uniform``), seeded once from the caller's generator, so
both loops give the same tokens at the same seed. The batched phases
(:func:`draft_phase_batched`, :func:`verify_phase_batched`,
:func:`accept_phase_rows`) also serve the serving engines
(``serve/batched.py``), where B rows share one step.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from ..cache.kvcache import rollback_rows
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import (
    SamplingConfig,
    dist_concat,
    dist_map,
    dist_norm,
    dist_pad_zero_rows,
    dist_prob_of,
    dist_residual,
    dist_sample,
    dist_sample_u,
    dist_take,
    dist_width,
    row_uniform,
)
from ..utils.decoder import Decoder
from . import device_loop
from .device_loop import SpecState, finished, scalar, scatter_where_
from .phases import fill_phase_split
from .types import ModelBundle, aligned_total, first_eos_truncate, pad_prompt


def rows_window(tokens: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row window tokens[b, starts[b] : starts[b]+width] -> [B, width]
    (indices clamped into the buffer: only dead rows reach its end)."""
    idx = starts[:, None] + torch.arange(width, device=tokens.device)[None, :]
    return torch.gather(tokens, 1, idx.clamp(0, tokens.shape[1] - 1))


def sample_rows(dist, keys):
    """One draw per row from its own stream -> (ids [B], keys')."""
    u, keys = row_uniform(keys, dist_width(dist))
    return dist_sample_u(dist, u), keys


def draft_phase_batched(bundle, params, scfg, gamma, tokens, cur_len, cache, keys):
    """Batched draft over per-row lengths ``cur_len`` [B] on the device:
    every row re-feeds positions cur_len-2, cur_len-1 (the rollback is the
    per-row length reset), then gamma-1 single-token steps. Returns
    (tokens' (a new tensor, drafts written at cur_len..), cache', q_stack
    [B, gamma, ...], drafts [B, gamma], keys')."""
    cfg = bundle.cfg
    cache = rollback_rows(cache, cur_len - 2)
    logits, cache = bundle.forward(params, cfg, rows_window(tokens, cur_len - 2, 2), cache,
                                   tp_mesh=scfg.tp_mesh)
    q = dist_norm(logits[:, -1], scfg)
    x, keys = sample_rows(q, keys)
    qs, xs = [q], [x]
    for _ in range(gamma - 1):
        logits, cache = bundle.forward(params, cfg, x[:, None], cache, tp_mesh=scfg.tp_mesh)
        q = dist_norm(logits[:, 0], scfg)
        x, keys = sample_rows(q, keys)
        qs.append(q)
        xs.append(x)
    drafts = torch.stack(xs, dim=1)
    cols = cur_len[:, None] + torch.arange(gamma, device=tokens.device)[None, :]
    tokens = tokens.scatter(1, cols.clamp(0, tokens.shape[1] - 1), drafts)
    q_stack = dist_concat([dist_map(lambda a: a[:, None], d) for d in qs], axis=1)
    return tokens, cache, q_stack, drafts, keys


def verify_phase_batched(bundle, params, scfg, gamma, tokens, cur_len, cache, extra: int = 0):
    """One batched target forward over per-row windows of gamma+1+extra
    tokens -> (p_stack [B, gamma+1+extra, ...], cache'). ``extra`` (the
    paged engine's prefill_extra) lets prefilling rows push gamma+extra
    prompt tokens a step; a decode row's trailing ``extra`` positions carry
    junk whose KV lands past its accepted length (rewritten before its
    length reaches it) and whose distributions the caller drops."""
    cache = rollback_rows(cache, cur_len - 1)
    window = rows_window(tokens, cur_len - 1, gamma + 1 + extra)
    logits, cache = bundle.forward(params, bundle.cfg, window, cache, tp_mesh=scfg.tp_mesh)
    return dist_norm(logits, scfg), cache


def accept_phase(scfg, gamma, eos_token_id, tokens, cur_len, q_stack, drafts, p_stack,
                 generator, fixed_r=None):
    """Vectorized accept/resample. Returns (tokens, new_len, t, n, all_acc,
    acc_rate_step), all but ``tokens`` as device scalars; ``t`` is written
    into ``tokens`` at new_len-1 (in place). ``fixed_r`` [gamma] replaces
    the accept uniforms."""
    del scfg, eos_token_id
    dev = drafts.device
    q_sel = dist_prob_of(q_stack, drafts)
    p_sel = dist_prob_of(dist_take(p_stack, torch.arange(gamma, device=dev)), drafts)
    ratio = p_sel / q_sel
    if fixed_r is not None:
        r = torch.as_tensor(fixed_r, dtype=torch.float32, device=dev)
    else:
        r = torch.rand((gamma,), generator=generator, device=dev)
    accept = r <= ratio
    n = torch.cumprod(accept.long(), dim=0).sum()  # leading accepts, 0..gamma

    p_n = dist_take(p_stack, n)
    q_n = dist_take(dist_pad_zero_rows(q_stack, 1), n)
    t_resample = dist_sample(generator, dist_residual(p_n, q_n))
    t_bonus = dist_sample(generator, dist_take(p_stack, gamma))
    all_acc = n == gamma
    t = torch.where(all_acc, t_bonus, t_resample)

    new_len = cur_len + n + 1
    tokens[0].scatter_(0, (new_len - 1).reshape(1), t.reshape(1).to(tokens.dtype))
    acc_rate_step = torch.clamp(ratio, max=1.0).sum()
    return tokens, new_len, t, n, all_acc, acc_rate_step


def _take_rows(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x [B, R, ...] -> x[b, n[b]] [B, ...]."""
    idx = n.reshape(-1, 1, *([1] * (x.dim() - 2))).expand(x.shape[0], 1, *x.shape[2:])
    return torch.gather(x, 1, idx)[:, 0]


def accept_rows_core(gamma, q_stack, drafts, p_stack, r, u_t):
    """:func:`accept_phase` for B independent rows at once (the JAX paged
    engine vmaps ``accept_phase`` over rows), without the write.
    ``q_stack`` [B, gamma, ...], ``drafts`` [B, gamma], ``p_stack`` [B,
    gamma+1, ...]; ``r`` [B, gamma] are the accept uniforms and ``u_t`` the
    uniforms of the resample/bonus draw (one draw's width per row). Returns
    (t, n, all_acc, acc_rate_step), each [B] on the device."""
    q_sel = dist_prob_of(q_stack, drafts)
    p_sel = dist_prob_of(dist_map(lambda x: x[:, :gamma], p_stack), drafts)
    ratio = p_sel / q_sel
    accept = r <= ratio
    n = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # leading accepts, 0..gamma

    p_n = dist_map(lambda x: _take_rows(x, n), p_stack)
    q_n = dist_map(lambda x: _take_rows(x, n), dist_pad_zero_rows(q_stack, 1, axis=1))
    t_resample = dist_sample_u(dist_residual(p_n, q_n), u_t)
    t_bonus = dist_sample_u(dist_map(lambda x: x[:, gamma], p_stack), u_t)
    all_acc = n == gamma
    t = torch.where(all_acc, t_bonus, t_resample)
    return t, n, all_acc, torch.clamp(ratio, max=1.0).sum(dim=1)


def accept_phase_rows(gamma, tokens, cur_len, q_stack, drafts, p_stack, r, u_t):
    """:func:`accept_rows_core`, then each row's token ``t`` written into
    ``tokens`` [B, T] at new_len-1 (in place, clamped into the buffer), for
    per-row ``cur_len`` [B]. Returns (tokens, new_len, t, n, all_acc,
    acc_rate_step), each but ``tokens`` [B] on the device."""
    t, n, all_acc, acc_rate_step = accept_rows_core(gamma, q_stack, drafts, p_stack, r, u_t)
    new_len = cur_len + n + 1
    col = (new_len - 1).clamp(0, tokens.shape[1] - 1)
    tokens.scatter_(1, col[:, None], t[:, None].to(tokens.dtype))
    return tokens, new_len, t, n, all_acc, acc_rate_step


def _spec_state(bundle_d, bundle_t, gamma: int, max_total: int, max_new: int, fixed: bool,
                device) -> SpecState:
    """A zeroed :class:`SpecState` of ``max_total`` positions."""
    i32 = torch.int32

    def cache(bundle):
        return rollback_rows(bundle.make_cache(1, max_total, device=device), [0])

    return SpecState(
        tokens=torch.zeros((1, max_total), dtype=torch.long, device=device),
        cur_len=scalar(0, i32, device), total=scalar(0, i32, device),
        draft_cache=cache(bundle_d), target_cache=cache(bundle_t),
        key=torch.zeros((1, 2), dtype=torch.long, device=device),
        fixed_r=torch.zeros((1, gamma), dtype=torch.float32, device=device) if fixed else None,
        done=scalar(False, torch.bool, device), accepted=scalar(0, i32, device),
        resamples=scalar(0, i32, device), bonus=scalar(0, i32, device),
        steps=scalar(0, i32, device), acc_rate_sum=scalar(0.0, torch.float32, device),
        acc_len_hist=torch.zeros((max(max_new, 1),), dtype=i32, device=device),
        stop=scalar(False, torch.bool, device),
    )


def _spec_start(bundle_d, params_d, bundle_t, params_t, prompt_t, p_len: int, total: int, key,
                fixed_r, tp_mesh, st: SpecState) -> None:
    """Reset ``st`` and prefill the padded prompt ``prompt_t`` [1, P] into
    both of its caches (eager: the bucket varies)."""
    st.tokens.zero_()
    st.tokens[:, :prompt_t.shape[1]] = prompt_t
    for bundle, params, cache in ((bundle_d, params_d, st.draft_cache),
                                  (bundle_t, params_t, st.target_cache)):
        cache.lengths.zero_()
        bundle.forward(params, bundle.cfg, prompt_t, cache, tp_mesh=tp_mesh)
    st.cur_len.fill_(p_len)
    st.total.fill_(total)
    st.key.copy_(key)
    if fixed_r is not None:
        st.fixed_r.copy_(fixed_r)
    for t in (st.done, st.accepted, st.resamples, st.bonus, st.steps, st.acc_rate_sum,
              st.acc_len_hist):
        t.zero_()
    st.stop.copy_(finished(st))


def _spec_step(bundle_d, params_d, bundle_t, params_t, scfg, gamma: int, eos_token_id: int,
               st: SpecState, mark=None) -> None:
    """One speculative step on ``st``, in place (JAX ``_spec_step``). The
    windows sit at ``cw = min(cur_len, total - 1)``, which is cur_len on a
    live state; a finished state (done, or cur_len at its budget) commits
    nothing, so the caller's tokens, length, counters and histogram keep
    their bits, while its forwards stay at the positions a live last step
    reaches (inside the buffers and an OPT position table). ``mark()``, if
    given, is called after the draft and after the verify (the stepwise
    loop's timers)."""
    cur = st.cur_len.long()
    active = ~st.done & (cur < st.total)
    cw = torch.minimum(cur, st.total.long() - 1).reshape(1)
    tokens, draft_cache, q_stack, drafts, key = draft_phase_batched(
        bundle_d, params_d, scfg, gamma, st.tokens, cw, st.draft_cache, st.key)
    if mark is not None:
        mark()
    p_stack, target_cache = verify_phase_batched(
        bundle_t, params_t, scfg, gamma, tokens, cw, st.target_cache)
    if mark is not None:
        mark()
    r = st.fixed_r
    if r is None:
        r, key = row_uniform(key, gamma)
    u_t, key = row_uniform(key, dist_width(p_stack))
    t, n, all_acc, acc_step = accept_rows_core(gamma, q_stack, drafts, p_stack, r, u_t)

    # commit the accepted drafts and t at [cw, cw + n]; EOS among them ends it
    n0 = n[0]
    j = torch.arange(gamma + 1, device=cw.device)
    window = torch.where(j < n0, torch.cat([drafts[0], t]), t)
    write = active & (j <= n0)
    scatter_where_(st.tokens[0], cw + j, window, write)
    eos_now = (write & (window == eos_token_id)).any()
    col = st.steps.long().clamp(max=st.acc_len_hist.shape[0] - 1).reshape(1)
    scatter_where_(st.acc_len_hist, col, n, active)
    st.cur_len.copy_(torch.where(active, cw[0] + n0 + 1, cur))
    st.done.copy_(st.done | (active & eos_now))
    st.accepted.add_(torch.where(active, n0, torch.zeros_like(n0)).to(torch.int32))
    st.resamples.add_((active & ~all_acc[0]).to(torch.int32))
    st.bonus.add_((active & all_acc[0]).to(torch.int32))
    st.steps.add_(active.to(torch.int32))
    st.acc_rate_sum.copy_(torch.where(active, st.acc_rate_sum + acc_step[0], st.acc_rate_sum))
    st.key.copy_(torch.where(active, key, st.key))
    st.draft_cache.lengths.copy_(draft_cache.lengths)
    st.target_cache.lengths.copy_(target_cache.lengths)
    st.stop.copy_(finished(st))


def _spec_stepwise(st: SpecState, step, device, gamma: int, p_len: int, verbose: bool):
    """The host loop over ``step`` (JAX ``_spec_generate_stepwise``): a
    synchronize after each phase times it, and the device is read after
    every step (the new length, stop, the committed window). Returns
    (approx_time, target_time)."""
    marks = []

    def mark():
        synchronize(device)
        marks.append(time.perf_counter())

    approx_t = target_t = 0.0
    cur = p_len
    stop = bool(st.stop)
    with torch.no_grad():
        while not stop:
            marks.clear()
            ta = time.perf_counter()
            step(st, mark=mark)
            approx_t += marks[0] - ta
            target_t += marks[1] - marks[0]
            host = torch.cat([st.cur_len.reshape(1).long(), st.stop.reshape(1).long(),
                              st.tokens[0, cur:cur + gamma + 1]]).tolist()
            n_acc = host[0] - cur - 1
            if verbose:
                _print_step(host[2:n_acc + 3], n_acc, gamma, cur + n_acc)
            cur, stop = host[0], bool(host[1])
    return approx_t, target_t


def speculative_generate(
    bundle_d: ModelBundle,
    params_d,
    bundle_t: ModelBundle,
    params_t,
    prompt,
    max_new_tokens: int,
    *,
    gamma: int = 4,
    eos_token_id: int,
    pad_token_id: Optional[int] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    random_seed: Optional[int] = None,
    details: bool = False,
    stepwise: bool = False,
    verbose: bool = False,
    tp_mesh=None,
    device=None,
):
    """Speculative sampling with KV rollback. Returns numpy int32 [T]
    (prompt included, cut after the first generated EOS); with
    ``details=True`` also the reference-schema dict.

    The generation runs in the device loop (a replayed CUDA graph on the
    card; see the module docstring). ``stepwise=True`` runs the host loop
    instead, timing each phase with a device synchronize for the measured
    approx/target/other split; otherwise the split is calibrated
    (engine/phases.py). ``verbose`` prints the per-token stream and implies
    ``stepwise``. ``generator`` seeds the generation's random stream (one
    32-bit draw). ``random_seed`` reuses one fixed uniform for every accept
    test (the reference's reseed-before-every-draw quirk).

    Params sharded over a tensor-parallel mesh (``parallel/sharding.py``)
    run on every rank of it, each with a generator made from the same
    seed; ``tp_mesh`` (that mesh) samples from vocab-sharded logits
    (``ops/sampling.py::norm_logits_topk_tp``) instead of gathered ones,
    with the same result, and runs the step eagerly."""
    del pad_token_id
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle_d, bundle_t = bundle_d.for_params(params_d), bundle_t.for_params(params_t)
    pd, pt = unstack_layers(params_d), unstack_layers(params_t)
    prompt_padded, p_len = pad_prompt(prompt)
    if p_len < 2:
        raise ValueError("prompt must have at least 2 tokens")
    p_bucket = prompt_padded.shape[1]
    max_total = aligned_total(p_bucket + max_new_tokens + gamma + 1)
    total = p_len + max_new_tokens
    for bundle in (bundle_d, bundle_t):
        device_loop.check_positions(bundle, max(p_bucket, total + gamma - 1))
    stepwise = stepwise or verbose
    fixed_r = None
    if random_seed is not None:
        g0 = torch.Generator().manual_seed(int(random_seed))
        fixed_r = torch.rand((), generator=g0).expand(1, gamma)
    key = device_loop.stream_key(gen, dev)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)
    build = functools.partial(_spec_state, bundle_d, bundle_t, gamma, max_total, max_new_tokens,
                              fixed_r is not None, dev)
    start = functools.partial(_spec_start, bundle_d, pd, bundle_t, pt, prompt_t, p_len, total, key,
                              fixed_r, tp_mesh)
    step = functools.partial(_spec_step, bundle_d, pd, bundle_t, pt, scfg, gamma, eos_token_id)

    synchronize(dev)
    t0 = time.perf_counter()
    approx_t = target_t = 0.0
    if stepwise:
        st = build()
        with torch.no_grad():
            start(st)
        approx_t, target_t = _spec_stepwise(st, step, dev, gamma, p_len, verbose)
    else:
        st = device_loop.run(
            ("spec", bundle_d, bundle_t, gamma, max_total, max_new_tokens, scfg, eos_token_id,
             fixed_r is not None),
            (params_d, params_t), build, start, step, max_new_tokens,
            replay=dev.type == "cuda" and tp_mesh is None)
    out_tokens = st.tokens.cpu().numpy()
    cur_len, steps, accepted, resamples, bonus = torch.stack(
        [st.cur_len, st.steps, st.accepted, st.resamples, st.bonus]).tolist()
    acc_len = st.acc_len_hist[:steps].tolist()
    acc_rate_total = float(st.acc_rate_sum)
    wall = time.perf_counter() - t0
    drafted = steps * gamma
    if verbose:
        print(f"generated tokens numbers {cur_len - p_len}, accepted_count {accepted}")
        print(f"Acc rate: {acc_rate_total / max(drafted, 1)}")
        print("approx model time", approx_t)
        print("target model time", target_t)
        print("other time", wall - approx_t - target_t)
        print("acc len", float(np.mean(acc_len)) if acc_len else 0.0, len(acc_len), acc_len)

    out = first_eos_truncate(out_tokens, p_len, cur_len, eos_token_id).astype("int32")
    if not details:
        return out
    n_gen = len(out) - p_len
    if stepwise:
        return out, {
            "total_time": wall,
            "approx_time": approx_t,
            "target_time": target_t,
            "other_time": wall - approx_t - target_t,
            "target_model_time": target_t,
            "target_pre_cache_time": 0.0,
            "target_post_prob_time": 0.0,
            "phase_split_method": "measured",
            "acc_len": acc_len,
            "acc_rate": acc_rate_total / max(drafted, 1),
            "target_call_times": steps,
            "approx_call_times": steps,
            "tokens_generated": n_gen,
            "tokens_per_s": n_gen / wall if wall > 0 else float("nan"),
        }
    d = {
        "total_time": wall,
        "acc_len": acc_len,
        "acc_rate": acc_rate_total / max(drafted, 1),
        "target_call_times": steps,
        "approx_call_times": steps,
        "accepted_count": accepted,
        "resample_count": resamples,
        "target_sample_count": bonus,
        "tokens_generated": n_gen,
        "tokens_per_s": n_gen / wall if wall > 0 else float("nan"),
    }
    fill_phase_split(
        d, wall, steps, bundle_d, pd, bundle_t, pt,
        draft_rows=1, verify_rows=1, gamma=gamma, verify_tokens=gamma + 1,
        max_total=max_total, device=dev,
    )
    return out, d


def _decode_one(tok: int) -> str:
    """A token's text through the ``Decoder`` singleton when a tokenizer is
    attached, else its id."""
    d = Decoder()
    if d.tokenizer is None:
        return str(tok)
    return d.decode([int(tok)])


def _print_step(window, n_acc, gamma, pos):
    """Reference per-token stream: accepted guesses red, reject-resample
    blue, bonus sample magenta."""
    for j in window[:n_acc]:
        print(f"approx guess accepted {int(j)}: \033[31m{_decode_one(j)}\033[0m")
    t_tok = int(window[n_acc])
    if n_acc == gamma:
        print(f"target samples {pos}: \033[35m{_decode_one(t_tok)}\033[0m")
    else:
        print(f"target resamples at position {pos}: \033[34m{_decode_one(t_tok)}\033[0m")
